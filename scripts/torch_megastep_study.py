#!/usr/bin/env python3
"""Studies of the port's CUDA megastep kernel on one NVIDIA GPU: where a
census's time goes, and an earlier design against this one.

    PYTHONPATH=src python scripts/torch_megastep_study.py split [--source FILE]
    PYTHONPATH=src python scripts/torch_megastep_study.py compare --parent FILE

* ``split``: the census (``chip_smoke.py``'s 500 lanes) through the
  kernel built from ``--source`` (default: the package's
  ``csrc/megastep.cu``; any copy with the same C interface), with
  emulation on (K3, the default config), off (K1) and traced (K2), each
  timed as ``chip_smoke.kernel_census_ms`` times it, in these
  arrangements:

  (a) the lanes in census order at ``chip_smoke.py``'s block;
  (b) the same at blocks of 1, 2, 4, 8 and 16 lanes;
  (c) the lanes permuted so that every warp of 32 holds lanes of one
      image only (each image's lanes padded to a multiple of 32 with
      halted lanes, which do nothing); the result, un-permuted, must
      equal (a)'s;
  (d) the longest lane alone (B = 1), timed, and run once more through
      a copy of the source with ``clock64`` stamps (built here, not kept):
      cycles a step, split into fetch and decode (to the register reads),
      the rest of an ALU or memory step, and svc steps by kind (stream
      I/O with its bulk loop, the guest-kernel service with its free-slot
      scans and data mover, the others).

  Then the wrapper's host cost: a launch with its arguments built anew
  (what every chunk paid before the drivers built them once) and a
  launch of prebuilt arguments, and the run driver both ways
  (``ops.run``'s loop, one host sync a chunk).
* ``compare``: the census through ``--parent`` (an earlier design, built
  from a copy of its source) and through the package's kernel, in turns
  (parent, new, new, parent), K1, K3 and K2, the parent at 32 lanes a
  block (one thread a lane), this one at its default; both results must
  be equal.

Each prints JSON lines, then the card line.  Both need a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core import (  # noqa: E402
    HookConfig, fleet, pack_fleet, run_fleet_prepared)
from repro_torch.core.machine import MachineState  # noqa: E402
from repro_torch.core.runtime import fleet_trace  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.megastep import kernel as mk  # noqa: E402

PARENT_BLOCK = 32  # the one-thread-a-lane design's lanes a block
CONFIGS = {"K3": (HookConfig(), False),
           "K1": (HookConfig(emul_enabled=False), False),
           "K2": (HookConfig(), True)}


def smoke():
    """chip_smoke.py as a module (its census and helpers)."""
    import chip_smoke
    return chip_smoke


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load(source, *, tag: str = "") -> ctypes.CDLL:
    """The kernel library built from ``source`` (a path, or source text
    with ``tag``: a copy with the package's C interface, built apart)."""
    if tag:
        d = Path(tempfile.mkdtemp(prefix=f"megastep_{tag}_"))
        copy = d / "megastep.cu"
        copy.write_text(source.read_text() if isinstance(source, Path)
                        else source)
        source = copy
    return mk.load_library(Path(source))


def sass_instructions(source: Path) -> int:
    """Instructions in the kernel's SASS (``cuobjdump -sass``)."""
    lib, _ = mk.build(source)
    cuobjdump = Path(nvcc.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return sum(1 for ln in out.splitlines()
               if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln))


# Edits of the package's source: each tests what a part costs or what an
# other form of it gains (only the time counts; a form worth keeping is
# then made in the source and checked against the plain version).
_ALU_SWITCH = ("            int64_t slot_val = 0;\n            switch (aluc) {",
               "                default: break;\n            }\n")
_ALU_SELECTS = """            // the class switch as selects: one add or subtract on chosen
            // operands serves eight classes
            int64_t mv = aluc == A_MOVN ? ~piece : piece;
            if (aluc == A_MOVK)
                mv = (int64_t)(((uint64_t)rd_rr & ~((uint64_t)0xFFFF << sh))
                               | (uint64_t)piece);
            if (sf != 1) mv &= (int64_t)0xFFFFFFFF;
            const int64_t lhs = (aluc == A_ADD_I || aluc == A_SUB_I) ? rn_rsp
                : (aluc == A_ADR || aluc == A_LINK) ? pc0
                : aluc == A_ADRP ? (pc0 & ~(int64_t)0xFFF)
                : aluc == A_MADD ? wmul(rn_rr, rm_rr) : rn_rr;
            const int64_t rhs = (aluc == A_ADD_R || aluc == A_SUB_R) ? rm_rr
                : aluc == A_LINK ? 4 : aluc == A_MADD ? ra_rr : imm;
            const int64_t arith = (aluc == A_SUB_I || aluc == A_SUB_R)
                ? wsub(lhs, rhs) : wadd(lhs, rhs);
            const int64_t logic = aluc == A_ORR ? (rn_rr | rm_rr)
                : aluc == A_AND ? (rn_rr & rm_rr) : (rn_rr ^ rm_rr);
            int64_t slot_val = arith;
            if (aluc == A_MOVZ || aluc == A_MOVN || aluc == A_MOVK) slot_val = mv;
            if (aluc == A_ORR || aluc == A_AND || aluc == A_EOR) slot_val = logic;
            if (aluc == A_LSL) slot_val = wshl(rn_rr, sh);
            if (aluc == A_LOAD) slot_val = ld1;
            if (aluc == A_LOAD_B) slot_val = byte_val;
            if (aluc == A_NONE) slot_val = 0;
"""
_PC_SWITCH = ("            switch (pcc) {\n                case P_REL: pc = br; break;",
              "                default: pc = pc4; break;\n            }\n")
_PC_SELECTS = """            const bool taken = pcc == P_REL || (pcc == P_CBZ && rd_rr == 0)
                || (pcc == P_CBNZ && rd_rr != 0)
                || (pcc == P_BCOND && ((cond_mask >> (nzcv0 & 15)) & 1));
            pc = pcc == P_IND ? rn_rr : (pcc == P_STAY ? pc0 : (taken ? br : pc4));
            if (dlv) pc = can_sig ? sig_handler : pc0;
            if (m_svc)  // KILL parks like exit
                pc = (sys_exit || pv.kill) ? pc0
                   : (sys_sigret ? wadd(frame_pc, 4) : pc4);
"""


def _span(src: str, marks, new: str) -> str:
    i = src.index(marks[0])
    j = src.index(marks[1], i) + len(marks[1])
    return src[:i] + new + src[j:]


VARIANTS = {
    "no_end_of_step_sync": [
        ("if (stores || serviced || can_sig || (io_stream && io_ok)) "
         "__syncwarp();", "")],
    "op_word_from_shared_memory": [
        ("uint32_t opw = (uint32_t)(w >> OPW_SHIFT);",
         "uint32_t opw = s_op[op];")],
    "liveness_tested_each_step": [
        ("        if (halted != RUNNING) break;",
         "        if (!(halted == RUNNING && icount < fuel)) break;")],
    "alu_selects": lambda src: _span(src, _ALU_SWITCH, _ALU_SELECTS),
    "pc_selects": lambda src: _span(src, _PC_SWITCH, _PC_SELECTS),
    "add_sub_immediate_first": [
        ("            int64_t slot_val = 0;\n            switch (aluc) {",
         "            int64_t slot_val = 0;\n"
         "            if (aluc == A_ADD_I || aluc == A_SUB_I)\n"
         "                slot_val = aluc == A_ADD_I ? wadd(rn_rsp, imm)"
         " : wsub(rn_rsp, imm);\n"
         "            else switch (aluc) {")],
}


def edit(src: str, pairs) -> str:
    if callable(pairs):
        return pairs(src)
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def census(cfg):
    sm = smoke()
    pps, regs = sm.census_processes(cfg)
    return pps, regs


class Packed:
    """A census packed once on the card; ``fresh()`` clones its carry."""

    def __init__(self, pps, regs, traced: bool, dev, order=None, pad=None):
        imgs, ids, s = pack_fleet(pps, fuel=smoke().FUEL, regs=regs,
                                  device=dev)
        tr = fleet_trace(pps, device=dev) if traced else None
        if order is not None:
            idx = torch.as_tensor(order, device=dev)
            ids = ids[idx].contiguous()
            s = MachineState(*(x[idx].contiguous() for x in s))
            if pad is not None:  # the padding lanes do nothing
                s.halted[torch.as_tensor(pad, device=dev)] = 1
            if tr is not None:
                tr = type(tr)(*(x[idx].contiguous() for x in tr))
        self.imgs, self.ids, self.s, self.tr = imgs, ids, s, tr

    def fresh(self):
        s = MachineState(*(x.clone() for x in self.s))
        tr = None if self.tr is None else type(self.tr)(
            *(x.clone() for x in self.tr))
        return s, tr


def timed_census(lib, pk: Packed, chunks: int, block: int, reps: int = 2):
    """``chunks`` launches back to back on a fresh carry, between CUDA
    events, the host's enqueueing hidden behind a spin kernel; a warm-up
    run first.  Returns (best ms, runs, final carry)."""
    times, last = [], None
    for rep in range(reps + 1):
        s, tr = pk.fresh()
        launch = mk.Launch(pk.imgs, pk.ids, s, tr, chunk=smoke().CHUNK,
                           lib=lib)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: the launches queue behind
        e0.record()
        for _ in range(chunks):
            launch(block)
        e1.record()
        torch.cuda.synchronize()
        if rep:
            times.append(e0.elapsed_time(e1))
        last = (s, tr)
    return min(times), times, last


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -- (d): the longest lane's cycles, from a copy with clock64 stamps ----------

STUDY_DECL = r'''
__device__ long long g_study[32];
extern "C" int study_read(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_study, sizeof(g_study));
}
extern "C" int study_reset() {
    long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_study, z, sizeof(z));
}
'''
# The stamps are taken in every thread and summed in registers; the
# lane's first thread of block 0 (B = 1) writes the sums out after the
# loop, so no memory access stands on the chain.  A branch on what a phase
# computed stands before each stamp, so the stamp waits for it.  Each
# phase ends at an anchor (a comment an earlier design's source and this
# one have) with the values it produced.
_ONE = "(blockIdx.x == 0 && threadIdx.x == 0)"
PHASES = [  # (name, anchor that ends it, what it produced)
    ("fetch_decode", "// -- register reads",
     "(int64_t)(aluc ^ memc ^ pcc ^ flagc) ^ w ^ imm"),
    ("register_reads", "// -- memory addressing",
     "rn_raw ^ rm_rr ^ rd_rr ^ ra_rr"),
    ("data_words", "// -- ALU / mov / load value", "v1 ^ v2"),
    ("alu", "// -- flags (NZCV", "slot_val"),
    ("flags", "// -- the policy gate (K2)", "nzcv"),
    ("syscalls_service", "// -- memory writes, in the JAX order",
     "svc_x0 ^ (int64_t)io_ok ^ (int64_t)can_sig"),
    ("memory_writes", "// -- register writes", "io_sum"),
    ("register_writes", "// -- program counter", "sp ^ nzcv"),
    ("program_counter", "// -- faults / halts", "pc"),
    ("faults_trace", "// -- bookkeeping", "halted ^ fault_pc"),
]
_ACC = ([f"_p_{n}" for n, _, _ in PHASES]
        + ["_tail", "_steps", "_svc", "_io", "_sink"])


def _stamps():
    out = [("for (int64_t t = 0; t < ",
            "long long _c_prev = 0, _c_top = 0, "
            + ", ".join(f"{n} = 0" for n in _ACC)
            + ";\n    for (int64_t t = 0; t < "),
           ("// -- fetch + decode",
            "_c_top = clock64();\n        "
            "if (_c_prev) _tail += _c_top - _c_prev;\n        "
            "_c_prev = _c_top;\n        // -- fetch + decode")]
    for name, anchor, made in PHASES:
        code = (f"if (({made}) == 0x5A5A5A5A5A5A5A5ALL) ++_sink;\n        "
                f"{{ const long long _c = clock64(); _p_{name} += _c - "
                f"_c_prev; _c_prev = _c; }}\n        ")
        if name == "faults_trace":
            code += ("_steps += 1; if (m_svc) _svc += 1; "
                     "if (io_stream) _io += 1;\n        ")
        out.append((anchor, code + anchor))
    out.append(("// -- merged writeback",
                f"if ({_ONE}) {{\n        "
                + " ".join(f"g_study[{i}] += {n};"
                           for i, n in enumerate(_ACC))
                + "\n    }\n    // -- merged writeback"))
    return out


STAMPS = _stamps()


def stamped(src: str) -> str:
    for anchor, repl in STAMPS:
        if src.count(anchor) != 1:
            raise ValueError(f"source lacks the anchor {anchor!r} once")
        src = src.replace(anchor, repl)
    i = src.index("struct MegastepArgs")
    return src[:i] + STUDY_DECL + src[i:]


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.split()[0])
    except (ValueError, IndexError):
        return float("nan")


def clock_split(source: Path, pk: Packed, chunks: int) -> dict:
    lib = load(stamped(source.read_text()), tag="clock")
    lib.study_read.argtypes = [ctypes.c_void_p]
    if lib.study_reset():
        raise RuntimeError("study_reset failed")
    s, tr = pk.fresh()
    launch = mk.Launch(pk.imgs, pk.ids, s, tr, chunk=smoke().CHUNK, lib=lib)
    for _ in range(chunks):
        launch(1)
    torch.cuda.synchronize()
    acc = (ctypes.c_longlong * 32)()
    if lib.study_read(acc):
        raise RuntimeError("study_read failed")
    a = dict(zip(_ACC, acc))
    steps = max(a["_steps"], 1)
    total = sum(a[f"_p_{n}"] for n, _, _ in PHASES) + a["_tail"]
    out = {"steps": a["_steps"], "svc_steps": a["_svc"],
           "stream_io_steps": a["_io"], "cycles_a_step": total / steps}
    for n, _, _ in PHASES:
        out[n] = a[f"_p_{n}"] / steps
    out["tail"] = a["_tail"] / steps
    return out


# -- commands -----------------------------------------------------------------

def cmd_split(args) -> None:
    sm = smoke()
    dev = torch.device("cuda")
    card = sm.card_line()
    source = Path(args.source) if args.source else mk.SOURCE
    t0 = time.perf_counter()
    lib = load(source)
    _, report = mk.build(source)
    emit({"phase": "build", "card": card, "source": str(source),
          "seconds": time.perf_counter() - t0,
          "ptxas": nvcc.ptxas_lines(report)})
    base_block = args.block
    # the blocks the build's registers allow (an earlier design's build
    # reports nothing: one thread a lane, any block up to 32 fits)
    most = (mk.kernel_info(lib)["max_lanes_per_block"]
            if hasattr(lib, "megastep_info") else 32)
    for name, (cfg, traced) in CONFIGS.items():
        pps, regs = census(cfg)
        pk = Packed(pps, regs, traced, dev)
        # (a) census order at the base block
        s, tr = pk.fresh()
        ref_launch = mk.Launch(pk.imgs, pk.ids, s, tr, chunk=sm.CHUNK,
                               lib=lib)
        chunks = 0
        while bool(fleet._alive(s).any()):
            ref_launch(base_block)
            chunks += 1
        ref = (s, tr)
        icount = s.icount.cpu().numpy()
        longest = int(icount.argmax())
        steps = int(icount.sum())
        ms_a, runs_a, out = timed_census(lib, pk, chunks, base_block)
        if not same(out[0], ref[0]):
            raise AssertionError(f"{name}: timed run differs")
        line = {"phase": "split", "config": name, "card": card,
                "lanes": len(pps), "chunks": chunks, "lane_steps": steps,
                "longest_lane": longest,
                "longest_lane_steps": int(icount[longest]),
                "a_block": base_block, "a_ms": ms_a, "a_runs": runs_a,
                "a_lane_steps_per_s": steps / (ms_a / 1e3)}
        # (b) other blocks
        line["b_ms"] = {}
        for block in (b for b in (1, 2, 4, 8, 16) if b <= most):
            ms, _, out = timed_census(lib, pk, chunks, block)
            if not same(out[0], ref[0]):
                raise AssertionError(f"{name}: block {block} differs")
            line["b_ms"][block] = ms
        # (c) one image a warp
        ids = pk.ids.cpu().numpy()
        order, pad, real = [], [], []
        for g in sorted(set(ids.tolist())):
            members = np.nonzero(ids == g)[0].tolist()
            n_pad = (-len(members)) % 32
            for lane in members:
                real.append((len(order), lane))
                order.append(lane)
            for _ in range(n_pad):
                pad.append(len(order))
                order.append(members[0])
        pkc = Packed(pps, regs, traced, dev, order=order, pad=pad)
        ms_c, _, out = timed_census(lib, pkc, chunks, min(32, most))
        pos = torch.as_tensor([p for p, _ in real], device=dev)
        back = torch.as_tensor([lane for _, lane in real], device=dev)
        un = [torch.empty_like(x) for x in ref[0]]
        for u, x in zip(un, out[0]):
            u[back] = x[pos]
        if not same(un, ref[0]):
            raise AssertionError(f"{name}: the permuted census differs")
        line.update(c_ms=ms_c, c_lanes=len(order), c_warps=len(order) // 32)
        # (d) the longest lane alone
        pkd = Packed([pps[longest]], [regs[longest]], traced, dev)
        chunks_d = math.ceil(int(icount[longest]) / sm.CHUNK)
        ms_d, _, out = timed_census(lib, pkd, chunks_d, 1)
        if not torch.equal(out[0].icount[0], ref[0].icount[longest]):
            raise AssertionError(f"{name}: the lane alone differs")
        line["d_ms"] = ms_d
        try:
            line["d_clock"] = clock_split(source, pkd, chunks_d)
        except ValueError as e:  # a source without the stamp anchors
            line["d_clock"] = f"not measured: {e}"
        line["sm_clock_max_mhz"] = sm_clock_mhz()
        if isinstance(line["d_clock"], dict):
            line["d_chain_ms"] = (line["longest_lane_steps"]
                                  * line["d_clock"]["cycles_a_step"]
                                  / (line["sm_clock_max_mhz"] * 1e3))
        emit(line)
    host_cost(lib, card, base_block)
    print(card, flush=True)


def host_cost(lib, card, block) -> None:
    """The wrapper's host time a launch, and the driver's time both ways."""
    sm = smoke()
    dev = torch.device("cuda")
    pps, regs = census(HookConfig())
    pk = Packed(pps, regs, False, dev)
    s, _ = pk.fresh()
    s.halted.fill_(1)  # every lane halted: the launches do nothing
    n = 400
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        mk.Launch(pk.imgs, pk.ids, s, chunk=sm.CHUNK, lib=lib)(block)
    build_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    launch = mk.Launch(pk.imgs, pk.ids, s, chunk=sm.CHUNK, lib=lib)
    t0 = time.perf_counter()
    for _ in range(n):
        launch(block)
    reuse_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    drivers = {}
    for way in ("args_each_chunk", "args_once", "args_each_chunk",
                "args_once"):
        s, _ = pk.fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch = mk.Launch(pk.imgs, pk.ids, s, chunk=sm.CHUNK, lib=lib)
        k = 0
        while bool(fleet._alive(s).any()):
            if way == "args_each_chunk":
                mk.Launch(pk.imgs, pk.ids, s, chunk=sm.CHUNK,
                          lib=lib)(block)
            else:
                launch(block)
            k += 1
        torch.cuda.synchronize()
        drivers.setdefault(way, []).append(
            (time.perf_counter() - t0) * 1e3)
    emit({"phase": "host", "card": card, "launch_build_args_us": build_us,
          "launch_prebuilt_us": reuse_us, "driver_ms": drivers,
          "chunks": k})


def cmd_compare(args) -> None:
    sm = smoke()
    dev = torch.device("cuda")
    card = sm.card_line()
    parent = (load(Path(args.parent), tag="parent"), PARENT_BLOCK)
    for name, (cfg, traced) in CONFIGS.items():
        pps, regs = census(cfg)
        out = run_fleet_prepared(pps, fuel=sm.FUEL, chunk=sm.CHUNK,
                                 regs=regs, device=dev)
        chunks = math.ceil(int(out.icount.max()) / sm.CHUNK)
        runs, outs = sm.census_in_turns(pps, regs, chunks, parent, dev=dev,
                                        traced=traced)
        a, b = outs["parent"], outs["this"]
        if not (same(a[0], b[0]) and (not traced or same(a[1], b[1]))):
            raise AssertionError(f"{name}: the two designs differ")
        steps = int(out.icount.sum())
        emit({"phase": "compare", "config": name, "card": card,
              "chunks": chunks, "parent_ms": runs["parent"],
              "new_ms": runs["this"],
              "speedup": min(runs["parent"]) / min(runs["this"]),
              "new_lane_steps_per_s": steps / (min(runs["this"]) / 1e3)})
    print(card, flush=True)


def cmd_variants(args) -> None:
    """The census K3 and K1 through copies of the package's source with
    parts changed (VARIANTS), beside the unchanged kernel, in turns."""
    sm = smoke()
    dev = torch.device("cuda")
    card = sm.card_line()
    src = mk.SOURCE.read_text()
    libs = {"unchanged": mk.load_library()}
    for name, pairs in VARIANTS.items():
        libs[name] = load(edit(src, pairs), tag=name)
    emit({"phase": "sass", "card": card,
          "instructions": sass_instructions(mk.SOURCE),
          "ptxas": nvcc.ptxas_lines(mk.build()[1])})
    for cfg_name in ("K3", "K1"):
        cfg, traced = CONFIGS[cfg_name]
        pps, regs = census(cfg)
        pk = Packed(pps, regs, traced, dev)
        s, tr = pk.fresh()
        launch = mk.Launch(pk.imgs, pk.ids, s, tr, chunk=sm.CHUNK)
        chunks = 0
        while bool(fleet._alive(s).any()):
            launch()
            chunks += 1
        out = {}
        for name in [*libs, "unchanged"]:
            ms, _, _ = timed_census(libs[name], pk, chunks, None, reps=2)
            out.setdefault(name, []).append(ms)
        emit({"phase": "variants", "config": cfg_name, "card": card,
              "ms": out})
    print(card, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("--source", default=None)
    sp.add_argument("--block", type=int, default=None,
                    help="the base arrangement's lanes a block (default: "
                         "the package's)")
    cp = sub.add_parser("compare")
    cp.add_argument("--parent", required=True)
    sub.add_parser("variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_megastep_study: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "split":
        args.block = args.block or mk.DEFAULT_BLOCK
        cmd_split(args)
    elif args.cmd == "compare":
        cmd_compare(args)
    else:
        cmd_variants(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
