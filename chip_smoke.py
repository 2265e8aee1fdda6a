#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is a census run: 500 simulated AArch64 processes (5
interception mechanisms x 5 workloads x 20 iteration counts, 25 decode
images, ~8k instructions a lane) prepared with ASC-Hook and run to halt as
one fleet through ``repro_torch.core.run_fleet_prepared`` — every chunk of
steps one launch of the CUDA megastep kernel.  Guest-kernel emulation is
off (``HookConfig(emul_enabled=False)``) and the run is untraced: the
configuration this slice of the port covers.

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build the kernel from ``src/`` (nvcc, sm_90a) and read the card;
2. kernel vs plain PyTorch version on the card, one chunk at chunk 1, 8
   and 128 from the census's initial state and from seeded random states,
   at two block sizes — every leaf bit for bit;
3. the main path to halt through the kernel, held leaf for leaf against
   the plain version to halt, and against the census's deterministic
   counts; kernel and plain times;
4. the Table-3 per-call cycles (simulated, deterministic);
5. the kernel table line, then the device line, which is the last.

Needs one card; with none it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (HookConfig, Mechanism, fleet, pack_fleet,  # noqa: E402
                              prepare, programs, run_fleet_prepared)
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.machine import HALT_EXIT, MachineState  # noqa: E402
from repro_torch.kernels.megastep import kernel as mkernel  # noqa: E402
from repro_torch.kernels.megastep import ops as mops  # noqa: E402
from repro_torch.kernels.megastep.ref import megastep_chunk_ref  # noqa: E402

# -- the census deployment (a copy of benchmarks/collective_hook_overhead.py)
FUEL = 10_000_000
CHUNK = 128

MECHS = [
    ("none", Mechanism.NONE, False),
    ("ld_preload", Mechanism.LD_PRELOAD, True),
    ("asc", Mechanism.ASC, True),
    ("signal", Mechanism.SIGNAL, True),
    ("ptrace", Mechanism.PTRACE, True),
]

WORKLOADS = {
    "getpid": programs.getpid_loop_param,
    "read": lambda: programs.read_loop_param(1024),
    "mixed": lambda: programs.mixed_ops_param(512),
    "io_bw": lambda: programs.io_bandwidth_param(4096),
    "churn": lambda: programs.file_churn_param(512),
}

_BASE_ITERS = {  # ~8000 steps / measured steps-per-iter, rounded
    "getpid": {"none": 1140, "ld_preload": 530, "asc": 140,
               "signal": 260, "ptrace": 1140},
    "read": {"none": 730, "ld_preload": 730, "asc": 130,
             "signal": 230, "ptrace": 730},
    "mixed": {"none": 220, "ld_preload": 220, "asc": 30,
              "signal": 60, "ptrace": 220},
    "io_bw": {"none": 350, "ld_preload": 350, "asc": 60,
              "signal": 110, "ptrace": 350},
    "churn": {"none": 174, "ld_preload": 174, "asc": 32,
              "signal": 48, "ptrace": 174},
}
SCALES = tuple(round(1.0 - 0.01 * i, 2) for i in range(20))

# What the JAX package gives for this census with emulation off (pinned in
# tests/test_torch_fleet.py): every lane exits, these step and -ENOSYS
# totals.  Deterministic counts, not timings.
CENSUS_EXPECTED = {"lanes": 500, "total_steps": 3_603_972,
                   "longest_lane_steps": 8_306, "enosys_total": 10_850}
# Table 3 of the paper as the cost model reproduces it (simulated cycles).
TABLE3_CYCLES = {"ld_preload": 18.0, "asc": 105.0, "signal": 2812.0,
                 "ptrace": 5940.0}
N_HI, N_LO = 400, 200  # benchmarks/hook_overhead.py's differential

# -- the bound's counting rules ------------------------------------------------
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12      # the card's float32 rate; its int64 rate is lower
OPS_PER_STEP = 128         # integer operations in one step's common path
SMALL_READ_WORDS = 174     # carry words a lane loads (all but mem, ino_data)
SMALL_WRITE_WORDS = 46     # carry words it writes back (regs + 15 scalars)


def census_grid():
    """[(mech_name, mech, virt, workload, n)] — the full census."""
    grid = []
    for mname, mech, virt in MECHS:
        for wname in WORKLOADS:
            base = _BASE_ITERS[wname][mname]
            for sc in SCALES:
                grid.append((mname, mech, virt, wname, max(2, int(base * sc))))
    return grid


def census_processes(cfg=None):
    """The census's prepared processes (25 images shared by 500 lanes)
    and per-lane entry registers."""
    cfg = cfg or HookConfig(emul_enabled=False)
    cells = {(m, w): prepare(WORKLOADS[w](), mech, virtualize=virt, cfg=cfg)
             for m, mech, virt in MECHS for w in WORKLOADS}
    grid = census_grid()
    return [cells[(g[0], g[3])] for g in grid], [{19: g[4]} for g in grid]


def per_call_cycles(device=None, n_hi: int = N_HI, n_lo: int = N_LO) -> dict:
    """{mechanism: raw per-call cycles}: the 10 getpid lanes of
    ``benchmarks/hook_overhead.py`` (N = 400 and 200) as one fleet.  The
    cost model is deterministic and a loop iteration costs the same at any
    N, so smaller N give the same differential."""
    cfg = HookConfig(emul_enabled=False)
    pps, keys = [], []
    for name, mech, virt in MECHS:
        for n in (n_hi, n_lo):
            pps.append(prepare(programs.getpid_loop(n), mech,
                               virtualize=virt, cfg=cfg))
            keys.append((name, n))
    out = run_fleet_prepared(pps, fuel=FUEL, device=device)
    by_key = dict(zip(keys, out.cycles.cpu().tolist()))
    return {name: (by_key[(name, n_hi)] - by_key[(name, n_lo)]) / (n_hi - n_lo)
            for name, _, _ in MECHS}


def table3(raw: dict) -> dict:
    """Per-call cycles net of the loop skeleton (hook_overhead.run)."""
    skeleton = raw["none"] - cm.KERNEL_CROSS
    return {k: round(raw[k] - skeleton, 2) for k in TABLE3_CYCLES}


def scramble(leaves: dict, code, rng) -> dict:
    """A seeded random machine state from a packed one (numpy leaves).

    ``code[b]`` is lane b's ``(sections, svc_pcs)``: the ``(base, end)``
    ranges of its image's code sections and the addresses of its svc
    instructions.  Registers get small, huge, negative and data-address
    values, aligned and not; the link register a code address; memory,
    flags and signal state are random.  A third of the lanes start on an
    svc with a syscall number in x8 (read and write often, with a buffer
    in x1 and a byte count in x2 that may be negative or unaligned); the
    rest start anywhere in the code, a few at an unaligned or wild pc.
    Emulation stays off and fuel stays as packed."""
    out = {k: np.array(v) for k, v in leaves.items()}
    B = out["pc"].shape[0]

    def pick(shape):
        kinds = rng.integers(0, 5, shape)
        small = rng.integers(-64, 4096, shape)
        huge = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64,
                            endpoint=True)
        data = L.DATA_BASE + 8 * rng.integers(-4, L.MEM_WORDS + 4, shape)
        odd = data + rng.integers(1, 8, shape)
        return np.select([kinds == 0, kinds == 1, kinds == 2, kinds == 3],
                         [small, huge, data, odd], data - 8 * small)

    def code_addr(b):
        lo, hi = code[b][0][rng.integers(0, len(code[b][0]))]
        return lo + 4 * rng.integers(0, max(1, (hi - lo) // 4))

    regs = pick((B, 31))
    regs[:, 30] = [code_addr(b) for b in range(B)]
    pcs = np.asarray([code_addr(b) for b in range(B)], np.int64)
    r = rng.random(B)
    pcs = np.where(r < 0.04, pcs + 2, np.where(r < 0.07, pick(B), pcs))
    nrs = np.asarray([63, 63, 63, 64, 64, 64, 172, 93, 139, 56, 57, 62, 23,
                      80, 59, 278, 29, 181, 0], np.int64)
    sizes = np.asarray([0, 8, 64, 1024, 4096, 32768, 40000, -8, 7, 12],
                       np.int64)
    heap = L.HEAP_BASE + 8 * rng.integers(0, 2048, B)
    for b in np.nonzero(rng.random(B) < 1 / 3)[0]:
        if len(code[b][1]):
            pcs[b] = rng.choice(code[b][1])
            regs[b, 8] = rng.choice(nrs)
            regs[b, 1] = heap[b] if rng.random() < 0.8 else regs[b, 1]
            regs[b, 2] = rng.choice(sizes)
    out["regs"] = regs
    out["pc"] = pcs
    out["sp"] = np.where(rng.random(B) < 0.8,
                         L.STACK_TOP - 8 * rng.integers(0, 512, B), pick(B))
    out["nzcv"] = rng.integers(0, 16, B)
    out["mem"] = rng.integers(-2**63, 2**63 - 1, out["mem"].shape,
                              dtype=np.int64, endpoint=True)
    out["in_signal"] = rng.integers(0, 2, B)
    out["in_off"] = rng.integers(0, 1 << 20, B)
    return out


def code_of(pps) -> list:
    """Per lane, its image's code sections and svc addresses (for
    :func:`scramble`)."""
    from repro_torch.core.isa import Op
    out = []
    for pp in pps:
        ops = np.asarray(pp.decoded.op)
        out.append(([(s.base, s.end) for s in pp.image.sections],
                    4 * np.nonzero(ops == int(Op.SVC))[0]))
    return out


# -- helpers -------------------------------------------------------------------

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def clone_state(s: MachineState) -> MachineState:
    return MachineState(*(x.clone() for x in s))


def mismatched(a: MachineState, b: MachineState) -> list:
    return [f for f, x, y in zip(MachineState._fields, a, b)
            if not torch.equal(x, y)]


def max_abs_err(a: MachineState, b: MachineState) -> int:
    return max(int((x - y).abs().max()) for x, y in zip(a, b))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def plain_run_to_halt(imgs, ids, s, chunk):
    """The plain version's run to halt: the drivers' loop around
    megastep_chunk_ref (no kernel, no launch count)."""
    n = 0
    while bool(fleet._alive(s).any()):
        s = megastep_chunk_ref(imgs, ids, s, chunk=chunk)
        n += 1
    return fleet._patch_fuel(s), n


def census_bound_ms(out: MachineState, code_words: int) -> tuple:
    """The least time the card could take for the census's work: the
    larger of its bytes over the memory rate and its integer operations
    over the peak rate (see PERF.md for the counting rules).
    ``code_words`` counts the code words in the sections of the distinct
    images (16 bytes of decode table each)."""
    lanes = int(out.pc.shape[0])
    steps = int(out.icount.sum())
    payload = int(out.in_off.sum() + out.out_count.sum())  # I/O bytes moved
    nbytes = (lanes * 8 * (SMALL_READ_WORDS + SMALL_WRITE_WORDS)
              + 16 * code_words + payload)
    ops = steps * OPS_PER_STEP + 2 * payload // 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            nbytes, ops)


# -- phases --------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # 1. build
    t0 = time.perf_counter()
    lib, report = mkernel.build()
    build_s = time.perf_counter() - t0
    mkernel.load_library()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit({"phase": "build", "seconds": build_s, "library": lib.name,
          "ptxas": ptxas, "card": card, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. kernel vs plain, one chunk, on the card
    t0 = time.perf_counter()
    pps, regs = census_processes()
    imgs, ids, s0 = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
    prep_s = time.perf_counter() - t0
    code = code_of(pps)
    starts = [("census_initial", s0)]
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        host = {f: getattr(s0, f).cpu().numpy() for f in MachineState._fields}
        sc = scramble(host, code, rng)
        starts.append((f"random_seed{seed}", MachineState(
            *(torch.from_numpy(sc[f]).to(dev)
              for f in MachineState._fields))))
    checks = 0
    for name, start in starts:
        for chunk in (1, 8, 128):
            want = megastep_chunk_ref(imgs, ids, clone_state(start),
                                      chunk=chunk)
            for block in (32, 96):  # 500 % 32 and 500 % 96: ragged edges
                got = mops.megastep_chunk(imgs, ids, clone_state(start),
                                          chunk=chunk, block=block)
                torch.cuda.synchronize()
                bad = mismatched(want, got)
                if bad:
                    raise AssertionError(
                        f"kernel != plain on {name}, chunk={chunk}, "
                        f"block={block}: leaves {bad}")
                checks += 1
    emit({"phase": "kernel_vs_plain", "lanes": int(s0.pc.shape[0]),
          "images": int(imgs.packed.shape[0]), "starts": len(starts),
          "chunks": [1, 8, 128], "blocks": [32, 96], "checks": checks,
          "mismatched_leaves": 0, "prepare_s": prep_s})

    # 3. the main path to halt, through the kernel
    run_fleet_prepared(pps[:8], fuel=FUEL, chunk=CHUNK, regs=regs[:8],
                       device=dev)  # warm-up: allocator, streams
    torch.cuda.synchronize()
    mops.megastep_chunk.launches = 0
    t0 = time.perf_counter()
    out = run_fleet_prepared(pps, fuel=FUEL, chunk=CHUNK, regs=regs,
                             device=dev)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = mops.megastep_chunk.launches

    icount = out.icount.cpu().numpy()
    halted = out.halted.cpu().numpy()
    chunks = math.ceil(int(icount.max()) / CHUNK)
    if launches <= 0 or launches != chunks:
        raise AssertionError(f"launches {launches}, chunks dispatched {chunks}")
    got = {"lanes": int(icount.shape[0]), "total_steps": int(icount.sum()),
           "longest_lane_steps": int(icount.max()),
           "enosys_total": int(out.enosys_count.sum())}
    if got != CENSUS_EXPECTED or not (halted == HALT_EXIT).all():
        raise AssertionError(f"census counts {got}, halted "
                             f"{np.bincount(halted).tolist()}; expected "
                             f"{CENSUS_EXPECTED}, all HALT_EXIT")

    # where the main path's time goes: packing (host), then the driver
    # loop (kernel launches + one host sync per chunk)
    t0 = time.perf_counter()
    _, _, sd = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mops.run(imgs, ids, sd, chunk=CHUNK)
    torch.cuda.synchronize()
    driver_ms = (time.perf_counter() - t0) * 1e3
    if mismatched(sd, out):
        raise AssertionError("driver run != main path")

    # plain version to halt on the card, from the same packed state
    _, _, sp0 = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, plain_chunks = plain_run_to_halt(imgs, ids, sp0, CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = mismatched(plain, out)
    if bad:
        raise AssertionError(f"main path != plain version: leaves {bad}")
    err = max_abs_err(plain, out)

    # the kernel's own time for the whole census: `chunks` launches back to
    # back (CUDA events), after a warm-up pass; uncounted launches
    times = []
    for rep in range(3):
        _, _, sk = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(chunks):
            mkernel.megastep_chunk_cuda(imgs, ids, sk, chunk=CHUNK)
        e1.record()
        torch.cuda.synchronize()
        if rep:
            times.append(e0.elapsed_time(e1))
        if mismatched(fleet._patch_fuel(sk), out):
            raise AssertionError("timed kernel run != main path")
    kernel_ms = min(times)
    distinct = {id(pp): pp for pp in pps}.values()
    code_words = sum(sec.size // 4 for pp in distinct
                     for sec in pp.image.sections)
    (bound_ms, bound_by), nbytes, nops = census_bound_ms(out, code_words)
    emit({"phase": "main_path", "card": card, **got,
          "halted": {"HALT_EXIT": int((halted == HALT_EXIT).sum())},
          "chunk": CHUNK, "launches": launches,
          "path_s": path_s, "pack_s": pack_s, "driver_ms": driver_ms,
          "kernel_ms": kernel_ms, "kernel_ms_runs": times,
          "device_idle_share": 1 - kernel_ms / driver_ms,
          "lane_steps_per_s": got["total_steps"] / (kernel_ms / 1e3),
          "plain_ms": plain_ms, "plain_chunks": plain_chunks,
          "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
          "bound_ops": nops, "mismatched_leaves": 0})

    # 4. the deterministic invariant: Table 3 per-call cycles
    cyc = table3(per_call_cycles(device=dev))
    if cyc != TABLE3_CYCLES:
        raise AssertionError(f"Table-3 cycles {cyc} != {TABLE3_CYCLES}")
    emit({"phase": "table3", "cycles_per_call": cyc})

    # 5. the kernel table, the card, and the device line (last)
    emit({"kernels": [{
        "name": "megastep_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/megastep/csrc/megastep.cu",
        "replaces": "src/repro/kernels/megastep/kernel.py:103",
        "launches": launches, "max_abs_err": err, "mismatched_leaves": 0,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
