"""The census driver: ``core/runtime.prepare`` and ``pack_fleet`` once in
set-up, then ``core/fleet.run_fleet`` to halt again and again, one census
at a time (a unit of the window), each from a fresh device copy of the
packed carry.

A cell's ``params``: ``sample_per_cell``, the lanes of each mechanism x
program cell that the reference checks.

Correctness: once the window has closed, the lanes the seed samples from
the last two censuses are copied to the host, the program's state is
freed, and the frozen reference (``bench/ref/asc``) prepares, packs and
runs the same processes on the host; every one of the 34 leaves of every
sampled lane must equal it.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import counts, traffic
from ..common import check, positive_int

KINDS = ("census",)
PARAMS = {"sample_per_cell": positive_int}
CONTROLS = ("emul_off",)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Cell:
    """One run of a census cell on ``device`` (the card; the CPU in the
    harness's own tests, where the port runs its plain step)."""

    def __init__(self, wl: Dict, cfg: Dict, seed: int, device):
        self.wl, self.cfg, self.seed = wl, cfg, seed
        self.dev = torch.device(device)
        self.lanes = traffic.census_lanes(cfg, seed)
        self.sample = traffic.census_sample(
            cfg, self.lanes, seed, wl["params"]["sample_per_cell"])
        self.counters: Dict[str, float] = {}
        # the program's guest-kernel emulation: the configuration's, but
        # off in the control
        self.program_emul = cfg["emul_enabled"]

    def control(self, name: str) -> None:
        """The control, ``emul_off``: the program with the guarantee of
        guest-kernel emulation broken; the run then goes on as any."""
        if name not in CONTROLS:
            raise ValueError(f"no census control {name!r}")
        self.program_emul = not self.cfg["emul_enabled"]

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import programs, runtime
        from repro_torch.core.hookcfg import HookConfig
        cfg = self.cfg
        hc = HookConfig(fleet_chunk=cfg["chunk"],
                        emul_enabled=self.program_emul)
        cells = {}
        t0 = time.perf_counter()
        with record_function("bench.census.prepare"):
            for m, v, p in traffic.census_cells(cfg):
                builder, args = cfg["programs"][p]
                cells[(m, p)] = runtime.prepare(
                    getattr(programs, builder)(*args),
                    runtime.Mechanism(m), virtualize=v, cfg=hc)
        self.counters["prepare_s"] = time.perf_counter() - t0
        pps = [cells[(ln.mechanism, ln.program)] for ln in self.lanes]
        regs = [{cfg["iter_reg"]: ln.iters} for ln in self.lanes]
        t0 = time.perf_counter()
        with record_function("bench.census.pack"):
            self.imgs, self.ids, self.packed = runtime.pack_fleet(
                pps, fuel=cfg["fuel"], regs=regs, device=self.dev)
            _sync(self.dev)
        self.counters["pack_s"] = time.perf_counter() - t0
        self.code_words = _code_words(cells.values())
        self.work = [type(self.packed)(*(x.clone() for x in self.packed))
                     for _ in range(2)]
        self.runs = 0
        t0 = time.perf_counter()
        self.unit()        # warm: builds or loads the kernel library
        self.counters["warm_s"] = time.perf_counter() - t0
        out = self.work[0]
        self.lane_steps = int(out.icount.sum())
        self.stream_bytes = int(out.in_off.sum() + out.out_count.sum())
        self.runs = 0

    # -- the measured path --------------------------------------------------
    def unit(self) -> None:
        """One census, from the packed carry to its synchronised halt."""
        from repro_torch.core import fleet
        w = self.work[self.runs % 2]
        with record_function("bench.census.copy"):
            for dst, src in zip(w, self.packed):
                dst.copy_(src)
        with record_function("bench.census.run_fleet"):
            fleet.run_fleet(self.imgs, w, self.ids, chunk=self.cfg["chunk"],
                            device=self.dev)
        _sync(self.dev)
        self.runs += 1

    def end_to_end(self, times: List[float],
                   window_s: float) -> Dict[str, float]:
        return {"census_lane_steps_per_s":
                self.lane_steps * len(times) / window_s,
                "census_p95_ms": float(np.percentile(times, 95)) * 1e3}

    # -- after the window ---------------------------------------------------
    def release(self) -> None:
        """Keep the sampled lanes of the last two censuses on the host and
        free the program's state."""
        idx = torch.tensor(self.sample, device=self.dev)
        kept = [self.work[(self.runs - 1 - k) % 2]
                for k in range(min(2, self.runs))]
        self.kept_steps = [int(w.icount.sum()) for w in kept]
        self.got = [[leaf.index_select(0, idx).cpu() for leaf in w]
                    for w in kept]
        self.fields = type(self.packed)._fields
        del self.work, self.packed, self.imgs, self.ids, kept
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """The sampled lanes run to halt by the frozen reference."""
        from ..ref.asc import prepare as R
        from ..ref.asc.core.hookcfg import HookConfig
        cfg = self.cfg
        hc = HookConfig(fleet_chunk=cfg["chunk"],
                        emul_enabled=cfg["emul_enabled"])
        cells, pps, states = {}, [], []
        for i in self.sample:
            ln = self.lanes[i]
            key = (ln.mechanism, ln.program)
            if key not in cells:
                builder, args = cfg["programs"][ln.program]
                cells[key] = R.prepare(R.build_program(builder, args),
                                       R.Mechanism(ln.mechanism),
                                       virtualize=ln.virtualize, cfg=hc)
            pps.append(cells[key])
            states.append(R.initial_state(cells[key], fuel=cfg["fuel"],
                                          regs={cfg["iter_reg"]: ln.iters}))
        imgs, ids, s = R.pack(pps, states)
        return R.run_to_halt(imgs, ids, s)

    def check(self) -> List[dict]:
        ref = self.reference()
        bad = 0
        for got in self.got:
            for name, g, r in zip(self.fields, got, ref):
                bad += int((g != r).reshape(len(self.sample), -1)
                           .any(dim=1).sum())
        self.failed = sum(
            1 for got in self.got
            if any(not torch.equal(g, r) for g, r in zip(got, ref)))
        disagree = sum(1 for n in self.kept_steps if n != self.lane_steps)
        return [check("census.mismatched_leaves", bad, 0),
                check("census.runs_off_lane_steps", disagree, 0)]

    # -- per-layer readings --------------------------------------------------
    def least_s(self) -> float:
        """The bytes-bound least time of one census on the card."""
        churn = self.cfg["emul_payload_per_iter"]
        payload = sum(churn.get(ln.program, 0) * ln.iters
                      for ln in self.lanes)
        return counts.census_least_s(
            lanes=len(self.lanes), code_words=self.code_words,
            stream_bytes=self.stream_bytes, emul_payload=payload)


def _code_words(pps) -> int:
    """The code words of the distinct images (16 bytes of decode table
    each)."""
    import hashlib
    seen = {}
    for pp in pps:
        seen[hashlib.sha1(np.ascontiguousarray(pp.image.words)
                          .tobytes()).hexdigest()] = pp
    return sum(sec.size // 4 for pp in seen.values()
               for sec in pp.image.sections)
