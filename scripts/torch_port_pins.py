"""Re-derive, from the JAX package, the census and server results that
chip_smoke.py holds the PyTorch port to on the card.

chip_smoke.py pins the JAX package's 500-lane census at the default
HookConfig (counts and the sha256 of the 34 final MachineState leaves),
the same census traced (records, verdict counts and the sha256 of the 10
TraceState leaves), streamed (the records the stream received, its drops,
and the sha256 of every streamed record) and compacted (the occupancy
ledger, untraced and traced); and the JAX package's FleetServer on the
census and on the noisy-neighbor mix (the fleet_server phase: publication
ledgers, stats, scheduler counters, one C3 request's events).  Those runs
take minutes on the CPU, so the tests only copy the pins; this script
recomputes them and, with ``--check``, exits 1 if they differ from
chip_smoke.py's constants:

    JAX_PLATFORMS=cpu python scripts/torch_port_pins.py --check

``--only census`` or ``--only server`` recomputes one half.

The census half runs the census of
``benchmarks/collective_hook_overhead.py`` through
``repro.core.run_fleet_prepared`` (fuel 10M, chunk 128): untraced, with
``trace=True`` (the configs' trace_cap, all-ALLOW), through
``fleet.run_fleet_stream`` into a retaining ``TraceStream`` (as
``benchmarks/trace_overhead.py``'s streamed arm), and with
``compact=True`` untraced and traced (the HookConfig's ladder).  Leaves
are hashed with chip_smoke.py's own ``digest``, the streamed records with
its ``stream_digest``.  About 3.5 minutes a run on a CPU, five runs.

The server half drives ``repro.serve.fleet_server.FleetServer`` through
chip_smoke.py's own helpers (``census_server``, ``serve_sched_mix``,
``c3_request``): the census at a 128-lane pool untraced, then traced,
streamed, compacted and observed (each checked against the census pins:
the states stacked by rid, the records by rid); the noisy-neighbor mix
unscheduled and scheduled (every published state checked against its
solo ``run_prepared``); then one C3 request on the scheduled server,
checked against ``run_with_c3``.  1-3.5 minutes a run on a CPU, four
runs (~8 minutes).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks.collective_hook_overhead import (  # noqa: E402
    FUEL, _prepare_cells, census_grid)
from repro.core import (HookConfig, Mechanism, fleet, pack_fleet,  # noqa: E402
                        prepare, programs, run_fleet_prepared, run_prepared,
                        run_with_c3)
from repro.sched import PolicyScheduler, TenantBudget  # noqa: E402
from repro.serve.fleet_server import FleetServer  # noqa: E402
from repro.trace import TraceStream  # noqa: E402

JAX = types.SimpleNamespace(
    FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    TenantBudget=TenantBudget, prepare=prepare, programs=programs,
    Mechanism=Mechanism)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke_pins",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def census_pins(smoke) -> dict:
    digest = smoke.digest
    grid = census_grid()
    cells = _prepare_cells()
    pps = [cells[(g[0], g[3])] for g in grid]
    regs = [{19: g[4]} for g in grid]

    t0 = time.perf_counter()
    out = run_fleet_prepared(pps, fuel=FUEL, chunk=128, regs=regs)
    icount = np.asarray(out.icount)
    census = {"lanes": int(icount.shape[0]), "total_steps": int(icount.sum()),
              "longest_lane_steps": int(icount.max()),
              "enosys_total": int(np.asarray(out.enosys_count).sum()),
              "emul_served_total": int(np.asarray(out.emul_served).sum())}
    census_sha = digest(out)
    census_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, tr = run_fleet_prepared(pps, fuel=FUEL, chunk=128, regs=regs,
                               trace=True)
    traced = {"records_total": int(np.asarray(tr.count).sum()),
              "deny": int(np.asarray(tr.deny_count).sum()),
              "emul": int(np.asarray(tr.emul_count).sum()),
              "kill": int(np.asarray(tr.kill_count).sum())}
    traced_sha = digest(tr)
    traced_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    imgs, ids, states, tr = pack_fleet(pps, fuel=FUEL, regs=regs,
                                       trace=True)
    sink = TraceStream()
    out_st, _ = fleet.run_fleet_stream(imgs, states, ids, chunk=128,
                                       trace=tr, stream=sink)
    stats = sink.stats()
    streamed = {"records_seen": stats["records_seen"],
                "records_dropped": stats["records_dropped"],
                "flips": stats["flips"]}
    if digest(out_st) != census_sha:
        raise AssertionError("streamed states differ from the census")
    streamed_sha = smoke.stream_digest(sink, len(pps))
    streamed_s = time.perf_counter() - t0

    compact = {}
    for arm, traced_arm in (("untraced", False), ("traced", True)):
        t0 = time.perf_counter()
        ledger = {}
        got = run_fleet_prepared(pps, fuel=FUEL, chunk=128, regs=regs,
                                 trace=traced_arm, compact=True,
                                 compact_stats=ledger)
        want = (census_sha, traced_sha) if traced_arm else (census_sha,)
        have = (digest(got[0]), digest(got[1])) if traced_arm \
            else (digest(got),)
        if have != want:
            raise AssertionError(f"compacted {arm} census differs")
        compact[arm] = ledger
        compact[f"{arm}_s"] = time.perf_counter() - t0
    return {"census": census, "census_sha256": census_sha,
            "census_s": census_s, "traced": traced,
            "traced_sha256": traced_sha, "traced_s": traced_s,
            "streamed": streamed, "streamed_sha256": streamed_sha,
            "streamed_s": streamed_s,
            "compact_stats": compact["untraced"],
            "compact_stats_traced": compact["traced"],
            "compact_s": [compact["untraced_s"], compact["traced_s"]]}


def _equal_leaves(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def server_pins(smoke) -> dict:
    grid = census_grid()
    cells = _prepare_cells()
    pps = [cells[(g[0], g[3])] for g in grid]
    regs = [{19: g[4]} for g in grid]
    out = {}
    for arm, kw in (("served", {}),
                    ("served_traced", {"trace": True, "stream": True,
                                       "compact": True, "obs": True})):
        t0 = time.perf_counter()
        srv = smoke.census_server(JAX, pps, regs, **kw)
        results = sorted(srv.run(), key=lambda r: r.rid)
        stacked = fleet.stack_states([r.state for r in results])
        if smoke.digest(stacked) != smoke.CENSUS_DEFAULT_SHA256:
            raise AssertionError(f"{arm}: served states differ from the "
                                 "census")
        if kw and smoke.records_digest(results) != smoke.STREAMED_SHA256:
            raise AssertionError(f"{arm}: records differ from the census "
                                 "stream")
        out[arm] = smoke.served_summary(srv, results)
        out[f"{arm}_s"] = time.perf_counter() - t0

    noisy, vics = smoke.sched_mix(JAX)
    solo = {"noisy": run_prepared(noisy[0][0], fuel=smoke.FUEL,
                                  regs=noisy[0][1]),
            "victim": run_prepared(vics[0][0], fuel=smoke.FUEL,
                                   regs=vics[0][1])}
    out["sched"] = {}
    for arm, scheduled in (("unscheduled", False), ("scheduled", True)):
        t0 = time.perf_counter()
        got, srv, results, meta = smoke.serve_sched_mix(
            JAX, noisy, vics, scheduled=scheduled)
        for rid, tenant in meta.items():
            if not _equal_leaves(results[rid].state, solo[tenant]):
                raise AssertionError(f"{arm}: rid {rid} != its solo run")
        out["sched"][arm] = got
        out[f"{arm}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, got = smoke.c3_request(JAX, srv)
    ref, _, ev_ref, runs_ref = run_with_c3(
        lambda: programs.indirect_svc(3), cfg=HookConfig(), virtualize=True,
        fuel=smoke.FUEL)
    if (res.events != ev_ref or res.attempts != runs_ref
            or not _equal_leaves(res.state, ref)):
        raise AssertionError("the served C3 request != run_with_c3")
    out["c3"] = got
    out["c3_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless chip_smoke.py's pins match")
    ap.add_argument("--only", choices=("census", "server"), default=None,
                    help="recompute one half only")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    got, want = {}, {}
    if args.only != "server":
        got.update(census_pins(smoke))
        want.update({"census": smoke.CENSUS_DEFAULT_EXPECTED,
                     "census_sha256": smoke.CENSUS_DEFAULT_SHA256,
                     "traced": smoke.TRACED_EXPECTED,
                     "traced_sha256": smoke.TRACED_SHA256,
                     "streamed": smoke.STREAMED_EXPECTED,
                     "streamed_sha256": smoke.STREAMED_SHA256,
                     "compact_stats": smoke.COMPACT_STATS,
                     "compact_stats_traced": smoke.COMPACT_STATS_TRACED})
    if args.only != "census":
        got.update(server_pins(smoke))
        want.update({"served": smoke.FS_SERVED_EXPECTED,
                     "served_traced": smoke.FS_TRACED_EXPECTED,
                     "sched": smoke.FS_SCHED_EXPECTED,
                     "c3": smoke.FS_C3_EXPECTED})
    print(json.dumps(got), flush=True)
    if not args.check:
        return 0
    bad = [k for k, v in want.items() if got[k] != v]
    print(json.dumps({"pins_match": not bad, "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
