"""Re-derive, from the JAX package, the census results that chip_smoke.py
holds the PyTorch port to on the card.

chip_smoke.py pins the JAX package's 500-lane census at the default
HookConfig (counts and the sha256 of the 34 final MachineState leaves),
the same census traced (records, verdict counts and the sha256 of the 10
TraceState leaves), streamed (the records the stream received, its drops,
and the sha256 of every streamed record) and compacted (the occupancy
ledger, untraced and traced).  Those runs take minutes on the CPU, so the
tests only copy the pins; this script recomputes them and, with
``--check``, exits 1 if they differ from chip_smoke.py's constants:

    JAX_PLATFORMS=cpu python scripts/torch_port_pins.py --check

It runs the census of ``benchmarks/collective_hook_overhead.py`` through
``repro.core.run_fleet_prepared`` (fuel 10M, chunk 128): untraced, with
``trace=True`` (the configs' trace_cap, all-ALLOW), through
``fleet.run_fleet_stream`` into a retaining ``TraceStream`` (as
``benchmarks/trace_overhead.py``'s streamed arm), and with
``compact=True`` untraced and traced (the HookConfig's ladder).  Leaves
are hashed with chip_smoke.py's own ``digest``, the streamed records with
its ``stream_digest``.  About 3.5 minutes a run on a CPU, five runs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks.collective_hook_overhead import (  # noqa: E402
    FUEL, _prepare_cells, census_grid)
from repro.core import fleet, pack_fleet, run_fleet_prepared  # noqa: E402
from repro.trace import TraceStream  # noqa: E402


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless chip_smoke.py's pins match")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    got = census_pins(smoke)
    print(json.dumps(got), flush=True)
    if not args.check:
        return 0
    want = {"census": smoke.CENSUS_DEFAULT_EXPECTED,
            "census_sha256": smoke.CENSUS_DEFAULT_SHA256,
            "traced": smoke.TRACED_EXPECTED,
            "traced_sha256": smoke.TRACED_SHA256,
            "streamed": smoke.STREAMED_EXPECTED,
            "streamed_sha256": smoke.STREAMED_SHA256,
            "compact_stats": smoke.COMPACT_STATS,
            "compact_stats_traced": smoke.COMPACT_STATS_TRACED}
    bad = [k for k, v in want.items() if got[k] != v]
    print(json.dumps({"pins_match": not bad, "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
