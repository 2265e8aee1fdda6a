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

The durable half (``--only durable``) drives the JAX server through
chip_smoke.py's ``durable_server`` helpers (``durable_census``,
``kill_and_recover``, ``chaos_census``): the census at 400 lanes plain
and durable (snapshots, journal records, the publication ledger; both
runs' states checked against the census pin), killed after 11
generations and recovered (the kill generation, the replayed generations
and results; the union checked against the census), ``served_traced``
durable and killed at generation 11 (the records by rid checked against
the census stream, 0 dropped), and the chaos soak at 128 lanes (its
ledger summary and the rids whose published state a bit-flip reached,
each checked to differ from its census lane by exactly one injected
bit).  ~30 minutes on a CPU.

The training half (``--only train``) runs ``repro.train.loop.run_training``
through chip_smoke.py's ``train_pin_runs``: for each of its
``TRAIN_ARCHS`` (SMOKE), the parameters of chip_smoke.py's
``numpy_params`` saved as a step-0 checkpoint, ``TRAIN_STEPS`` steps
straight, and again with an ``InjectedFailure`` at ``TRAIN_FAIL_AT`` and
the auto-resume (checked equal to the straight run's losses); the
straight run's per-step losses are the pins (``TRAIN_PINS``), which
chip_smoke.py's ``train_pins`` phase holds the port's losses on the card
to within 2e-2 relative.  Under a minute on a CPU.

The hooks half (``--only hooks``) takes the JAX package's
``repro.hooks.census_fn`` of its ``make_ddp_train_step`` for chip_smoke.py's
``FULL_TRAIN_ARCH`` at full width, its ``FULL_TRAIN_RUN`` and one batch of
``FULL_TRAIN_SHAPE``, on a (1, 1) test mesh: sites, primitives and payload
bytes (``HOOK_CENSUS``, which the ``collective_hooks`` phase holds the
port's census of its own DDP step to on the card).  The state is
``jax.eval_shape``'s and the census only traces, so it takes seconds.

The dry-run half (``--only dryrun``) compiles the JAX package's
``make_train_step`` for one CPU device at the ``train_full`` cell
(``FULL_TRAIN_ARCH`` at full width, ``FULL_TRAIN_RUN``, one batch of
``FULL_TRAIN_SHAPE``; abstract inputs, no weights) and reads its dot
FLOPs with ``repro.launch.hloanalysis.analyze`` (``DRYRUN_DOT_FLOPS``,
which the ``dryrun`` phase holds the port's operator count to, on fake
and on real tensors).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
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
from repro.serve.chaos import ChaosMonkey  # noqa: E402
from repro.serve.durability import DurabilityManager  # noqa: E402
from repro.serve.fleet_server import FleetServer  # noqa: E402
from repro.trace import TraceStream  # noqa: E402
from repro.configs import RunConfig, ShapeConfig, get_smoke  # noqa: E402
from repro.train import loop as train_loop  # noqa: E402

JAX = types.SimpleNamespace(
    FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    TenantBudget=TenantBudget, prepare=prepare, programs=programs,
    Mechanism=Mechanism, HookConfig=HookConfig,
    DurabilityManager=DurabilityManager, ChaosMonkey=ChaosMonkey)


JAX_TRAIN = types.SimpleNamespace(
    run_training=train_loop.run_training,
    InjectedFailure=train_loop.InjectedFailure, RunConfig=RunConfig,
    ShapeConfig=ShapeConfig, get_smoke=get_smoke)


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


def _by_rid_sha(smoke, results) -> str:
    """The census digest of published states stacked by rid."""
    by_rid = sorted(results, key=lambda r: r.rid)
    return smoke.digest(fleet.stack_states([r.state for r in by_rid]))


def durable_pins(smoke) -> dict:
    grid = census_grid()
    cells = _prepare_cells()
    pps = [cells[(g[0], g[3])] for g in grid]
    regs = [{19: g[4]} for g in grid]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _, plain, _ = smoke.durable_census(JAX, pps, regs)
        srv, res, _ = smoke.durable_census(JAX, pps, regs, tmp / "durable")
        for arm, r in (("plain", plain), ("durable", res)):
            if _by_rid_sha(smoke, r) != smoke.CENSUS_DEFAULT_SHA256:
                raise AssertionError(f"durable {arm}: states differ from "
                                     "the census")
        if (smoke.publication_ledger(res)
                != smoke.publication_ledger(plain)):
            raise AssertionError("durable ledger != plain ledger")
        out["durable"] = smoke.durable_summary(srv, res)
        out["durable_s"] = time.perf_counter() - t0
        census = {r.rid: r.state for r in res}

        def make():
            s = FleetServer(pool=smoke.DUR_POOL, gen_steps=smoke.FS_GEN_STEPS,
                            chunk=smoke.CHUNK, fuel=smoke.FUEL,
                            cfg=HookConfig(
                                snapshot_interval=smoke.DUR_INTERVAL),
                            durability=DurabilityManager(tmp / "victim"))
            for pp, rg in zip(pps, regs):
                s.submit(pp, regs=rg)
            return s
        t0 = time.perf_counter()
        _, union, counts, _, _ = smoke.kill_and_recover(
            JAX, make, tmp / "victim", smoke.DUR_KILL)
        if _by_rid_sha(smoke, union.values()) != smoke.CENSUS_DEFAULT_SHA256:
            raise AssertionError("kill_recover: states differ from the "
                                 "census")
        out["kill_recover"] = counts
        out["kill_recover_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        srv, union, counts, _, before = smoke.kill_and_recover(
            JAX, lambda: smoke.census_server(
                JAX, pps, regs, trace=True, stream=True, compact=True,
                obs=True, durability=DurabilityManager(tmp / "traced")),
            tmp / "traced", smoke.TRACED_KILL, watch=smoke.obs_watermark)
        below = smoke.not_below(smoke.obs_watermark(srv), before)
        if (smoke.records_digest(union.values()) != smoke.STREAMED_SHA256
                or srv.stats()["stream"]["records_dropped"] or below
                or _by_rid_sha(smoke, union.values())
                != smoke.CENSUS_DEFAULT_SHA256):
            raise AssertionError(f"traced_recover differs: {below}")
        out["traced_recover"] = {
            **counts, "records": sum(len(r.trace) for r in union.values())}
        out["traced_recover_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        srv, got = smoke.chaos_census(JAX, pps, regs, tmp / "soak")
        summary = smoke.soak_summary(srv)
        escaped = []
        for rid, r in sorted(got.items()):
            if _equal_leaves(r.state, census[rid]):
                continue
            bad = [f for f, a, b in zip(r.state._fields, r.state,
                                        census[rid])
                   if not np.array_equal(np.asarray(a), np.asarray(b))]
            if bad != ["mem"] or not smoke.injected_flip(
                    r.state.mem, census[rid].mem, srv._chaos.injections):
                raise AssertionError(f"soak rid {rid}: {bad} differ from "
                                     "the census beyond an injected flip")
            escaped.append(rid)
        if set(got) | set(summary["shed_rids"]) != set(range(len(pps))):
            raise AssertionError("soak: a request neither published nor "
                                 "shed")
        out["chaos_soak"] = {**summary, "escaped_flip_rids": escaped}
        out["chaos_soak_s"] = time.perf_counter() - t0
    return out


def train_pins(smoke) -> dict:
    out = {}
    with tempfile.TemporaryDirectory(prefix="torch-port-pins-train-") as d:
        for arch in smoke.TRAIN_ARCHS:
            runs = smoke.train_pin_runs(JAX_TRAIN, arch, d)
            straight, crashed = runs["straight"], runs["crashed"]
            assert crashed.resumed_from == smoke.TRAIN_FAIL_AT
            assert crashed.losses == straight.losses[smoke.TRAIN_FAIL_AT:]
            out[arch] = straight.losses
    return {"train": out}


def hooks_pins(smoke) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.hooks import census_fn
    from repro.launch.mesh import make_test_mesh
    from repro.train.step import init_train_state, make_ddp_train_step

    cfg = get_config(smoke.FULL_TRAIN_ARCH)
    run = RunConfig(**smoke.FULL_TRAIN_RUN)
    seq, gb = smoke.FULL_TRAIN_SHAPE
    state = jax.eval_shape(lambda k: init_train_state(cfg, run, k),
                           jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((gb, seq), jnp.int32)}
    c = census_fn(make_ddp_train_step(cfg, run, make_test_mesh(1, 1)),
                  state, batch)
    return {"hooks": {k: c[k] for k in smoke.HOOK_CENSUS}}


def dryrun_pins(smoke) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.hloanalysis import analyze
    from repro.train.step import init_train_state, make_train_step

    cfg = get_config(smoke.FULL_TRAIN_ARCH)
    run = RunConfig(**smoke.FULL_TRAIN_RUN)
    seq, gb = smoke.FULL_TRAIN_SHAPE
    state = jax.eval_shape(lambda k: init_train_state(cfg, run, k),
                           jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((gb, seq), jnp.int32)}
    compiled = jax.jit(make_train_step(cfg, run)).lower(state,
                                                        batch).compile()
    return {"dryrun_dot_flops": analyze(compiled.as_text()).dot_flops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless chip_smoke.py's pins match")
    ap.add_argument("--only", choices=("census", "server", "durable",
                                       "train", "hooks", "dryrun"),
                    default=None, help="recompute one part only")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    got, want = {}, {}
    if args.only in (None, "census"):
        got.update(census_pins(smoke))
        want.update({"census": smoke.CENSUS_DEFAULT_EXPECTED,
                     "census_sha256": smoke.CENSUS_DEFAULT_SHA256,
                     "traced": smoke.TRACED_EXPECTED,
                     "traced_sha256": smoke.TRACED_SHA256,
                     "streamed": smoke.STREAMED_EXPECTED,
                     "streamed_sha256": smoke.STREAMED_SHA256,
                     "compact_stats": smoke.COMPACT_STATS,
                     "compact_stats_traced": smoke.COMPACT_STATS_TRACED})
    if args.only in (None, "durable"):
        got.update(durable_pins(smoke))
        want.update({"durable": smoke.DURABLE_EXPECTED,
                     "kill_recover": smoke.KILL_RECOVER_EXPECTED,
                     "traced_recover": smoke.TRACED_RECOVER_EXPECTED,
                     "chaos_soak": smoke.CHAOS_SOAK_EXPECTED})
    if args.only in (None, "train"):
        got.update(train_pins(smoke))
        want.update({"train": smoke.TRAIN_PINS})
    if args.only in (None, "hooks"):
        got.update(hooks_pins(smoke))
        want.update({"hooks": smoke.HOOK_CENSUS})
    if args.only in (None, "dryrun"):
        got.update(dryrun_pins(smoke))
        want.update({"dryrun_dot_flops": smoke.DRYRUN_DOT_FLOPS})
    if args.only in (None, "server"):
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
