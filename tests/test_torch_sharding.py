"""The port's fleet lane sharding against the JAX package, on the CPU.

Under test: ``repro_torch.parallel.sharding`` (``fleet_mesh``,
``lane_sharding``, ``fleet_divisor``, ``shard_fleet``) and the
``shard=True`` paths of the fleet drivers (``run_fleet_prepared``, the
compacted driver with its per-shard ladder), the fleet server and the
durable server's records.  The JAX package runs on one CPU device here,
where its ``shard=True`` is the unsharded run; the port's device list
(``sharding.fleet_devices``) is patched to two ``"cpu"`` entries, which
drives the real split: every slice a copy, the slices run in lockstep
(one chunk on each, then one liveness test over all lanes) and written
back.  Tolerance: exact, on every ``MachineState`` and ``TraceState``
leaf, the compaction ledger and the server's results and stats.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_fleet_prepared as jrun_fleet_prepared
from repro.serve.fleet_server import FleetServer as JFleetServer

from repro_torch.core import (HALT_EXIT, HookConfig, Mechanism, fleet,
                              pack_fleet, precompile_compact, prepare,
                              programs, run_fleet_prepared)
from repro_torch.kernels.megastep import ops as mops
from repro_torch.parallel import sharding
from repro_torch.serve import durability as D
from repro_torch.serve.fleet_server import FleetServer

FUEL = 150_000


@pytest.fixture
def two_devices(monkeypatch):
    """Two "cpu" entries as the device list, and a count of the parts and
    chunks of every lockstep run."""
    monkeypatch.setattr(sharding, "fleet_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    seen = {"parts": [], "chunks": 0}
    lockstep, chunk = mops.lockstep, mops._chunk

    def counted_lockstep(parts, **kw):
        seen["parts"].append(len(parts))
        return lockstep(parts, **kw)

    def counted_chunk(*a, **kw):
        seen["chunks"] += 1
        return chunk(*a, **kw)

    monkeypatch.setattr(mops, "lockstep", counted_lockstep)
    monkeypatch.setattr(mops, "_chunk", counted_chunk)
    return seen


def _processes(pkg, cfg=None):
    """Eight lanes, tail-heavy (14 to 287 steps): getpid and read loops
    under four mechanisms and a guest-kernel lane
    (tests/test_torch_compaction.py's fleet)."""
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    prep = prepare if pkg == "torch" else jprepare
    cfg = cfg or (HookConfig() if pkg == "torch" else JHookConfig())
    cells = [prep(P.getpid_loop_param(), M.ASC, virtualize=True, cfg=cfg),
             prep(P.read_loop_param(256), M.SIGNAL, virtualize=True,
                  cfg=cfg),
             prep(P.getpid_loop_param(), M.NONE, cfg=cfg),
             prep(P.file_churn_param(64), M.LD_PRELOAD, virtualize=True,
                  cfg=cfg)]
    pick = [2, 0, 2, 3, 1, 2, 3, 2]
    iters = [1, 1, 2, 1, 1, 6, 3, 40]
    return [cells[i] for i in pick], [{19: n} for n in iters]


def _equal(want, got, what):
    for f in got._fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)


def test_lane_sharding_helpers_noop_on_one_device():
    """tests/test_fleet_smoke.py:95-113: on one device the partitioning
    path is a transparent no-op, and run_fleet(shard=True) halts."""
    pps = [prepare(programs.getpid_loop(3), Mechanism.NONE)
           for _ in range(2)]
    imgs, ids, states = pack_fleet(pps, device="cpu")
    mesh = sharding.fleet_mesh(["cpu"])
    assert sharding.lane_sharding(mesh).spec[0] == "lanes"
    assert mesh.axis_names == (sharding.LANE_AXIS,)
    out = sharding.shard_fleet(imgs, ids, states, mesh)
    assert all(a is b for a, b in zip(out, (imgs, ids, states)))
    res = fleet.run_fleet(out[0], out[2], out[1], chunk=4, device="cpu")
    assert res.halted.tolist() == [HALT_EXIT, HALT_EXIT]
    pps = [prepare(programs.getpid_loop(2), Mechanism.NONE)
           for _ in range(2)]
    res = run_fleet_prepared(pps, fuel=50_000, shard=True, device="cpu")
    assert res.halted.tolist() == [HALT_EXIT, HALT_EXIT]
    assert sharding.fleet_devices("cpu") == [torch.device("cpu")]


def test_shard_fleet_splits_lanes_and_copies_images(two_devices):
    pps, regs = _processes("torch")
    imgs, ids, states, tr = pack_fleet(pps[:4], fuel=FUEL, regs=regs[:4],
                                       trace=True, device="cpu")
    mesh = sharding.fleet_mesh()
    assert mesh.size == 2 and sharding.fleet_divisor(4, mesh) == 2
    assert sharding.fleet_divisor(3, mesh) == 1
    assert sharding.lane_sharding(mesh, 2).spec == ("lanes", None, None)
    pi, pids, ps, pt = sharding.shard_fleet(imgs, ids, states, mesh,
                                            trace=tr)
    for parts in (pi, pids, ps, pt):
        assert isinstance(parts, sharding.Shards) and len(parts) == 2
    for i in range(2):
        assert all(torch.equal(a, b) for a, b in zip(pi[i], imgs))
        assert pi[i].packed.data_ptr() != imgs.packed.data_ptr()
        assert torch.equal(pids[i], ids[2 * i:2 * i + 2])
        for whole, part in ((states, ps[i]), (tr, pt[i])):
            assert type(part) is type(whole)
            for a, b in zip(whole, part):
                assert torch.equal(a[2 * i:2 * i + 2], b)
                assert a.data_ptr() != b.data_ptr()
    # three lanes on two devices: the run goes whole
    out = sharding.shard_fleet(imgs, ids[:3], fleet.MachineState(
        *(x[:3] for x in states)), mesh)
    assert isinstance(out[2], fleet.MachineState)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's shard=True runs (one device: unsharded): traced
    (its states are the untraced run's: tracing is invisible to the
    machine), and compacted traced with its ledger (min bucket 2)."""
    jpps, regs = _processes("jax")
    traced = jrun_fleet_prepared(jpps, fuel=FUEL, chunk=4, regs=regs,
                                 shard=True, trace=True)
    stats = {}
    cpps, _ = _processes("jax", JHookConfig(compact_enabled=True,
                                            compact_min_bucket=2))
    compact = jrun_fleet_prepared(cpps, fuel=FUEL, chunk=4, regs=regs,
                                  shard=True, trace=True,
                                  compact_stats=stats)
    return {"traced": traced, "compact": (compact, stats)}


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_run_fleet_prepared_sharded_equals_jax(two_devices, jax_runs,
                                               traced):
    """Two slices in lockstep: every leaf the JAX run's and the unsharded
    port's, and the chunks of the unsharded run on each slice."""
    pps, regs = _processes("torch")
    kw = dict(fuel=FUEL, chunk=4, regs=regs, device="cpu")
    whole = run_fleet_prepared(pps, trace=traced, **kw)
    whole_chunks = two_devices["chunks"]
    got = run_fleet_prepared(pps, trace=traced, shard=True, **kw)
    assert two_devices["parts"] == [1, 2]
    assert two_devices["chunks"] - whole_chunks == 2 * whole_chunks
    want = jax_runs["traced"]
    if traced:
        _equal(want[0], got[0], "states")
        _equal(want[1], got[1], "trace")
        _equal(whole[1], got[1], "trace vs unsharded")
        got, whole = got[0], whole[0]
    else:
        _equal(want[0], got, "states")
    _equal(whole, got, "states vs unsharded")


def test_compacted_sharded_equals_jax(two_devices, jax_runs):
    """The compacted driver with a per-shard ladder ([8, 4, 2], every rung
    even): states, carry and ledger the JAX run's; every span split."""
    want, want_stats = jax_runs["compact"]
    pps, regs = _processes("torch", HookConfig(compact_enabled=True,
                                               compact_min_bucket=2))
    stats = {}
    got = run_fleet_prepared(pps, fuel=FUEL, chunk=4, regs=regs, trace=True,
                             shard=True, compact_stats=stats, device="cpu")
    _equal(want[0], got[0], "compacted states")
    _equal(want[1], got[1], "compacted carry")
    assert stats == want_stats and stats["compactions"]
    assert set(two_devices["parts"]) == {2}
    assert precompile_compact(pps, shard=True, device="cpu") == [8, 4, 2]
    assert precompile_compact(pps[:7], shard=True, device="cpu") == [7, 4, 2]
    assert fleet.compact_ladder(6, 1, divisor=2) == [6, 4, 2]


def test_pallas_engine_with_shard_raises_value_error():
    pps, regs = _processes("torch")
    for call in (
            lambda: run_fleet_prepared(pps, shard=True, engine="pallas",
                                       device="cpu"),
            lambda: run_fleet_prepared(pps, shard=True, engine="pallas",
                                       compact=True, device="cpu"),
            lambda: fleet.precompile_ladder([pps[0].decoded], [8],
                                            shard=True, engine="pallas",
                                            device="cpu"),
            lambda: FleetServer(pool=2, shard=True, engine="pallas",
                                device="cpu")):
        with pytest.raises(ValueError, match="does not compose with shard"):
            call()


ITERS = [1, 4, 2, 3, 1]


def _serve(srv, pkg):
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    prep = prepare if pkg == "torch" else jprepare
    for i, n in enumerate(ITERS):
        srv.submit(prep(P.getpid_loop_param(), M.ASC, virtualize=True),
                   regs={19: n}, fuel=FUEL)
        if i % 2:
            srv.step()
    return srv.run(max_generations=400)


def _view(results):
    return [(r.rid, r.attempts, r.completed_gen,
             [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in r.state],
             [dataclasses.astuple(x) for x in r.trace])
            for r in results]


def _same(want, got):
    assert len(want) == len(got)
    for a, b in zip(_view(want), _view(got)):
        assert a[:3] == b[:3] and a[4] == b[4]
        for x, y in zip(a[3], b[3]):
            assert np.array_equal(x, y), a[0]


def test_fleet_server_sharded_equals_jax(two_devices):
    """A traced, compacted pool of 4 split in two: results, records and
    stats the JAX server's (shard=True, one device); every generation's
    span through two slices."""
    kw = dict(pool=4, gen_steps=24, chunk=4, trace=True, compact=True)
    jsrv = JFleetServer(cfg=JHookConfig(compact_min_bucket=2), shard=True,
                        **kw)
    want = _serve(jsrv, "jax")
    srv = FleetServer(cfg=HookConfig(compact_min_bucket=2), shard=True,
                      device="cpu", **kw)
    assert srv._ladder == [4, 2] and srv._mesh.size == 2
    got = _serve(srv, "torch")
    _same(want, got)
    clock = {k for k in srv.stats() if k.endswith("_ms_mean")
             or k.endswith("_ms_max")}
    assert ({k: v for k, v in srv.stats().items() if k not in clock}
            == {k: v for k, v in jsrv.stats().items() if k not in clock})
    assert srv.pool_shrinks > 0
    assert two_devices["parts"] and set(two_devices["parts"]) == {2}


def test_durable_server_records_shard_and_recovers_with_it(two_devices,
                                                           tmp_path):
    """The journal's ``open`` record says shard: true; the recovered
    server is sharded, and every result equals the unsharded fleet run's
    lane."""
    pp = prepare(programs.getpid_loop_param(), Mechanism.ASC,
                 virtualize=True)
    want = run_fleet_prepared([pp] * len(ITERS), fuel=FUEL,
                              regs=[{19: n} for n in ITERS], device="cpu")
    cfg = HookConfig(snapshot_interval=2, journal_fsync=False)
    vic = FleetServer(pool=2, cfg=cfg, gen_steps=24, chunk=4, shard=True,
                      durability=D.DurabilityManager(tmp_path / "d"),
                      device="cpu")
    for n in ITERS:
        vic.submit(pp, regs={19: n}, fuel=FUEL)
    pre = [r for _ in range(3) for r in vic.step()]
    del vic
    recs, _ = D.Journal.replay(tmp_path / "d" / "journal.jsonl")
    assert recs[0]["kind"] == "open" and recs[0]["server"]["shard"] is True
    srv, replayed = FleetServer.recover(tmp_path / "d", device="cpu")
    assert srv._shard and srv._mesh.size == 2
    union = {r.rid: r for r in pre + replayed + srv.run(400)}
    assert sorted(union) == list(range(len(ITERS)))
    for rid, r in union.items():
        for f, a, b in zip(want._fields, want, r.state):
            assert torch.equal(a[rid], b), (rid, f)
