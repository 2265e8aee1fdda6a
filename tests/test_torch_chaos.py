"""The port's chaos harness against the JAX package's, on the CPU.

Under test: ``repro_torch.serve.chaos.ChaosMonkey`` on the port's durable
``FleetServer`` — dispatch faults and hangs retried with backoff, queues
load-shed when retries run out, snapshot corruption rewritten, carry
bit-flips (in place, in the live carry) caught by the replay-verify pass
and rolled back with the tenant quarantined.  Every case runs the same
requests through the JAX server with the same chaos and holds the port to
it: published results, the chaos counters of ``stats()`` and the
injection ledger (kind, generation, lane, word, bit, offset, resolution).

The configs are tests/test_durability.py's ``_chaos_cfg``; the programs
are shorter (the port runs its plain megastep step here, a few ms a
step), with the builders registered under the same names in both
packages.  tests/test_obs.py's recovery cases (counters monotone and
spans complete across a crash) are here too, to share the durable
tests' time between two test workers.
"""
import types

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_prepared as jrun_prepared
from repro.sched import PolicyScheduler as JPolicyScheduler
from repro.serve import chaos as JC
from repro.serve import durability as JD
from repro.serve.fleet_server import FleetServer as JFleetServer

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import HookConfig, Mechanism, prepare, programs
from repro_torch.sched import PolicyScheduler, TenantBudget
from repro_torch.serve import chaos as C
from repro_torch.serve import durability as D
from repro_torch.serve.fleet_server import FleetServer
from test_durability import _result_key

FUEL = 25_000

JAX = types.SimpleNamespace(
    name="jax", FleetServer=JFleetServer, PolicyScheduler=JPolicyScheduler,
    HookConfig=JHookConfig, programs=jprograms, Mechanism=JMechanism, D=JD,
    C=JC, CheckpointManager=JCheckpointManager, prepare=jprepare, kw={})
PORT = types.SimpleNamespace(
    name="torch", FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    HookConfig=HookConfig, programs=programs, Mechanism=Mechanism, D=D, C=C,
    CheckpointManager=CheckpointManager, prepare=prepare,
    kw={"device": "cpu"})

for _pkg in (JAX, PORT):
    for _name, _fn in (
            ("tdur-mixed", lambda P=_pkg.programs: P.mixed_ops(3, 32)),
            ("tdur-mixed2", lambda P=_pkg.programs: P.mixed_ops(2, 16)),
            ("tdur-soak", lambda P=_pkg.programs: P.getpid_loop(20))):
        if _name not in _pkg.D.BUILDERS:
            _pkg.D.register_builder(_name, _fn)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's plain step on a few lanes is op overhead: one intra-op
    thread runs it fastest and leaves the other cores to other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _chaos_cfg(pkg, **kw):
    """tests/test_durability.py's ``_chaos_cfg``."""
    base = dict(trace_enabled=True, snapshot_interval=3,
                journal_fsync=False, chaos_max_retries=2,
                chaos_backoff_base_ms=0)
    base.update(kw)
    return pkg.HookConfig(**base)


def _drained(srv) -> bool:
    return (not srv._queue and not srv._readmit
            and all(r is None for r in srv._slots))


def _feed(pkg, srv, tenant=None):
    kw = {} if tenant is None else {"tenant": tenant}
    srv.submit(pkg.programs.getpid_loop_param, regs={19: 3}, fuel=FUEL,
               **kw)
    srv.submit(pkg.D.BUILDERS["tdur-mixed2"], fuel=FUEL, **kw)


CHAOS_STATS = ("retries", "rollbacks", "shed_requests", "shed",
               "recovery_generations", "watchdog_trips", "snapshots",
               "snapshot_rewrites", "generations", "dispatches",
               "idle_generations", "completed")


def _both(tmp_path, build, feed, *, dedup=False):
    """``build(pkg, directory)`` -> a server, fed by ``feed(pkg, srv)`` and
    drained, in each package: {pkg name: (server, results)}.  The two
    runs must publish the same results, counters and injection ledger."""
    out = {}
    for pkg in (JAX, PORT):
        srv = build(pkg, tmp_path / pkg.name)
        feed(pkg, srv)
        res = srv.run(5000)
        if dedup:                           # a rollback re-emits
            res = list({r.rid: r for r in res}.values())
        out[pkg.name] = (srv, res)
    (js, jr), (ts, tr) = out["jax"], out["torch"]
    assert sorted(map(_result_key, tr)) == sorted(map(_result_key, jr))
    jst, tst = js.stats(), ts.stats()
    for k in CHAOS_STATS:
        assert tst[k] == jst[k], k
    assert tst["chaos"] == jst["chaos"]
    assert ts._chaos.injections == js._chaos.injections
    return out


def _plain(feed):
    """The same requests on a plain JAX server (no durability, no chaos):
    what the chaos runs must publish."""
    srv = JFleetServer(2, cfg=_chaos_cfg(JAX), gen_steps=48, fuel=FUEL)
    feed(JAX, srv)
    return sorted(map(_result_key, srv.run(5000)))


def test_chaos_dispatch_fault_retried(tmp_path):
    out = _both(tmp_path, lambda pkg, d: pkg.FleetServer(
        2, cfg=_chaos_cfg(pkg), gen_steps=48, fuel=FUEL,
        durability=pkg.D.DurabilityManager(d),
        chaos=pkg.C.ChaosMonkey(plan={1: ["dispatch"]}), **pkg.kw), _feed)
    srv, res = out["torch"]
    assert sorted(map(_result_key, res)) == _plain(_feed)
    st_ = srv.stats()
    assert st_["retries"] >= 1 and st_["shed_requests"] == 0
    assert srv._chaos.summary()["by_resolution"].get("retried", 0) >= 1
    assert not srv._chaos.unresolved()


def test_chaos_watchdog_hang_retried(tmp_path):
    out = _both(tmp_path, lambda pkg, d: pkg.FleetServer(
        2, cfg=_chaos_cfg(pkg, serve_watchdog_s=0.001), gen_steps=48,
        fuel=FUEL, durability=pkg.D.DurabilityManager(d),
        chaos=pkg.C.ChaosMonkey(plan={1: ["hang"]}), **pkg.kw),
        lambda pkg, srv: srv.submit(pkg.programs.getpid_loop_param,
                                    regs={19: 3}, fuel=FUEL))
    srv, _ = out["torch"]
    assert srv.stats()["watchdog_trips"] >= 1
    assert srv._chaos.injections[0]["stall_s"] == 0.00125
    assert not srv._chaos.unresolved()


def test_chaos_retries_exhausted_sheds_queue(tmp_path):
    def feed(pkg, srv):
        for _ in range(5):                  # more than the pool: a queue
            srv.submit(pkg.programs.getpid_loop_param, regs={19: 3},
                       fuel=FUEL)
    out = _both(tmp_path, lambda pkg, d: pkg.FleetServer(
        2, cfg=_chaos_cfg(pkg, chaos_max_retries=1), gen_steps=48,
        fuel=FUEL, durability=pkg.D.DurabilityManager(d),
        chaos=pkg.C.ChaosMonkey(plan={1: ["dispatch", "dispatch"]}),
        **pkg.kw), feed)
    srv, res = out["torch"]
    st_ = srv.stats()
    assert st_["shed_requests"] >= 1
    for entry in st_["shed"]:
        assert "retries_exhausted" in entry["reason"]
    shed_rids = {e["rid"] for e in st_["shed"]}
    done_rids = {r.rid for r in res}
    assert shed_rids | done_rids == set(range(5))
    assert shed_rids.isdisjoint(done_rids)
    assert st_["tenants"][""]["shed"] == len(shed_rids)
    assert srv._chaos.summary()["by_resolution"].get("shed", 0) >= 1
    assert not srv._chaos.unresolved()
    # the shed is journaled: the journal's shed records name the same rids
    recs, _ = D.Journal.replay(tmp_path / "torch" / "journal.jsonl")
    assert {r["rid"] for r in recs if r["kind"] == "shed"} == shed_rids


def test_chaos_bitflip_rolled_back_and_quarantined(tmp_path):
    out = _both(tmp_path, lambda pkg, d: pkg.FleetServer(
        2, cfg=_chaos_cfg(pkg, snapshot_interval=2), gen_steps=48,
        fuel=FUEL, scheduler=pkg.PolicyScheduler(),
        durability=pkg.D.DurabilityManager(d),
        chaos=pkg.C.ChaosMonkey(plan={2: ["bitflip"]}), **pkg.kw),
        lambda pkg, srv: _feed(pkg, srv, tenant="t"), dedup=True)
    srv, res = out["torch"]
    assert sorted(map(_result_key, res)) == _plain(
        lambda pkg, s: _feed(pkg, s, tenant="t"))
    st_ = srv.stats()
    assert st_["rollbacks"] >= 1
    assert st_["recovery_generations"] >= 1
    assert any(ev["reason"] == "carry_corruption"
               for ev in srv.sched.quarantine.events), \
        srv.sched.quarantine.events
    assert srv._chaos.summary()["by_resolution"].get("rolled_back", 0) >= 1
    assert not srv._chaos.unresolved()
    # the adopted replica ran on: its carry is the server's own, on its
    # device, and the next spans ran it
    assert srv._states.pc.device.type == "cpu"


def test_chaos_snapshot_corruption_rewritten(tmp_path):
    out = _both(tmp_path, lambda pkg, d: pkg.FleetServer(
        2, cfg=_chaos_cfg(pkg, snapshot_interval=2), gen_steps=48,
        fuel=FUEL, durability=pkg.D.DurabilityManager(d),
        chaos=pkg.C.ChaosMonkey(seed=3, plan={2: ["corrupt"]}), **pkg.kw),
        _feed)
    srv, _ = out["torch"]
    summ = srv._chaos.summary()
    assert summ["by_kind"].get("corrupt", 0) >= 1
    assert not srv._chaos.unresolved()
    mgr = CheckpointManager(tmp_path / "torch" / "snapshots", keep=10 ** 9)
    for p in sorted((tmp_path / "torch" / "snapshots").glob("step_*")):
        mgr.load_step(p)


def test_chaos_requires_durability_for_bitflips():
    with pytest.raises(ValueError, match="durability"):
        FleetServer(2, cfg=_chaos_cfg(PORT, chaos_bitflip_rate=0.5),
                    gen_steps=48, fuel=FUEL, chaos=C.ChaosMonkey(),
                    device="cpu")
    with pytest.raises(ValueError, match="durability"):
        FleetServer(2, cfg=_chaos_cfg(PORT), gen_steps=48, fuel=FUEL,
                    chaos=C.ChaosMonkey(plan={3: ["corrupt"]}),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown chaos kind"):
        C.ChaosMonkey(plan={1: ["meteor"]})


def test_chaos_injections_and_resolutions_counted():
    """tests/test_obs.py's case: the observed server counts injections by
    kind and resolutions by outcome, and prices the backoff sleep."""
    srv = FleetServer(1, gen_steps=48, fuel=FUEL, device="cpu",
                      cfg=HookConfig(obs_enabled=True, chaos_max_retries=2),
                      chaos=C.ChaosMonkey(plan={1: ["dispatch"]}))
    srv.submit(prepare(programs.getpid_loop_param(), Mechanism.ASC,
                       virtualize=True), regs={19: 4}, tenant="t")
    srv.run(5000)
    m = srv.metrics()
    assert m["counters"]["chaos_injections_total"][
        '{kind="dispatch"}'] == 1
    assert m["counters"]["chaos_resolutions_total"][
        '{outcome="retried"}'] == 1
    assert srv._chaos.unresolved() == []
    assert m["phases"]["retry_backoff"]["count"] >= 1


class _BrokenLaunch(RuntimeError):
    pass


def test_a_real_error_is_never_chaos(tmp_path, monkeypatch):
    """A failure of the launch itself carries no chaos kind: it is raised,
    not retried, not counted, and the carry is not run another way."""
    srv = FleetServer(2, cfg=_chaos_cfg(PORT, chaos_dispatch_fault_rate=0.0),
                      gen_steps=48, fuel=FUEL, device="cpu",
                      durability=D.DurabilityManager(tmp_path / "d"),
                      chaos=C.ChaosMonkey())
    _feed(PORT, srv)

    def broken(ids):
        raise _BrokenLaunch("the kernel did not launch")

    monkeypatch.setattr(srv, "_dispatch", broken)
    with pytest.raises(_BrokenLaunch):
        srv.step()
    st_ = srv.stats()
    assert st_["retries"] == 0 and st_["shed_requests"] == 0
    assert st_["chaos"]["injections"] == 0


# -- observability across a crash (a durability case, kept in this file
#    to balance the two files' time over the test workers) -----------

def _mk_observed(directory, obs=True):
    cfg = HookConfig(trace_enabled=True, compact_enabled=True,
                     snapshot_interval=3, journal_fsync=False,
                     obs_enabled=obs)
    return FleetServer(4, cfg=cfg, gen_steps=48, fuel=FUEL, device="cpu",
                       scheduler=PolicyScheduler(
                           budgets={"b": TenantBudget(max_svc=40)}),
                       durability=D.DurabilityManager(directory))


def _obs_feed(srv):
    for _ in range(3):
        srv.submit(programs.getpid_loop_param, mechanism=Mechanism.ASC,
                   virtualize=True, fuel=FUEL, regs={19: 3}, tenant="a",
                   priority=1)
        srv.submit(D.BUILDERS["tdur-mixed2"], mechanism=Mechanism.ASC,
                   virtualize=True, fuel=FUEL, tenant="b")


@pytest.mark.parametrize("kill_gen", [2, 5, 7])
def test_recovery_is_monotone_and_span_complete(tmp_path, kill_gen):
    """tests/test_obs.py's case: after a kill at ``kill_gen`` the recovered
    server's counters, phase counts and generation count never sit below
    what a scraper read from the dead server, and every span completes."""
    vic = _mk_observed(tmp_path / "vic")
    _obs_feed(vic)
    for _ in range(kill_gen):
        vic.step()
    assert not _drained(vic)
    pre_counters = vic._obs.registry.counter_watermark()
    pre_phase_counts = dict(vic._obs.profiler.counts)
    pre_gen_count = vic._obs.profiler.gen_count
    pre_span_events = dict(vic._obs.spans.summary()["events"])
    del vic

    srv, _ = FleetServer.recover(tmp_path / "vic", device="cpu")
    hub = srv._obs
    assert hub is not None, "obs_enabled lost across recovery"
    assert hub.profiler.gen_count >= pre_gen_count
    for name, v in pre_phase_counts.items():
        assert hub.profiler.counts.get(name, 0) >= v, name
    post_counters = hub.registry.counter_watermark()
    for series, v in pre_counters.items():
        assert post_counters.get(series, 0) >= v, series
    post_events = hub.spans.summary()["events"]
    for ev, v in pre_span_events.items():
        assert post_events.get(ev, 0) >= v, ev

    srv.run(5000)
    m = srv.metrics()
    assert m["spans"]["open"] == 0, "a span never completed"
    assert m["spans"]["completed"] >= 6
    assert m["counters"]["requests_completed_total"]['{tenant="a"}'] >= 3
    assert m["counters"]["requests_completed_total"]['{tenant="b"}'] >= 3


def test_unobserved_durable_server_recovers_unobserved(tmp_path):
    vic = _mk_observed(tmp_path / "vic", obs=False)
    _obs_feed(vic)
    for _ in range(4):
        vic.step()
    del vic
    srv, _ = FleetServer.recover(tmp_path / "vic", device="cpu")
    assert srv._obs is None
    srv.run(5000)
    assert srv.metrics() == {}


# -- the fixed-seed soak ---------------------------------------------------

SOAK = dict(snapshot_interval=3, serve_watchdog_s=0.001, chaos_seed=7,
            chaos_dispatch_fault_rate=0.12, chaos_hang_rate=0.04,
            chaos_bitflip_rate=0.35, chaos_snapshot_corrupt_rate=0.25)


def _soak(pkg, directory):
    srv = pkg.FleetServer(4, cfg=_chaos_cfg(pkg, **SOAK), gen_steps=64,
                          fuel=FUEL,
                          durability=pkg.D.DurabilityManager(directory),
                          chaos=pkg.C.ChaosMonkey(), **pkg.kw)
    rids = [srv.submit(pkg.D.BUILDERS["tdur-soak"], fuel=FUEL)
            for _ in range(6)]
    out = []
    for _ in range(600):
        if _drained(srv):
            break
        out.extend(srv.step())
    return srv, rids, {r.rid: r for r in out}


def _escaped_flip(state, solo, ledger) -> bool:
    """``state`` differs from ``solo`` by exactly one injected bit-flip of
    the ledger: one word of ``mem``, xor-ed with ``1 << bit``."""
    bad = [f for f, a, b in zip(solo._fields, solo, state)
           if not np.array_equal(np.asarray(a), b.numpy())]
    if bad != ["mem"]:
        return False
    diff = np.asarray(solo.mem) ^ state.mem.numpy()
    words = np.flatnonzero(diff)
    return len(words) == 1 and any(
        inj["kind"] == "bitflip" and inj["word"] == words[0]
        and diff[words[0]] == np.int64(1) << np.int64(inj["bit"])
        for inj in ledger)


def test_chaos_soak_matches_the_jax_ledger(tmp_path):
    """tests/test_durability.py's acceptance soak (its chaos settings, a
    shorter program).  The injection ledger — kind, generation, lane,
    word, bit, corrupted byte offset, resolution — is the JAX server's
    for the same seed, field for field, and so are the published states
    and the shed requests.

    With this program the soak also shows a fault of the reference, kept
    by the port (ROADMAP Queue 3): a lane bit-flipped after a snapshot
    that finishes before the next boundary publishes the flipped state,
    and a flip after the run's last boundary is never verified.  So the
    reference's invariants are held as far as they go: every injection
    but such a flip is resolved, and every non-shed result equals the
    solo run but for exactly one injected bit."""
    js, _, jout = _soak(JAX, tmp_path / "jax")
    srv, rids, out = _soak(PORT, tmp_path / "torch")
    summ = srv._chaos.summary()
    assert set(summ["by_kind"]) == {"dispatch", "hang", "corrupt",
                                    "bitflip"}, summ
    ledger = srv._chaos.injections
    assert ledger == js._chaos.injections
    assert all(i["kind"] == "bitflip" for i in srv._chaos.unresolved())
    shed = {e["rid"] for e in srv.shed}
    assert shed == {e["rid"] for e in js.shed}
    assert shed | set(out) >= set(rids)
    assert set(out) == set(jout)
    solo = jrun_prepared(jprepare(jprograms.getpid_loop(20), JMechanism.ASC),
                         fuel=FUEL)
    for rid in out:
        for f, a, b in zip(solo._fields, jout[rid].state, out[rid].state):
            assert np.array_equal(np.asarray(a), b.numpy()), (rid, f)
        if rid not in shed and not all(
                np.array_equal(np.asarray(a), b.numpy())
                for a, b in zip(solo, out[rid].state)):
            assert _escaped_flip(out[rid].state, solo, ledger), rid
    st_, jst = srv.stats(), js.stats()
    for k in CHAOS_STATS:
        assert st_[k] == jst[k], k


def test_flip_published_before_the_next_boundary_escapes_as_in_jax(
        tmp_path):
    """The smallest case of the reference's fault (ROADMAP Queue 3): a
    flip right after the snapshot at generation 2 lands on a lane that
    finishes before the boundary at 4, so no replay-verify compares it;
    the flipped state is published and the injection stays unresolved —
    in both packages alike."""
    def build(pkg, d):
        return pkg.FleetServer(1, cfg=_chaos_cfg(pkg, snapshot_interval=2),
                               gen_steps=48, fuel=FUEL,
                               durability=pkg.D.DurabilityManager(d),
                               chaos=pkg.C.ChaosMonkey(plan={2: ["bitflip"]}),
                               **pkg.kw)
    out = _both(tmp_path, build, lambda pkg, srv: srv.submit(
        pkg.programs.getpid_loop_param, regs={19: 1}, fuel=FUEL))
    srv, (res,) = out["torch"]
    assert res.completed_gen == 3
    (flip,) = srv._chaos.unresolved()
    assert flip["kind"] == "bitflip" and flip["gen"] == 2
    solo = jrun_prepared(jprepare(jprograms.getpid_loop_param(),
                                  JMechanism.ASC), fuel=FUEL, regs={19: 1})
    assert _escaped_flip(res.state, solo, [flip])
    assert srv.stats()["rollbacks"] == 0


def test_chip_smoke_durable_helpers_match_jax(monkeypatch, tmp_path):
    """chip_smoke.py's durable_server helpers at a small size drive both
    servers alike: the durable run's summary and publication ledger, the
    kill-and-recover counts, the traced recovery's records and the chaos
    soak's ledger summary are equal for the JAX server and the port's."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_durable", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("DUR_POOL", 2), ("FS_POOL", 2), ("FS_GEN_STEPS", 48),
                        ("CHUNK", 8), ("FUEL", FUEL), ("DUR_INTERVAL", 2),
                        ("DUR_KILL", 3), ("TRACED_KILL", 3)):
        monkeypatch.setattr(smoke, name, value)
    got = {}
    for pkg, ns in ((JAX, types.SimpleNamespace(
            FleetServer=JFleetServer, HookConfig=JHookConfig,
            DurabilityManager=JD.DurabilityManager,
            ChaosMonkey=JC.ChaosMonkey)), (PORT, smoke.PORT)):
        kw = pkg.kw
        P, M = pkg.programs, pkg.Mechanism
        pps = [pkg.prepare(P.getpid_loop_param(), M.ASC, virtualize=True),
               pkg.prepare(P.read_loop_param(), M.SIGNAL, virtualize=True),
               pkg.prepare(P.mixed_ops_param(), M.NONE)]
        regs = [{19: 3}, {19: 2}, {19: 2}]
        d = tmp_path / pkg.name
        srv, res, _ = smoke.durable_census(ns, pps, regs, d / "durable",
                                           **kw)
        out = {"durable": smoke.durable_summary(srv, res)}

        def make():
            s = ns.FleetServer(pool=2, gen_steps=48, chunk=8, fuel=FUEL,
                               cfg=ns.HookConfig(snapshot_interval=2),
                               durability=ns.DurabilityManager(d / "victim"),
                               **kw)
            for pp, rg in zip(pps, regs):
                s.submit(pp, regs=rg)
            return s
        _, union, counts, _, _ = smoke.kill_and_recover(
            ns, make, d / "victim", 3, **kw)
        out["kill_recover"] = (counts, smoke.publication_ledger(
            union.values()))
        srv, union, counts, _, before = smoke.kill_and_recover(
            ns, lambda: smoke.census_server(
                ns, pps, regs, trace=True, stream=True, compact=True,
                obs=True, durability=ns.DurabilityManager(d / "traced"),
                **kw), d / "traced", 3, watch=smoke.obs_watermark, **kw)
        assert not smoke.not_below(smoke.obs_watermark(srv), before)
        out["traced_recover"] = (counts,
                                 smoke.records_digest(union.values()))
        srv, _ = smoke.chaos_census(ns, pps, regs, d / "soak", **kw)
        out["chaos_soak"] = smoke.soak_summary(srv)
        got[pkg.name] = out
    assert got["jax"] == got["torch"]
    assert got["torch"]["durable"]["snapshots"] >= 1
