"""The port's continuous-batching fleet server against the JAX package's,
on the CPU.

Under test: ``repro_torch.serve.fleet_server.FleetServer`` — admission,
harvest, the image table, fleet-native C3, tracing and policies, the
streamed trace pipeline, live-lane compaction, the policy scheduler
(preemption, deny-rate and budget evictions, quarantine, live
``update_policy``) and the observed server.  The same requests (prepared
processes, entry registers made from a seed, policies) go through the
JAX server and the port's server on CPU tensors; every published
``FleetResult`` (rid, all 34 state leaves, halt code, attempts, C3
events, decoded trace records, histograms, the publication ledger) and
``stats()`` without its wall-clock keys must be equal, bit for bit.

The port's carry is updated in place, so a published state and a
preemption checkpoint are copies: the regression tests below show that
neither changes while the server runs on.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
from _hyp_compat import HAVE_HYPOTHESIS, given, settings, st

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import layout as JL
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.sched import PolicyScheduler as JPolicyScheduler
from repro.sched import TenantBudget as JTenantBudget
from repro.serve.fleet_server import FleetServer as JFleetServer
from repro.trace import policy as jpolicy

from repro_torch.core import (HookConfig, Mechanism, fleet, layout as L,
                              prepare, programs, run_prepared)
from repro_torch.sched import PolicyScheduler, TenantBudget
from repro_torch.serve.fleet_server import FleetServer
from repro_torch.trace import policy as tpolicy

FUEL = 150_000
MAX_EXAMPLES = int(os.environ.get("ASC_TEST_EXAMPLES", "5"))

_SETTINGS = dict(max_examples=MAX_EXAMPLES, deadline=None, derandomize=True)
if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck
    _SETTINGS["suppress_health_check"] = list(HealthCheck)

JAX = types.SimpleNamespace(
    name="jax", FleetServer=JFleetServer, PolicyScheduler=JPolicyScheduler,
    TenantBudget=JTenantBudget, HookConfig=JHookConfig, prepare=jprepare,
    programs=jprograms, Mechanism=JMechanism, policy=jpolicy, L=JL, kw={})
PORT = types.SimpleNamespace(
    name="torch", FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    TenantBudget=TenantBudget, HookConfig=HookConfig, prepare=prepare,
    programs=programs, Mechanism=Mechanism, policy=tpolicy, L=L,
    kw={"device": "cpu"})

WORKLOADS = {
    "getpid": lambda P: P.getpid_loop_param(),
    "read": lambda P: P.read_loop_param(256),
    "storm": lambda P: P.syscall_storm_param(),
}
MECHS = ["NONE", "LD_PRELOAD", "ASC", "SIGNAL", "PTRACE"]
# wall-clock keys of stats(): the only ones allowed to differ
CLOCK_KEYS = {"admission_wait_ms_mean", "admission_wait_ms_max",
              "resume_wait_ms_mean", "resume_wait_ms_max"}

_pp_cache = {}


def _pp(pkg, wname, mech="ASC"):
    key = (pkg.name, wname, mech)
    if key not in _pp_cache:
        m = getattr(pkg.Mechanism, mech)
        _pp_cache[key] = pkg.prepare(WORKLOADS[wname](pkg.programs), m,
                                     virtualize=mech != "NONE")
    return _pp_cache[key]


def _storm(n, burst, burn):
    return {19: n, 20: burst, 21: burn}


def _server(pkg, **kw):
    """A server of ``pkg``; one generation shape (40 steps in chunks of 8)
    unless a case needs another, so the JAX side compiles each pool width
    once."""
    kw.setdefault("fuel", FUEL)
    kw.setdefault("gen_steps", 40)
    kw.setdefault("chunk", 8)
    return pkg.FleetServer(**kw, **pkg.kw)


def _result_view(r):
    """Everything a FleetResult publishes, as plain host values."""
    return {
        "rid": r.rid,
        "state": {f: np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x) for f, x in zip(r.state._fields,
                                                        r.state)},
        "events": [dataclasses.asdict(e) for e in r.events],
        "attempts": r.attempts, "submitted_gen": r.submitted_gen,
        "admitted_gen": r.admitted_gen, "completed_gen": r.completed_gen,
        "admission_wait_gens": r.admission_wait_gens,
        "trace": [dataclasses.astuple(x) for x in r.trace],
        "trace_dropped": r.trace_dropped, "histogram": r.histogram,
        "tenant": r.tenant, "preemptions": r.preemptions}


def _same_results(jres, tres):
    """Results (in publication order) equal field for field, leaf for
    leaf."""
    assert [r.rid for r in jres] == [r.rid for r in tres]
    for a, b in zip(jres, tres):
        va, vb = _result_view(a), _result_view(b)
        sa, sb = va.pop("state"), vb.pop("state")
        assert va == vb, (va, vb)
        for f in sa:
            assert sa[f].dtype == sb[f].dtype, (a.rid, f)
            assert np.array_equal(sa[f], sb[f]), (a.rid, f)


def _same_stats(js, ts):
    assert set(js) == set(ts)
    bad = {k: (js[k], ts[k]) for k in js
           if k not in CLOCK_KEYS and js[k] != ts[k]}
    assert not bad, bad


def _both(scenario):
    """Run ``scenario(pkg) -> (server, results)`` on both packages and
    hold every published result and the stats equal.  Returns the port's
    (server, results)."""
    jsrv, jres = scenario(JAX)
    tsrv, tres = scenario(PORT)
    _same_results(jres, tres)
    _same_stats(jsrv.stats(), tsrv.stats())
    return tsrv, tres


def _run(srv):
    return srv, srv.run(max_generations=20000)


# -- the cases of tests/test_fleet_server.py ----------------------------------

@settings(**_SETTINGS)
@given(data=st.data())
def test_any_arrival_order_matches_jax(data):
    """programs x mechanisms x pool sizes x arrival order: the port's
    published results equal the JAX server's."""
    pool = data.draw(st.integers(1, 3), label="pool")
    n_reqs = data.draw(st.integers(1, 3), label="n_reqs")
    reqs = [(data.draw(st.sampled_from(["getpid", "read"]), label="w"),
             data.draw(st.sampled_from(MECHS), label="m"),
             data.draw(st.integers(1, 3), label="n"))
            for _ in range(n_reqs)]

    def scenario(pkg):
        srv = _server(pkg, pool=pool)
        for w, m, n in reqs:
            srv.submit(_pp(pkg, w, m), regs={19: n})
        return _run(srv)

    srv, _ = _both(scenario)
    assert srv.stats()["scalar_reexecutions"] == 0


def test_mid_flight_submission_matches_jax():
    def scenario(pkg):
        srv = _server(pkg, pool=2)
        srv.submit(_pp(pkg, "getpid"), regs={19: 3})
        out = srv.step()
        srv.submit(_pp(pkg, "read", "SIGNAL"), regs={19: 2})  # mid-flight
        return srv, out + srv.run()

    _both(scenario)


def test_fuel_exhaustion_published_as_halt_fuel():
    def scenario(pkg):
        srv = _server(pkg, pool=2, fuel=150)
        srv.submit(_pp(pkg, "getpid"), regs={19: 100_000})
        return _run(srv)

    _, res = _both(scenario)
    assert int(res[0].state.halted) == 4   # HALT_FUEL, patched at harvest


def test_admission_waits_out_a_full_table():
    def scenario(pkg):
        srv = _server(pkg, pool=2, table_capacity=1)
        for w, m, n in [("getpid", "ASC", 2), ("read", "SIGNAL", 1),
                        ("getpid", "ASC", 3)]:
            srv.submit(_pp(pkg, w, m), regs={19: n})
        return _run(srv)

    srv, res = _both(scenario)
    assert len(res) == 3 and srv.table.live_rows() == 0


def test_image_table_dedups_and_recycles_rows():
    def scenario(pkg):
        srv = _server(pkg, pool=2, table_capacity=3)
        for n in (1, 2, 3):
            srv.submit(_pp(pkg, "getpid"), regs={19: n})
        out = srv.run()
        for n in (1, 2):
            srv.submit(_pp(pkg, "read", "SIGNAL"), regs={19: n})
        return srv, out + srv.run()

    srv, _ = _both(scenario)
    assert srv.table.admissions == 2 and srv.table.dedup_hits == 3


def test_c3_workload_matches_jax_and_run_with_c3():
    """The trap -> pin -> re-admit cycle stays in the fleet: events,
    attempts and the final state equal the JAX server's and the port's
    ``run_with_c3``; a bystander lane is undisturbed."""
    from repro_torch.core import run_with_c3

    def scenario(pkg):
        srv = _server(pkg, pool=2)
        srv.submit(lambda: pkg.programs.indirect_svc(3), virtualize=True)
        srv.submit(pkg.prepare(pkg.programs.getpid_loop(10),
                               pkg.Mechanism.ASC, virtualize=True))
        return _run(srv)

    srv, res = _both(scenario)
    st_ref, _, ev_ref, runs_ref = run_with_c3(
        lambda: programs.indirect_svc(3), cfg=HookConfig(), virtualize=True,
        fuel=FUEL, device="cpu")
    r = next(r for r in res if r.rid == 0)
    assert r.events == ev_ref and r.attempts == runs_ref == 2
    for f, a, b in zip(st_ref._fields, st_ref, r.state):
        assert torch.equal(a, b), f
    stats = srv.stats()
    assert stats["scalar_reexecutions"] == 0 and stats["c3_readmissions"] == 1


def test_c3_disabled_publishes_the_fault():
    def scenario(pkg):
        srv = _server(pkg, pool=1)
        cfg = pkg.HookConfig(enable_c3=False)
        srv.submit(pkg.prepare(pkg.programs.indirect_svc(1),
                               pkg.Mechanism.ASC, cfg=cfg))
        return _run(srv)

    _, res = _both(scenario)
    assert not res[0].events and int(res[0].state.halted) == 2  # HALT_SEGV


def test_c3_table_full_publishes_fault_instead_of_corrupting():
    def scenario(pkg):
        srv = _server(pkg, pool=2, table_capacity=1)
        cfg = pkg.HookConfig()
        for _ in range(2):
            srv.submit(lambda: pkg.programs.indirect_svc(1), cfg=cfg,
                       virtualize=True)
        return _run(srv)

    srv, res = _both(scenario)
    assert sorted(int(r.state.halted) for r in res) == [1, 2]
    assert srv.stats()["c3_readmissions"] == 1


def test_c3_pins_shared_via_server_cfg():
    def scenario(pkg):
        cfg = pkg.HookConfig()
        srv = _server(pkg, pool=1)
        srv.submit(lambda: pkg.programs.indirect_svc(1), cfg=cfg,
                   virtualize=True)
        out = srv.run()
        srv.submit(lambda: pkg.programs.indirect_svc(5), cfg=cfg,
                   virtualize=True)
        return srv, out + srv.run()

    _, res = _both(scenario)
    assert len(res[0].events) == 1 and res[1].events == []


def test_submit_validates_like_jax():
    srv = FleetServer(pool=1, fuel=FUEL, device="cpu")
    pp = _pp(PORT, "getpid")
    with pytest.raises(ValueError):
        srv.submit(pp, mechanism=Mechanism.SIGNAL)
    for kw in ({"tenant": 3}, {"priority": True}, {"deadline_steps": -1},
               {"fuel": 0}):
        with pytest.raises(ValueError, match=list(kw)[0]):
            srv.submit(pp, **kw)
    with pytest.raises(ValueError, match="traced server"):
        srv.submit(pp, policy=[tpolicy.deny(L.SYS_READ)])
    assert not srv._queue


# -- traced, streamed and compacted servers -----------------------------------

@pytest.mark.parametrize("mode", ["traced", "streamed", "compact",
                                  "streamed_compact"])
def test_traced_streamed_compacted_server_matches_jax(mode):
    """Policies, rings (wrapped ones too), histograms, the stream and the
    compaction ladder: every result and the stats equal the JAX server's
    and the states equal an untraced server's."""
    trace = True
    stream = "streamed" in mode
    compact = "compact" in mode

    def scenario(pkg, trace=trace):
        cfg = pkg.HookConfig(compact_min_bucket=1, trace_cap=8)
        srv = _server(pkg, pool=3, cfg=cfg,
                      trace=trace, stream=stream and trace, compact=compact)
        pol = ([pkg.policy.deny(pkg.L.SYS_GETPID, errno=13)]
               if trace else None)
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(5, 2, 1),
                   policy=pol)
        srv.submit(_pp(pkg, "getpid"), regs={19: 2})
        srv.submit(_pp(pkg, "read", "SIGNAL"), regs={19: 1})
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(3, 3, 1))
        return _run(srv)

    srv, res = _both(scenario)
    st = srv.stats()
    assert st["trace_records"] > 0
    if stream:
        assert st["stream"]["records_dropped"] == 0
        assert st["trace_dropped"] == 0
    else:
        assert st["trace_dropped"] > 0   # cap 8: the storms wrap
    if compact:
        assert st["pool_shrinks"] >= 1
    if mode != "traced":
        return
    # tracing never changes a machine state (the denied lane aside)
    _, plain = scenario(PORT, trace=False)
    for a, b in zip(sorted(res, key=lambda r: r.rid)[1:],
                    sorted(plain, key=lambda r: r.rid)[1:]):
        for f, x, y in zip(a.state._fields, a.state, b.state):
            assert torch.equal(x, y), (a.rid, f)


def test_follow_yields_the_jax_lines():
    def lines(pkg):
        srv = _server(pkg, pool=2, trace=True,
                      stream=True)
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(3, 2, 1))
        srv.submit(_pp(pkg, "getpid"), regs={19: 2})
        return list(srv.follow()), srv

    jl, jsrv = lines(JAX)
    tl, tsrv = lines(PORT)
    assert jl == tl and len(tl) > 0
    _same_results(jsrv.follow_results, tsrv.follow_results)


# -- the policy scheduler on the server ---------------------------------------

@settings(**_SETTINGS)
@given(data=st.data())
def test_default_scheduler_matches_jax_and_unscheduled(data):
    """A default PolicyScheduler (nothing to enforce: FIFO, no
    checkpoint) equals the JAX server's — traced or not, compacted or
    not."""
    pool = data.draw(st.integers(1, 3), label="pool")
    trace = data.draw(st.booleans(), label="trace")
    compact = data.draw(st.booleans(), label="compact")
    reqs = [(data.draw(st.sampled_from(sorted(WORKLOADS)), label="w"),
             data.draw(st.integers(1, 3), label="n")) for _ in range(2)]

    def scenario(pkg):
        cfg = pkg.HookConfig(compact_min_bucket=1)
        srv = _server(pkg, pool=pool, cfg=cfg, trace=trace, compact=compact,
                      scheduler=pkg.PolicyScheduler())
        for w, n in reqs:
            srv.submit(_pp(pkg, w, "NONE" if w == "storm" else "ASC"),
                       regs=_storm(n, 2, 3) if w == "storm" else {19: n})
        return _run(srv)

    srv, res = _both(scenario)
    st_ = srv.stats()
    assert st_["preemptions"] == st_["evictions"] == 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("budget", [0, 8])
def test_preemption_and_budget_cycles_match_jax(budget, compact):
    """SLO preemption and budget evictions checkpoint lanes and restore
    them later: the port's decisions (the publication ledger), counters
    and states equal the JAX server's, and every state equals the solo
    run."""
    def scenario(pkg):
        sched = pkg.PolicyScheduler(
            budgets={"noisy": pkg.TenantBudget(max_svc=budget)}
            if budget else None)
        cfg = pkg.HookConfig(compact_min_bucket=1)
        srv = _server(pkg, pool=2, cfg=cfg,
                      trace=True, compact=compact, scheduler=sched)
        for _ in range(3):
            srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(5, 2, 3),
                       tenant="noisy")
        out = srv.step()
        srv.submit(_pp(pkg, "getpid"), regs={19: 1}, tenant="victim",
                   priority=10, deadline_steps=40)
        return srv, out + srv.run(max_generations=20000)

    srv, res = _both(scenario)
    st_ = srv.stats()
    assert st_["preemptions"] + st_["evictions"] >= 1
    if budget:
        assert st_["budget_exhaustions"] >= 1
    assert any(r.preemptions for r in res)
    solo = {3: run_prepared(_pp(PORT, "getpid"), fuel=FUEL, regs={19: 1},
                            device="cpu")}
    noisy = run_prepared(_pp(PORT, "storm", "NONE"), fuel=FUEL,
                         regs=_storm(5, 2, 3), device="cpu")
    for r in res:
        ref = solo.get(r.rid, noisy)
        for f, a, b in zip(ref._fields, ref, r.state):
            assert torch.equal(a, b), (r.rid, f)


def test_deny_rate_eviction_and_kill_quarantine_match_jax():
    def scenario(pkg):
        cfg = pkg.HookConfig(sched_deny_rate=0.5, sched_deny_min_svc=4)
        srv = _server(pkg, pool=2, trace=True, cfg=cfg,
                      scheduler=pkg.PolicyScheduler())
        deny = [pkg.policy.deny(pkg.L.SYS_GETPID, errno=13)]
        kill = [pkg.policy.kill(pkg.L.SYS_GETPID)]
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(10, 3, 2),
                   tenant="bad", policy=deny)
        srv.submit(_pp(pkg, "getpid"), regs={19: 4}, tenant="good")
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(2, 2, 2),
                   tenant="killer", policy=kill)
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(2, 2, 2),
                   tenant="killer", policy=kill)
        return _run(srv)

    srv, res = _both(scenario)
    st_ = srv.stats()
    assert st_["evictions"] >= 1 and st_["tenants"]["killer"]["killed"] == 2
    reasons = [e["reason"] for e in st_["quarantine"]["events"]]
    assert "halt_kill" in reasons and any(r.startswith("eviction")
                                          for r in reasons)


def test_update_policy_live_matches_jax():
    """A live policy swap reaches running, queued and checkpointed lanes
    as the JAX server's does; bystanders stay bit-identical."""
    def scenario(pkg):
        srv = _server(pkg, pool=2, trace=True,
                      scheduler=pkg.PolicyScheduler())
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(6, 2, 6),
                   tenant="A")
        srv.submit(_pp(pkg, "getpid"), regs={19: 8}, tenant="B")
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(3, 2, 2),
                   tenant="A")
        out = srv.step() + srv.step()
        assert srv.update_policy(
            "A", [pkg.policy.deny(pkg.L.SYS_GETPID, errno=1)]) == 1
        return srv, out + srv.run(max_generations=20000)

    srv, res = _both(scenario)
    assert srv.stats()["policy_updates"] == 1
    assert srv.stats()["evictions"] == srv.stats()["preemptions"] == 0
    assert all(any(x.verdict == 1 for x in r.trace)
               for r in res if r.tenant == "A")


def test_full_table_does_not_livelock_checkpoint_restores():
    def scenario(pkg):
        srv = _server(pkg, pool=1, trace=True,
                      table_capacity=1, scheduler=pkg.PolicyScheduler())
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(5, 2, 6),
                   tenant="a")
        out = srv.step()
        srv.submit(_pp(pkg, "getpid"), regs={19: 2}, tenant="b",
                   priority=10, deadline_steps=48)
        return srv, out + srv.run(max_generations=2000)

    srv, res = _both(scenario)
    assert len(res) == 2 and srv.stats()["preemptions"] >= 1


def test_c3_readmission_under_scheduler_and_compaction():
    def scenario(pkg):
        srv = _server(pkg, pool=2, trace=True,
                      compact=True, cfg=pkg.HookConfig(compact_min_bucket=1),
                      scheduler=pkg.PolicyScheduler())
        srv.submit(lambda: pkg.programs.indirect_svc(3), virtualize=True,
                   tenant="c3")
        srv.submit(_pp(pkg, "storm", "NONE"), regs=_storm(6, 2, 4),
                   tenant="noisy")
        return _run(srv)

    srv, res = _both(scenario)
    st_ = srv.stats()
    assert st_["c3_readmissions"] == 1 and st_["scalar_reexecutions"] == 0


# -- the port's own: copies, not views; the unported option raises ----------

def test_published_state_survives_later_generations():
    """A published state is a copy: the lane it ran on is reused by the
    next admission and rewritten in place, the published state is not."""
    srv = _server(PORT, pool=1)
    srv.submit(_pp(PORT, "getpid"), regs={19: 2})
    srv.submit(_pp(PORT, "read", "SIGNAL"), regs={19: 2})
    first = []
    while not first:
        first = srv.step()
    kept = fleet.stack_states([first[0].state]).mem.clone()
    keep_all = [x.clone() for x in first[0].state]
    srv.run()
    # the lane was rewritten by the second request...
    assert not torch.equal(srv._states.mem[0], kept[0])
    # ...and the published state was not
    for f, a, b in zip(first[0].state._fields, keep_all, first[0].state):
        assert torch.equal(a, b), f


def test_preemption_checkpoint_survives_later_generations():
    """A checkpoint is a copy: while its request waits, the parked lane
    runs other requests, and the checkpoint stays as it was taken."""
    srv = _server(PORT, pool=1, trace=True, scheduler=PolicyScheduler())
    srv.submit(_pp(PORT, "storm", "NONE"), regs=_storm(6, 2, 6),
               tenant="a")
    srv.step()
    srv.submit(_pp(PORT, "getpid"), regs={19: 2}, tenant="b", priority=10,
               deadline_steps=40)
    srv.step()                     # preempts a, admits b
    req = next(r for r in srv._queue if r.checkpoint is not None)
    state, tr = req.checkpoint
    kept = ([x.clone() for x in state], [x.clone() for x in tr])
    srv.step()                     # b runs on a's lane
    assert not torch.equal(srv._states.regs[0], state.regs)
    for a, b in zip(kept[0] + kept[1], list(state) + list(tr)):
        assert torch.equal(a, b)
    res = {r.rid: r for r in srv.run(max_generations=2000)}
    ref = run_prepared(_pp(PORT, "storm", "NONE"), fuel=FUEL,
                       regs=_storm(6, 2, 6), device="cpu")
    assert res[0].preemptions == 1
    for f, a, b in zip(ref._fields, ref, res[0].state):
        assert torch.equal(a, b), f


def test_unported_options_raise():
    """Every option is ported (lane sharding here and in
    tests/test_torch_sharding.py; durability and chaos in
    tests/test_torch_durability.py and tests/test_torch_chaos.py): a
    sharded server on one device keeps the unsharded ladder, and
    ``engine="pallas"`` with ``shard=True`` raises as the JAX server
    does."""
    srv = FleetServer(pool=4, shard=True, compact=True, device="cpu",
                      cfg=HookConfig(compact_min_bucket=1))
    assert srv._mesh.size == 1 and srv._ladder == [4, 2, 1]
    with pytest.raises(ValueError, match="does not compose with shard"):
        FleetServer(pool=2, shard=True, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="does not compose with shard"):
        JFleetServer(pool=2, shard=True, engine="pallas")
    st_ = FleetServer(pool=1, device="cpu").stats()
    assert st_["durability_enabled"] is False and st_["chaos"] is None


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetServer(pool=1)


def test_chip_smoke_server_helpers_match_jax(monkeypatch):
    """chip_smoke.py's fleet_server phase at a small size: its helpers
    drive both servers alike, and the summaries they pin (stats and
    publication ledgers, records digests, the scheduler counters, the C3
    events) are equal for the JAX server and the port's."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_fleet_server",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "FS_POOL", 2)
    monkeypatch.setattr(smoke, "FS_GEN_STEPS", 40)
    monkeypatch.setattr(smoke, "CHUNK", 8)
    monkeypatch.setattr(smoke, "FUEL", FUEL)
    mix = {"pool": 2, "gen_steps": 40, "chunk": 8, "n_noisy": 3,
           "n_victim": 1, "storm_iters": 2, "victim_iters": 1,
           "budget_svc": 6, "deadline_steps": 40}
    got = {}
    for pkg in (JAX, PORT):
        pps = [_pp(pkg, "getpid"), _pp(pkg, "read", "SIGNAL"),
               _pp(pkg, "getpid")]
        regs = [{19: 1}, {19: 1}, {19: 2}]
        out = {}
        for arm, kw in (("served", {}), ("traced", {
                "trace": True, "stream": True, "compact": True,
                "obs": True})):
            srv = smoke.census_server(pkg, pps, regs, **kw, **pkg.kw)
            res = srv.run()
            out[arm] = (smoke.served_summary(srv, res),
                        smoke.records_digest(res))
        noisy, vics = smoke.sched_mix(pkg, mix)
        for arm, sched in (("unscheduled", False), ("scheduled", True)):
            summary, srv, _, _ = smoke.serve_sched_mix(
                pkg, noisy, vics, scheduled=sched, mix=mix, **pkg.kw)
            out[arm] = summary
        out["c3"] = smoke.c3_request(pkg, srv)[1]
        got[pkg.name] = out
    assert got["jax"] == got["torch"]
    assert got["torch"]["scheduled"]["evictions"] >= 1
    assert got["torch"]["c3"]["c3_readmissions"] == 1
