"""The port's policy scheduler (``repro_torch.sched``) against the JAX
package's ``repro.sched``, on the CPU.

Under test: the budget ledger (windows, in-flight checks, negative
rollbacks, exhaustion events), the quarantine (exponential backoff,
streak resets, depth) and the scheduler's decisions (deadline
generations, risk, admission order, preemption victims, deny-rate
evictions, budget checks, corruption escalation) and the decision
counters it writes into a metrics registry.  Both copies are fed the same
operation sequences, made from a seed with numpy; every return value,
event log and snapshot must be equal.  These are the unit cases of
``tests/test_sched.py``; the scheduler on a running server is held in
``tests/test_torch_fleet_server.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import HookConfig as JHookConfig
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.sched import BudgetLedger as JBudgetLedger
from repro.sched import PolicyScheduler as JPolicyScheduler
from repro.sched import Quarantine as JQuarantine
from repro.sched import TenantBudget as JTenantBudget

from repro_torch.core import HookConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.sched import (BudgetLedger, PolicyScheduler, Quarantine,
                               TenantBudget)

SEEDS = [0, 1, 2, 3, 4]
TENANTS = ["a", "b", "noisy", ""]


@dataclasses.dataclass
class _Req:
    """A duck-typed request: what the scheduler reads."""

    rid: int
    tenant: str = ""
    priority: int = 0
    deadline_steps: int = 0
    submitted_gen: int = 0
    cfg: object = None


def _budgets(cls, rng):
    return {t: cls(max_svc=int(rng.integers(0, 40)),
                   max_deny=int(rng.integers(0, 10)))
            for t in TENANTS[:2] if rng.random() < 0.8}


@pytest.mark.parametrize("seed", SEEDS)
def test_budget_ledger_matches_jax(seed):
    """Charges (negative rollbacks included), in-flight exhaustion checks
    and window resets: every answer, event and snapshot equal."""
    rng = np.random.default_rng(seed)
    brng = np.random.default_rng(seed)
    default = (int(rng.integers(0, 30)), int(rng.integers(0, 8)))
    jl = JBudgetLedger(_budgets(JTenantBudget, brng),
                       JTenantBudget(*default))
    brng = np.random.default_rng(seed)
    tl = BudgetLedger(_budgets(TenantBudget, brng), TenantBudget(*default))
    for i in range(200):
        t = TENANTS[int(rng.integers(len(TENANTS)))]
        op = rng.integers(3)
        if op == 0:
            kw = {k: int(rng.integers(-3, 9)) for k in
                  ("svc", "deny", "emul", "kill", "enosys")}
            jl.charge(t, **kw)
            tl.charge(t, **kw)
        elif op == 1:
            kw = {"inflight_svc": int(rng.integers(0, 12)),
                  "inflight_deny": int(rng.integers(0, 5))}
            assert jl.exhausted(t, **kw) == tl.exhausted(t, **kw), i
        else:
            reason = ["svc", "deny"][int(rng.integers(2))]
            assert jl.reset_window(t, generation=i, reason=reason) == \
                tl.reset_window(t, generation=i, reason=reason)
        assert dataclasses.astuple(jl.budget_for(t)) == \
            dataclasses.astuple(tl.budget_for(t))
    assert jl.snapshot() == tl.snapshot()
    assert jl.events == tl.events


@pytest.mark.parametrize("seed", SEEDS)
def test_quarantine_matches_jax(seed):
    """punish / blocked / depth / clear / state over a random sequence."""
    rng = np.random.default_rng(seed)
    base, cap = int(rng.integers(1, 4)), int(rng.integers(4, 40))
    jq, tq = JQuarantine(base=base, cap=cap), Quarantine(base=base, cap=cap)
    gen = 0
    for _ in range(300):
        gen += int(rng.integers(0, 4))
        t = TENANTS[int(rng.integers(len(TENANTS)))]
        op = rng.integers(4)
        if op == 0:
            assert jq.punish(t, gen, reason="x") == \
                tq.punish(t, gen, reason="x")
        elif op == 1:
            assert jq.blocked(t, gen) == tq.blocked(t, gen)
        elif op == 2:
            assert jq.depth(gen) == tq.depth(gen)
        else:
            jq.clear(t)
            tq.clear(t)
    assert jq.state() == tq.state()


def test_quarantine_backoff_doubles_and_resets():
    q = Quarantine(base=2, cap=16)
    assert q.punish("t", 0, reason="x") == 2
    assert q.blocked("t", 1) and not q.blocked("t", 2)
    assert q.punish("t", 10, reason="x") == 14
    assert q.punish("t", 20, reason="x") == 28
    assert q.punish("t", 30, reason="x") == 46
    q.clear("t")
    assert q.punish("t", 50, reason="x") == 52


def _cfg(cls, rng):
    return cls(sched_slo_margin_gens=int(rng.integers(0, 4)),
               sched_deny_rate=float(rng.choice([0.0, 0.25, 0.5])),
               sched_deny_min_svc=int(rng.integers(0, 8)),
               budget_svc=int(rng.integers(0, 30)),
               budget_deny=int(rng.integers(0, 6)),
               sched_backoff_base=int(rng.integers(1, 4)),
               sched_backoff_cap=int(rng.integers(4, 64)))


def _requests(cfg, rng, n):
    return [_Req(rid=i, tenant=TENANTS[int(rng.integers(len(TENANTS)))],
                 priority=int(rng.integers(-2, 4)),
                 deadline_steps=int(rng.choice([0, 0, 40, 96, 500])),
                 submitted_gen=int(rng.integers(0, 10)), cfg=cfg)
            for i in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_scheduler_decisions_match_jax(seed):
    """Deadlines, risk, admission order (quarantine-gated), preemption
    victims, deny-rate evictions, budget checks and corruption
    escalation, over random requests and generations; the decision
    counters render the same Prometheus text."""
    rng = np.random.default_rng(seed)
    jcfg = _cfg(JHookConfig, np.random.default_rng(seed))
    tcfg = _cfg(HookConfig, np.random.default_rng(seed))
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    js = JPolicyScheduler(budgets=_budgets(JTenantBudget,
                                           np.random.default_rng(seed + 9)),
                          preempt=bool(seed % 2 == 0))
    ts = PolicyScheduler(budgets=_budgets(TenantBudget,
                                          np.random.default_rng(seed + 9)),
                         preempt=bool(seed % 2 == 0))
    js.attach(jcfg, metrics=jreg)
    ts.attach(tcfg, metrics=treg)
    n = int(rng.integers(4, 12))
    jreqs = _requests(jcfg, np.random.default_rng(seed + 1), n)
    treqs = _requests(tcfg, np.random.default_rng(seed + 1), n)
    for gen in range(0, 40, 3):
        gs = int(rng.choice([8, 40, 64]))
        for a, b in zip(jreqs, treqs):
            assert js.deadline_gen(a, gs) == ts.deadline_gen(b, gs)
            assert js.at_risk(a, gen, gs) == ts.at_risk(b, gen, gs)
        assert [r.rid for r in js.admission_order(jreqs, gen, gs)] == \
            [r.rid for r in ts.admission_order(treqs, gen, gs)]
        k = int(rng.integers(n))
        running = [int(i) for i in rng.permutation(n)[:int(rng.integers(n))]]
        jv = js.pick_victim(jreqs[k], [jreqs[i] for i in running])
        tv = ts.pick_victim(treqs[k], [treqs[i] for i in running])
        assert (jv and jv.rid) == (tv and tv.rid)
        svc, deny = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        assert js.should_evict(jreqs[k], svc, deny) == \
            ts.should_evict(treqs[k], svc, deny)
        t = TENANTS[int(rng.integers(len(TENANTS)))]
        js.ledger.charge(t, svc=svc, deny=deny)
        ts.ledger.charge(t, svc=svc, deny=deny)
        assert js.exhausted(t, svc, deny) == ts.exhausted(t, svc, deny)
        if rng.random() < 0.3:
            assert js.note_corruption(t, gen) == ts.note_corruption(t, gen)
        if rng.random() < 0.3:
            js.quarantine.punish(t, gen, reason="y")
            ts.quarantine.punish(t, gen, reason="y")
    assert js.quarantine.state() == ts.quarantine.state()
    assert js.ledger.snapshot() == ts.ledger.snapshot()
    assert jreg.render_prometheus() == treg.render_prometheus()


def test_admission_order_defaults_to_fifo():
    sched = PolicyScheduler()
    sched.attach(HookConfig())
    reqs = [_Req(rid=i, cfg=HookConfig()) for i in range(5)]
    assert sched.admission_order(reqs, 10, 64) == reqs
    reqs[3].priority = 5
    reqs[1].deadline_steps = 64
    order = sched.admission_order(reqs, 10, 64)
    assert order[0] is reqs[1] and order[1] is reqs[3]
    sched.quarantine.punish("noisy", 9, reason="x")
    reqs[3].tenant = "noisy"
    assert reqs[3] not in sched.admission_order(reqs, 10, 64)


def test_pick_victim_needs_strictly_lower_priority():
    sched = PolicyScheduler()
    sched.attach(HookConfig())
    cand = _Req(rid=9, priority=3)
    assert sched.pick_victim(cand, [_Req(0, priority=3),
                                    _Req(1, priority=5)]) is None
    v = sched.pick_victim(cand, [_Req(0, priority=1), _Req(1, priority=0),
                                 _Req(2, priority=0), _Req(3, priority=5)])
    assert v.rid == 2


def test_attach_takes_the_config_defaults():
    cfg = HookConfig(budget_svc=7, budget_deny=2, sched_backoff_base=3,
                     sched_backoff_cap=9)
    sched = PolicyScheduler()
    sched.attach(cfg)
    assert sched.ledger.default == TenantBudget(max_svc=7, max_deny=2)
    assert (sched.quarantine.base, sched.quarantine.cap) == (3, 9)
    given = Quarantine(base=5, cap=50)
    sched = PolicyScheduler(quarantine=given)
    sched.attach(cfg)
    assert sched.quarantine is given
