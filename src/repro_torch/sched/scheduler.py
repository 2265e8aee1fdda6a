"""Admission / preemption / eviction decisions (repro_torch.sched).

:class:`PolicyScheduler` is the decision half of the serving control
plane: it orders the admission queue (deadline-risk first, then priority,
then FIFO), picks preemption victims for deadline-risk requests, and
judges running lanes against deny-rate and budget policy.  It never
touches device state — :class:`repro_torch.serve.fleet_server.FleetServer`
calls it with host-side views and performs the mechanics (checkpoint
scatters via ``fleet.restore_lanes``/``unstack_state``, policy-row swaps,
admission).

Requests are duck-typed: anything carrying ``tenant`` / ``priority`` /
``deadline_steps`` / ``submitted_gen`` / ``rid`` / ``cfg`` works, which
keeps this module import-free of the server (no cycle) and unit-testable
with plain stubs.

With everything defaulted — no budgets, zero priorities, no deadlines,
deny-rate off — every decision degrades to the pre-scheduler behavior:
``admission_order`` is FIFO, nothing preempts, nothing evicts.  The
``sched`` test tier pins that equivalence bit-for-bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .budgets import BudgetLedger, TenantBudget
from .quarantine import Quarantine


class PolicyScheduler:
    """Per-tenant budgets + SLO preemption + quarantine decisions.

    ``budgets`` are explicit per-tenant overrides; tenants without one use
    the attached server config's ``budget_svc`` / ``budget_deny`` as the
    default.  ``preempt=False`` keeps admission ordering and budgets but
    never checkpoints a lane for a deadline.
    """

    def __init__(self, *, budgets: Optional[Dict[str, TenantBudget]] = None,
                 quarantine: Optional[Quarantine] = None,
                 preempt: bool = True):
        self.ledger = BudgetLedger(budgets)
        self.quarantine = quarantine
        self.preempt = bool(preempt)
        self._cfg = None
        self._metrics = None

    def attach(self, cfg, metrics=None) -> None:
        """Bind server-level defaults (called by ``FleetServer``): the
        default tenant budget and the quarantine backoff curve come from
        the server's :class:`HookConfig` unless given explicitly.

        ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry` or None) makes
        every decision this scheduler takes observable as typed counters
        (``sched_decisions_total{decision=...}``) without the server
        interpreting them — None keeps the scheduler metrics-free."""
        self._cfg = cfg
        self._metrics = metrics
        self.ledger.default = TenantBudget(max_svc=cfg.budget_svc,
                                           max_deny=cfg.budget_deny)
        if self.quarantine is None:
            self.quarantine = Quarantine(base=cfg.sched_backoff_base,
                                         cap=cfg.sched_backoff_cap)

    def _note(self, decision: str, tenant: str = "") -> None:
        if self._metrics is not None:
            self._metrics.counter(
                "sched_decisions_total",
                "scheduler decisions by type").inc(1, decision=decision)

    # -- deadlines ------------------------------------------------------------

    def deadline_gen(self, req, gen_steps: int) -> Optional[int]:
        """The generation by which ``req`` must complete (None = no SLO)."""
        if req.deadline_steps <= 0:
            return None
        return req.submitted_gen + max(1, -(-req.deadline_steps // gen_steps))

    def at_risk(self, req, generation: int, gen_steps: int) -> bool:
        """Within the SLO margin of (or past) the deadline while still
        queued — the condition that arms preemption for this request."""
        dg = self.deadline_gen(req, gen_steps)
        if dg is None:
            return False
        return generation >= dg - req.cfg.sched_slo_margin_gens

    # -- admission ------------------------------------------------------------

    def admission_order(self, queue: Sequence, generation: int,
                        gen_steps: int) -> List:
        """Quarantine-gated admission order: deadline-risk requests first,
        then priority (descending), then submission order.  The sort is
        stable, so all-default requests come out exactly FIFO."""
        viable = [r for r in queue
                  if not self.quarantine.blocked(r.tenant, generation)]
        if len(viable) < len(queue):
            self._note("quarantine_gated")
        return sorted(viable, key=lambda r: (
            0 if self.at_risk(r, generation, gen_steps) else 1,
            -r.priority))

    # -- preemption -----------------------------------------------------------

    def pick_victim(self, candidate, running: Sequence) -> Optional[object]:
        """The lane to checkpoint so ``candidate`` (a deadline-risk queued
        request) can have its slot: the lowest-priority running request
        strictly below the candidate's priority, most recent *submission*
        (highest rid) breaking ties — the newest arrival has the least
        standing.  None = nothing preemptible."""
        if not self.preempt:
            return None
        victims = [r for r in running if r.priority < candidate.priority]
        if not victims:
            return None
        self._note("preempt")
        return min(victims, key=lambda r: (r.priority, -r.rid))

    # -- in-flight enforcement ------------------------------------------------

    def should_evict(self, req, svc: int, deny: int) -> Optional[str]:
        """Deny-rate eviction: the lane's DENY fraction this attempt
        exceeds its config's threshold (past the minimum sample)."""
        rate = req.cfg.sched_deny_rate
        if rate <= 0.0 or svc < max(1, req.cfg.sched_deny_min_svc):
            return None
        if deny / svc > rate:
            self._note("evict_deny_rate")
            return f"deny_rate {deny}/{svc} > {rate}"
        return None

    def exhausted(self, tenant: str, inflight_svc: int,
                  inflight_deny: int) -> Optional[str]:
        """Budget check for one tenant given uncharged in-flight deltas."""
        reason = self.ledger.exhausted(tenant, inflight_svc=inflight_svc,
                                       inflight_deny=inflight_deny)
        if reason is not None:
            self._note("budget_exhausted")
        return reason

    def note_corruption(self, tenant: str, generation: int) -> int:
        """Escalate a detected carry corruption (durable serving's
        replay-verify caught a digest mismatch on this tenant's lanes)
        into the same exponential quarantine backoff as a kill/eviction.
        Returns the generation the tenant is blocked until."""
        self._note("quarantine_corruption")
        return self.quarantine.punish(tenant, generation,
                                      reason="carry_corruption")
