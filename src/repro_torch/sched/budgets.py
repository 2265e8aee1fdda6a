"""Per-tenant syscall/deny budget accounting (repro_torch.sched).

Budgets are *windows*, not lifetime caps: a tenant that exhausts its
window has its lanes checkpointed and re-queued, backs off in quarantine
(exponential), and gets a fresh window on re-admission — throttling with
an escalating penalty, never a permanent ban, so a serving loop always
drains.  Usage is fed by the on-device verdict counters in the fleet
trace carry (``TraceState.count`` = executed svcs, ``deny_count`` etc.):
the server charges the *delta* since each request's last charge point
(admission, checkpoint, or publish), so preempt/resume cycles never
double-count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class TenantBudget:
    """Window budgets for one tenant; 0 means unlimited."""

    max_svc: int = 0    # executed syscalls (any verdict) per window
    max_deny: int = 0   # DENY verdicts per window


@dataclasses.dataclass
class TenantUsage:
    """Lifetime verdict totals plus the current budget window."""

    svc: int = 0
    deny: int = 0
    emul: int = 0
    kill: int = 0
    enosys: int = 0
    window_svc: int = 0
    window_deny: int = 0
    exhaustions: int = 0


class BudgetLedger:
    """Tenant -> usage accounting with per-tenant (or default) budgets.

    ``budgets`` maps tenant labels to explicit :class:`TenantBudget`
    entries; tenants without one fall back to ``default`` (typically
    built from ``HookConfig.budget_svc`` / ``budget_deny``).
    """

    def __init__(self, budgets: Optional[Dict[str, TenantBudget]] = None,
                 default: Optional[TenantBudget] = None):
        self.budgets = dict(budgets or {})
        self.default = default or TenantBudget()
        self._usage: Dict[str, TenantUsage] = {}
        self.events: List[dict] = []   # budget-exhaustion event log

    def budget_for(self, tenant: str) -> TenantBudget:
        return self.budgets.get(tenant, self.default)

    def usage(self, tenant: str) -> TenantUsage:
        if tenant not in self._usage:
            self._usage[tenant] = TenantUsage()
        return self._usage[tenant]

    def charge(self, tenant: str, *, svc: int = 0, deny: int = 0,
               emul: int = 0, kill: int = 0, enosys: int = 0) -> None:
        """Add a usage delta (already de-duplicated by the caller's
        charge-point bookkeeping) to the tenant's lifetime + window.

        Deltas may be negative (a C3 recycle rolls a discarded attempt's
        usage back out); the window floors at 0 so a rollback that spans
        an exhaustion reset can't bank negative credit."""
        u = self.usage(tenant)
        u.svc += svc
        u.deny += deny
        u.emul += emul
        u.kill += kill
        u.enosys += enosys
        u.window_svc = max(0, u.window_svc + svc)
        u.window_deny = max(0, u.window_deny + deny)

    def exhausted(self, tenant: str, *, inflight_svc: int = 0,
                  inflight_deny: int = 0) -> Optional[str]:
        """The exhaustion reason ("svc"/"deny") if the tenant's window
        usage plus the uncharged in-flight deltas crosses its budget."""
        b = self.budget_for(tenant)
        u = self.usage(tenant)
        if b.max_svc and u.window_svc + inflight_svc > b.max_svc:
            return "svc"
        if b.max_deny and u.window_deny + inflight_deny > b.max_deny:
            return "deny"
        return None

    def reset_window(self, tenant: str, *, generation: int,
                     reason: str) -> dict:
        """Close the exhausted window: log the event, zero the window
        counters (the tenant restarts fresh after its quarantine)."""
        u = self.usage(tenant)
        u.exhaustions += 1
        event = {"tenant": tenant, "generation": generation,
                 "reason": reason, "window_svc": u.window_svc,
                 "window_deny": u.window_deny}
        self.events.append(event)
        u.window_svc = 0
        u.window_deny = 0
        return event

    def snapshot(self) -> Dict[str, dict]:
        return {t: dataclasses.asdict(u) for t, u in self._usage.items()}
