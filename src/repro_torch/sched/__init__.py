"""Policy-driven serving scheduler: the layer that *acts* on verdicts
(PyTorch port of the JAX package's ``repro.sched``: host code only, a
copy of the original).

The trace/policy subsystem (:mod:`repro_torch.trace`) enforces per-lane
seccomp-style verdicts inside the batched step; related work argues the
serving side should react to them — "Making 'syscall' a Privilege not a
Right" grants and revokes syscall capability per principal, and the
platform-centric Android monitors drive central enforcement from per-app
policy modules.  This package is that control plane for the fleet server:

* :mod:`repro_torch.sched.budgets` — per-tenant syscall/deny budget accounting,
  fed by the cheap on-device verdict counters in the fleet trace carry
  (``TraceState.count/deny_count/...`` — harvested as four [B] arrays,
  never by decoding rings);
* :mod:`repro_torch.sched.scheduler` — admission ordering (priority +
  latency-SLO deadlines), deny-rate lane eviction, and preemption
  decisions (a low-priority live lane is checkpointed via the harvest
  path and re-queued when a deadline-risk request needs its slot);
* :mod:`repro_torch.sched.quarantine` — HALT_KILL / evicted tenants re-admit
  only after an exponential backoff instead of instantly reclaiming a
  slot.

All *decisions* live here as plain host-side logic; the *mechanics*
(checkpoint scatters, policy-row swaps, admission) stay in
:class:`repro_torch.serve.fleet_server.FleetServer`, which takes a
:class:`PolicyScheduler` via its ``scheduler=`` hook.  With the hook
absent the server's behavior is bit-identical to the pre-scheduler
server; with a default-configured scheduler (no budgets, no priorities,
no deadlines) it degrades to FIFO and stays bit-identical too — both are
enforced by ``tests/test_sched.py`` for the JAX package and by
``tests/test_torch_sched.py`` for this copy.
"""
from .budgets import BudgetLedger, TenantBudget
from .quarantine import Quarantine
from .scheduler import PolicyScheduler

__all__ = ["BudgetLedger", "PolicyScheduler", "Quarantine", "TenantBudget"]
