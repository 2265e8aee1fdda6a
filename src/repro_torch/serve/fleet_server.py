"""Continuous-batching fleet server with fleet-native C3 lane recycling
(PyTorch port of the JAX package's ``repro.serve.fleet_server``).

The fleet engine runs a census one launch loop per fleet but *drains* it:
no new process starts until every lane halts, so a mixed-length workload
pays the longest lane's wall-clock for the whole batch, and a C3 fault
falls back to scalar re-execution (``run_with_c3``).  This server is the
serving layer over it:

* **Fixed-width lane pool.**  ``pool`` lanes are driven in bounded-step
  *generations* (:func:`repro_torch.core.fleet.run_fleet_span`: on the
  card every chunk of a generation is one launch of the CUDA megastep
  kernel, on CPU tensors its plain version; the carry is updated in
  place throughout).
* **Harvest + in-place admission.**  After each generation, halted lanes
  are harvested (one host copy of the halt and step words), their
  results published, and queued requests admitted into the freed slots
  *in place* (:func:`repro_torch.core.fleet.admit_lanes`; one kernel
  serves every width, so unlike the JAX package's scatter the admission
  is not padded to the pool width).
* **Incremental image table.**  Decode tables live in a fixed-capacity
  :class:`repro_torch.core.FleetImageTable`; a new request's deduped
  image joins the table as one in-place row write, and the next span
  builds the kernel's decode table from it.
* **Fleet-native C3.**  Lanes that halt with the paper's R3 fault
  signature (``pc == x8 < 600``) are diagnosed in a batch
  (:func:`repro_torch.core.diagnose_c3_fleet`), their site pinned into
  the request's :class:`HookConfig` (the "config file" of Figure 4), the
  process re-prepared host-side and the lane re-admitted automatically —
  the trap -> config -> re-execute flow without leaving the fleet
  (``stats()["scalar_reexecutions"]`` stays 0).
* **Tracing + policy (repro_torch.trace).**  With ``trace=True`` every
  lane carries a syscall ring and a seccomp-style policy table through
  the generations; ``submit(policy=[...])`` installs per-request rules,
  the harvest decodes each finished lane's ring into strace-style
  :class:`repro_torch.trace.TraceRecord` rows on its
  :class:`FleetResult`, and ``admit_lanes`` recycles the ring rows in
  the same scatter as the machine state.
* **Policy scheduler (repro_torch.sched).**  With ``scheduler=`` (a
  :class:`repro_torch.sched.scheduler.PolicyScheduler`) requests carry
  ``tenant`` / ``priority`` / ``deadline_steps``, admission is
  quarantine-gated and ordered deadline-risk-first-then-priority,
  per-tenant syscall/deny budgets are fed by the verdict counters in the
  trace carry, deny-storming or budget-exhausted lanes are checkpointed
  and re-queued behind an exponential backoff, and a deadline-risk
  request preempts the lowest-priority lane — restored later bit for bit
  by ``fleet.restore_lanes``.  ``update_policy(tenant, rules)`` swaps
  running lanes' policy rows live.
* **Live-lane compaction.**  With ``compact=True`` generations run at
  the occupancy-chosen width of the pool's ladder
  (:func:`repro_torch.core.fleet.compact_ladder`); the physical-lane ->
  request mapping is tracked host-side, so published results are
  bit-identical to the fixed-width server's.
* **Durable serving and chaos (repro_torch.serve.durability / .chaos).**
  With ``durability=`` (a :class:`~repro_torch.serve.durability.
  DurabilityManager`) every submit, shed, policy update and generation is
  journaled write-ahead and the whole server snapshotted every
  ``snapshot_interval`` generations; :meth:`FleetServer.recover` rebuilds
  a killed server from its directory and replays the journal tail to the
  same results.  With ``chaos=`` (a :class:`~repro_torch.serve.chaos.
  ChaosMonkey`) seeded faults fire before a generation's launches and are
  retried, load-shed with a reason, rewritten or rolled back.  The files
  are the JAX package's.

The carry is mutable here, unlike the JAX package's: the kernel,
``admit_lanes`` and ``restore_lanes`` write its leaves in place, and
``unstack_state`` / ``unstack_trace`` give views into them.  So every
lane tree the server keeps — a preemption checkpoint, a published
``FleetResult.state`` — is a copy that no later generation touches.

``device=None`` means the card; the server passes its device to every
fleet call.  Lane sharding (``shard=True``) is not ported yet and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import fleet as F
from ..core import machine as M
from ..core.completeness import C3Event, diagnose_c3_fleet
from ..core.hookcfg import HookConfig, PolicyRule
from ..core.isa import Asm
from ..core.runtime import (FleetImageTable, Mechanism, PreparedProcess,
                            initial_state, prepare)
from ..obs import ObsHub
from ..obs import now as obs_now
from ..obs import phase as obs_phase
from ..sched.scheduler import PolicyScheduler
from ..trace import policy as trace_policy
from ..trace import recorder as trace_recorder
from ..trace import stream as trace_stream

AppBuilder = Callable[[], Asm]


def _copy(tree):
    """A lane tree (or a batch) that shares no storage with ``tree``."""
    return type(tree)(*(x.clone() for x in tree))


@dataclasses.dataclass
class FleetRequest:
    """One simulated process waiting for (or occupying) a lane."""

    rid: int
    pp: PreparedProcess
    builder: Optional[AppBuilder]      # needed for C3 re-preparation
    cfg: HookConfig
    mechanism: Mechanism
    virtualize: bool
    fuel: int
    regs: Optional[Dict[int, int]]
    submitted_gen: int
    submitted_s: float
    admitted_gen: int = -1
    admitted_s: float = 0.0
    slot: int = -1
    row: int = -1
    attempts: int = 0                  # executions so far (C3 restarts + 1)
    events: List[C3Event] = dataclasses.field(default_factory=list)
    policy: Optional[trace_policy.PolicyRows] = None  # compiled at submit
    # -- scheduler fields (repro_torch.sched) ---------------------------------
    tenant: str = ""                   # accounting principal
    priority: int = 0                  # admission/preemption rank
    deadline_steps: int = 0            # latency SLO (0 = none)
    preemptions: int = 0               # checkpoint/resume cycles so far
    # full lane checkpoint: (MachineState lane tree, TraceState lane tree
    # or None), copies captured at preemption/eviction time; restored
    # verbatim by fleet.restore_lanes on re-admission
    checkpoint: Optional[tuple] = None
    # last park point (preemption/eviction checkpoint or C3 recycle):
    # re-admission records generation + wall-clock resume waits from here
    parked_gen: int = -1
    parked_s: float = 0.0
    charged_svc: int = 0               # counters already charged to the
    charged_deny: int = 0              # ledger (delta bookkeeping across
    charged_emul: int = 0              # preempt/resume cycles)
    charged_kill: int = 0


@dataclasses.dataclass
class FleetResult:
    """A published request: its final lane state plus serving metadata."""

    rid: int
    state: M.MachineState              # bit-identical to run_prepared alone
    events: List[C3Event]
    attempts: int
    submitted_gen: int
    admitted_gen: int
    completed_gen: int
    admission_wait_gens: int
    admission_wait_s: float
    # syscall trace of the published attempt (traced servers only)
    trace: List[trace_recorder.TraceRecord] = dataclasses.field(
        default_factory=list)
    trace_dropped: int = 0             # ring overflow: oldest records lost
    # per-syscall x per-verdict totals from the on-device hist plane
    # ({name: {verdict: n}}, traced servers only) — never decodes a ring
    histogram: Dict = dataclasses.field(default_factory=dict)
    tenant: str = ""
    preemptions: int = 0               # scheduler checkpoint/resume cycles


class FleetServer:
    """Continuous-batching server over the batched fleet engine.

    ``pool`` is the lane-pool width; ``gen_steps`` the masked steps per
    generation (scheduling granularity — results are invariant to it);
    ``table_capacity`` bounds how many distinct binaries can be resident at
    once (pool width + expected diversity).  ``device=None`` means the
    card.  ``shard=True`` is not ported yet and raises.
    """

    def __init__(self, pool: int = 8, *, cfg: Optional[HookConfig] = None,
                 gen_steps: Optional[int] = None, chunk: Optional[int] = None,
                 table_capacity: Optional[int] = None,
                 fuel: int = 2_000_000, shard: bool = False,
                 trace: Optional[bool] = None,
                 stream: Optional[bool] = None,
                 compact: Optional[bool] = None,
                 scheduler: Optional[PolicyScheduler] = None,
                 durability=None, chaos=None,
                 obs: Optional["ObsHub | bool"] = None,
                 engine: Optional[str] = None,
                 device=None):
        assert pool >= 1
        self.pool = pool
        self.cfg = cfg or HookConfig()
        self.gen_steps = int(self.cfg.serve_gen_steps if gen_steps is None
                             else gen_steps)
        self.chunk = int(self.cfg.fleet_chunk if chunk is None else chunk)
        if self.gen_steps < 1 or self.chunk < 1:
            raise ValueError(
                f"gen_steps/chunk must be >= 1, got {self.gen_steps}/{self.chunk}")
        # both engine names run the megastep wrapper (bit-identical in the
        # JAX package); shard=True raises here
        self.engine = F._check_engine(
            self.cfg.fleet_engine if engine is None else engine, shard=shard)
        self.device = M.resolve_device(device)
        self.default_fuel = fuel
        self.trace_enabled = bool(self.cfg.trace_enabled if trace is None
                                  else trace)
        self.stream_enabled = bool(self.cfg.trace_stream if stream is None
                                   else stream)
        if self.stream_enabled and not self.trace_enabled:
            raise ValueError(
                "streaming needs the trace carry: enable tracing too "
                "(FleetServer(trace=True) or cfg.trace_enabled)")
        self.compact_enabled = bool(self.cfg.compact_enabled if compact is None
                                    else compact)
        self.table = FleetImageTable(table_capacity or pool + 8,
                                     device=self.device)
        self._slots: List[Optional[FleetRequest]] = [None] * pool
        self._ids = np.zeros(pool, np.int32)
        self._fuel = np.zeros(pool, np.int64)   # host mirror: fuel is
        # constant per occupancy, so harvest needs no device read for it
        self._queue: Deque[FleetRequest] = deque()
        self._readmit: List[FleetRequest] = []   # C3 lanes to recycle
        self._next_rid = 0
        self.generation = 0
        self.dispatches = 0
        self.completed = 0
        self.c3_readmissions = 0
        self.scalar_reexecutions = 0             # stays 0: C3 is fleet-native
        self.harvested_steps = 0                 # steps of published attempts
        self.discarded_steps = 0                 # steps of faulted C3 attempts
        self.enosys_total = 0                    # -ENOSYS fall-throughs seen
        self.emul_served_total = 0               # guest-kernel-serviced svcs
        self.trace_records = 0                   # ring records published
        self.trace_dropped = 0                   # ring overflow drops
        # host-side observability (repro_torch.obs): None/False keeps the
        # server entirely unobserved — no registry, no spans, a shared null
        # phase timer — so the disabled path allocates nothing
        if isinstance(obs, ObsHub):
            self._obs: Optional[ObsHub] = obs
        else:
            enabled = bool(self.cfg.obs_enabled if obs is None else obs)
            self._obs = ObsHub(self.cfg) if enabled else None
        # policy scheduler (repro_torch.sched): None keeps every decision
        # point on the pre-scheduler code path, bit-identically
        self.sched = scheduler
        if self.sched is not None:
            self.sched.attach(self.cfg,
                              metrics=(self._obs.registry
                                       if self._obs is not None else None))
            if not self.trace_enabled and (
                    self.sched.ledger.budgets or self.cfg.budget_svc
                    or self.cfg.budget_deny or self.cfg.sched_deny_rate > 0):
                raise ValueError(
                    "budget/deny-rate scheduling is fed by the on-device "
                    "verdict counters in the trace carry: enable tracing "
                    "(FleetServer(trace=True) or cfg.trace_enabled)")
        self.preemptions = 0                     # lanes checkpointed for SLO
        self.evictions = 0                       # deny-rate/budget removals
        self.policy_updates = 0                  # live update_policy calls
        self.quarantine_blocks = 0               # admissions gated by backoff
        self.idle_generations = 0                # all-quarantined idle ticks
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._readmit_rids: set = set()          # C3 lanes mid-recycle
        self.dispatched_steps = 0                # lane-steps paid for
        self.executed_steps = 0                  # lane-steps actually run
        self.pool_grows = 0
        self.pool_shrinks = 0
        self._wait_gens: List[int] = []
        self._wait_s: List[float] = []
        # resume-wait ledger: re-admission latency of parked lanes
        # (preempted / budget-evicted / C3-recycled), kept separate from
        # the first-admission waits above — a request can appear in both
        self._resume_wait_gens: List[int] = []
        self._resume_wait_s: List[float] = []
        # durable serving (repro_torch.serve.durability) + chaos injection
        self.retries = 0                         # dispatch attempts re-run
        self.rollbacks = 0                       # carry rollbacks to snapshot
        self.shed_requests = 0                   # load-shed (rejected) reqs
        self.recovery_generations = 0            # generations replayed
        self.watchdog_trips = 0                  # wall-clock budget blown
        self.shed: List[dict] = []               # rejected-with-reason ledger
        self._dur = None                         # DurabilityManager
        self._chaos = None                       # ChaosMonkey

        # Physical lane pool.  ``_order[p]`` is the logical slot backed by
        # physical lane ``p``; the carry has width ``_W == len(_order)``.
        # Without compaction the mapping stays the identity at full pool
        # width; with it, generations run at the occupancy-chosen rung of
        # ``_ladder`` and the mapping tracks the compaction permutations so
        # every logical slot's request survives shrink/grow cycles.
        self._order = np.arange(pool)
        self._W = pool
        self._prev_icount = np.zeros(pool, np.int64)
        self._ladder = (F.compact_ladder(pool, self.cfg.compact_min_bucket)
                        if self.compact_enabled else [pool])
        self.min_bucket_seen = pool

        self._states = F.make_halted_states(pool, device=self.device)
        self._trace = (trace_recorder.make_trace_state(
            pool, self.cfg.trace_cap, device=self.device)
            if self.trace_enabled else None)
        # streaming trace pipeline: generations dispatch in <= trace_cap
        # step sub-spans with a half-flip + overlapped cold-half drain
        # between them, so rings never wrap and results publish from the
        # host-side stream instead of the on-device ring
        self._stream = (trace_stream.TraceStream(
            [trace_stream.make_writer(self.cfg.trace_sink)])
            if self.stream_enabled else None)
        # per-syscall x per-verdict totals of published requests, summed
        # from the on-device hist planes (no ring decode)
        self._hist_total = np.zeros((F.N_POLICY_SLOTS, F.N_VERDICTS),
                                    np.int64)
        # the fuel-0 dummy a vacated lane is parked with.  The JAX server
        # pads every admission to the bucket width (one executable a rung);
        # the port's kernel serves every width, so admissions are not
        # padded
        self._pad_state = M.make_state(0, fuel=0)
        # durability first (chaos.attach checks for it: bitflip/corruption
        # injection is only answerable with snapshots to roll back to)
        if durability is not None:
            self._dur = durability
            durability.attach(self)
        if chaos is not None:
            self._chaos = chaos
            chaos.attach(self)

    def precompile_ladder(self) -> List[int]:
        """Make every rung ready before serving (on the card: the kernel
        library is built or loaded once; one kernel serves every width);
        returns the ladder.  Optional — everything otherwise builds
        lazily."""
        F.precompile_ladder(
            self.table.images, self._ladder, chunk=self.chunk,
            interval=self.gen_steps,
            trace_cap=self.cfg.trace_cap if self.trace_enabled else None,
            engine=self.engine, device=self.device)
        return list(self._ladder)

    # -- request intake -------------------------------------------------------

    def submit(self, app: AppBuilder | PreparedProcess, *,
               mechanism: Mechanism = Mechanism.ASC,
               cfg: Optional[HookConfig] = None, virtualize: bool = False,
               fuel: Optional[int] = None,
               regs: Optional[Dict[int, int]] = None,
               policy: Optional[Sequence[PolicyRule]] = None,
               tenant: Optional[str] = None,
               priority: Optional[int] = None,
               deadline_steps: Optional[int] = None) -> int:
        """Queue one simulated process; returns its request id.

        ``app`` is either a zero-arg program builder (re-preparable: C3 can
        recycle the lane with the pinned config, exactly ``run_with_c3``'s
        loop) or an already-:func:`prepare`-d process (served as-is; a C3
        fault is then published rather than recycled).

        ``policy`` installs per-request seccomp-style rules
        (:class:`repro_torch.core.hookcfg.PolicyRule`, e.g. via the
        :mod:`repro_torch.trace.policy` constructors) for this lane only;
        it defaults to the request config's ``policy`` list.  Requires a
        traced server.  Rules are validated here — a malformed line raises
        ``ValueError`` naming the offending rule at submission time.

        ``tenant`` / ``priority`` / ``deadline_steps`` label the request
        for the policy scheduler (:mod:`repro_torch.sched`): the accounting
        principal for budgets/quarantine, the admission/preemption rank,
        and the latency SLO in simulated steps from submission.  Defaults
        come from the request config (``cfg.tenant`` etc.); without a
        ``scheduler=`` hook they are recorded but drive nothing.
        Scheduling kwargs are validated eagerly.  A durable server
        journals the request before any generation can see it, and
        refuses a builder it could not resolve again after a restart.
        """
        if tenant is not None and not isinstance(tenant, str):
            raise ValueError(
                f"tenant must be a string, got {type(tenant).__name__} "
                f"{tenant!r}")
        if priority is not None and (isinstance(priority, bool)
                                     or not isinstance(priority,
                                                       (int, np.integer))):
            raise ValueError(
                f"priority must be an int, got {type(priority).__name__} "
                f"{priority!r}")
        if deadline_steps is not None and (
                isinstance(deadline_steps, bool)
                or not isinstance(deadline_steps, (int, np.integer))
                or deadline_steps < 0):
            raise ValueError(
                f"deadline_steps must be a non-negative int (0 = no SLO), "
                f"got {type(deadline_steps).__name__} {deadline_steps!r}")
        if fuel is not None and (isinstance(fuel, bool)
                                 or not isinstance(fuel, (int, np.integer))
                                 or fuel < 1):
            raise ValueError(
                f"fuel must be a positive int, got {type(fuel).__name__} "
                f"{fuel!r}")
        rcfg = cfg or (self.cfg if isinstance(app, PreparedProcess) else
                       dataclasses.replace(self.cfg, pinned=list(self.cfg.pinned)))
        if policy is None and rcfg.policy:
            policy = rcfg.policy
        if policy is not None and not self.trace_enabled:
            raise ValueError(
                "per-request policies need a traced server "
                "(FleetServer(trace=True) or cfg.trace_enabled)")
        if (self.sched is not None and not self.trace_enabled
                and (rcfg.sched_deny_rate > 0 or rcfg.budget_svc
                     or rcfg.budget_deny)):
            # same rule as the constructor guard, for per-request configs:
            # enforcement is fed by counters that only exist when tracing
            raise ValueError(
                "budget/deny-rate scheduling in the request config is fed "
                "by the on-device verdict counters: enable tracing "
                "(FleetServer(trace=True) or cfg.trace_enabled)")
        if isinstance(app, PreparedProcess):
            if ((mechanism is not Mechanism.ASC
                 and mechanism is not app.mechanism)
                    or (virtualize and not app.virtualize)):
                raise ValueError(
                    "mechanism/virtualize come from the PreparedProcess "
                    "itself; pass a builder to prepare differently")
            pp, builder = app, None
            mechanism, virtualize = app.mechanism, app.virtualize
        else:
            builder = app
            if self._dur is not None:
                # a journaled request must be reconstructable: refuse an
                # unserialisable builder now, not at recovery time
                self._dur.check_builder(builder)
            pp = prepare(builder(), mechanism, virtualize=virtualize, cfg=rcfg)
        req = FleetRequest(
            rid=self._next_rid, pp=pp, builder=builder, cfg=rcfg,
            mechanism=mechanism, virtualize=virtualize,
            fuel=int(self.default_fuel if fuel is None else fuel), regs=regs,
            submitted_gen=self.generation, submitted_s=obs_now(),
            policy=(trace_policy.compile_policy(policy)
                    if policy is not None else None),
            tenant=str(rcfg.tenant if tenant is None else tenant),
            priority=int(rcfg.sched_priority if priority is None
                         else priority),
            deadline_steps=int(rcfg.sched_deadline_steps
                               if deadline_steps is None else deadline_steps))
        self._next_rid += 1
        req.attempts = 1
        self._tstat(req.tenant)["submitted"] += 1
        self._queue.append(req)
        if self._obs is not None:
            self._obs.spans.submit(str(req.rid), req.tenant or "default",
                                   req.submitted_s)
        if self._dur is not None:
            self._dur.on_submit(self, req)       # write-ahead: durable
            # before any generation can observe the request
        return req.rid

    def _restore_submit(self, req: FleetRequest) -> None:
        """Journal-replay intake: re-enqueue an already-journaled request
        without re-journaling it (repro_torch.serve.durability)."""
        self._next_rid = max(self._next_rid, req.rid + 1)
        self._tstat(req.tenant)["submitted"] += 1
        self._queue.append(req)
        if self._obs is not None:
            # span dedup makes this idempotent: a rid whose lifecycle the
            # snapshot already closed records nothing on replay
            self._obs.spans.submit(str(req.rid), req.tenant or "default",
                                   req.submitted_s)

    def update_policy(self, tenant: str,
                      rules: Sequence[PolicyRule]) -> int:
        """Swap a tenant's seccomp-style policy **live**: running lanes get
        the recompiled rows in place (:func:`repro_torch.core.fleet.
        update_policy_rows`) between spans — no eviction, bystander lanes
        bit-identical — and the tenant's queued / checkpointed /
        C3-recycling requests are updated so later (re-)admissions install
        the same rows.  Returns the number of running lanes updated.
        Requires a traced server; rules are validated up front.
        """
        if not self.trace_enabled:
            raise ValueError("update_policy needs a traced server "
                             "(FleetServer(trace=True) or cfg.trace_enabled)")
        compiled = trace_policy.compile_policy(rules)   # validates too
        lanes = [p for p in range(self._W)
                 if (r := self._slots[self._order[p]]) is not None
                 and r.tenant == tenant]
        if lanes:
            self._trace = F.update_policy_rows(self._trace, lanes,
                                               [compiled] * len(lanes))
        n_live = len(lanes)
        occupying = [r for r in self._slots if r is not None]
        for req in list(self._queue) + self._readmit + occupying:
            if req.tenant != tenant:
                continue
            req.policy = compiled
            if req.checkpoint is not None:       # patch the frozen carry too
                state, tr = req.checkpoint
                if tr is not None:
                    dev = tr.pol_action.device
                    tr = tr._replace(
                        pol_action=torch.tensor(compiled[0], dtype=torch.int32,
                                                device=dev),
                        pol_arg=torch.tensor(compiled[1], dtype=torch.int64,
                                             device=dev))
                req.checkpoint = (state, tr)
        self.policy_updates += 1
        self._tstat(tenant)["policy_updates"] += 1
        if self._dur is not None:
            self._dur.on_update_policy(self, tenant, list(rules))
        return n_live

    # -- the serving loop -----------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _occupied_lanes(self) -> int:
        return sum(1 for p in range(self._W)
                   if self._slots[self._order[p]] is not None)

    # -- the policy scheduler (repro_torch.sched) -----------------------------

    def _tstat(self, tenant: str) -> Dict[str, int]:
        if tenant not in self._tenants:
            self._tenants[tenant] = {
                "submitted": 0, "completed": 0, "svc": 0, "deny": 0,
                "emul": 0, "kill": 0, "enosys": 0, "killed": 0,
                "preemptions": 0, "evictions": 0, "budget_exhaustions": 0,
                "policy_updates": 0, "shed": 0}
        return self._tenants[tenant]

    def _charge(self, req: FleetRequest, svc: int, deny: int, emul: int,
                kill: int, enosys: int = 0) -> None:
        """Charge a lane's counter *deltas* (vs the request's last charge
        point) to the per-tenant stats and, when scheduling, the budget
        ledger; advances the charge point so preempt/resume cycles never
        double-count."""
        d_svc = svc - req.charged_svc
        d_deny = deny - req.charged_deny
        d_emul = emul - req.charged_emul
        d_kill = kill - req.charged_kill
        req.charged_svc, req.charged_deny = svc, deny
        req.charged_emul, req.charged_kill = emul, kill
        t = self._tstat(req.tenant)
        t["svc"] += d_svc
        t["deny"] += d_deny
        t["emul"] += d_emul
        t["kill"] += d_kill
        t["enosys"] += enosys
        if self.sched is not None:
            self.sched.ledger.charge(req.tenant, svc=d_svc, deny=d_deny,
                                     emul=d_emul, kill=d_kill, enosys=enosys)

    def _checkpoint_lane(self, p: int) -> FleetRequest:
        """Copy physical lane ``p``'s full carry (machine state + trace
        ring/policy/counters) onto its request and vacate the slot — the
        checkpoint preemption and eviction share.  The device lane itself
        is parked by the caller's park scatter, so the checkpoint must not
        be a view.  The image-table row stays referenced so re-admission
        is a pure restore."""
        req = self._slots[self._order[p]]
        state = _copy(F.unstack_state(self._states, p))
        tr = (_copy(F.unstack_trace(self._trace, p))
              if self._trace is not None else None)
        req.checkpoint = (state, tr)
        req.preemptions += 1
        req.parked_gen = self.generation
        req.parked_s = obs_now()
        if self._obs is not None:
            self._obs.spans.event(str(req.rid), "preempt",
                                  req.tenant or "default", req.parked_s)
        self._slots[self._order[p]] = None
        return req

    def _record_resume(self, req: FleetRequest, event: str) -> None:
        """Close a park interval on re-admission: generation + wall-clock
        resume waits into their own ledger (and, observed, the resume-wait
        histogram + a lifecycle span event)."""
        if req.parked_gen < 0:
            return
        t = obs_now()
        self._resume_wait_gens.append(self.generation - req.parked_gen)
        self._resume_wait_s.append(t - req.parked_s)
        if self._obs is not None:
            self._obs.registry.histogram(
                "server_resume_wait_seconds",
                "park (preempt/evict/C3) -> re-admission").observe(
                    max(0.0, t - req.parked_s))
            self._obs.spans.event(str(req.rid), event,
                                  req.tenant or "default", t)
        req.parked_gen, req.parked_s = -1, 0.0

    def _sched_pass(self) -> None:
        """Pre-generation scheduling: deny-rate evictions, budget
        exhaustion, and SLO preemption.  Checkpointed lanes are parked
        (one padded admission of halted dummies) so they stop executing
        until their request is re-admitted."""
        assert self.sched is not None
        gen = self.generation
        # running (preemptible) lanes: occupied, not mid-C3-recycle
        running = [(p, self._slots[self._order[p]])
                   for p in range(self._W)
                   if self._slots[self._order[p]] is not None
                   and self._slots[self._order[p]].rid
                   not in self._readmit_rids]
        to_checkpoint: List[int] = []
        checkpointed = set()

        # the counter readback (one host copy of four [B] rows) only pays
        # off when something is actually enforceable: a budget anywhere,
        # or a deny-rate threshold on any running request
        ledger = self.sched.ledger
        enforcing = bool(
            ledger.budgets or ledger.default.max_svc or ledger.default.max_deny
            or any(req.cfg.sched_deny_rate > 0 for _, req in running))
        if self._trace is not None and running and enforcing:
            cnt, deny, emul, kills = F._host_rows(
                self._trace.count, self._trace.deny_count,
                self._trace.emul_count, self._trace.kill_count)
            # deny-rate eviction: a lane whose DENY fraction this attempt
            # crosses its config threshold is checkpointed, re-queued and
            # its tenant quarantined (one offence per tenant per pass, so
            # a multi-lane tenant's streak escalates one doubling at a
            # time)
            evicted_tenants = set()
            for p, req in running:
                reason = self.sched.should_evict(req, int(cnt[p]),
                                                 int(deny[p]))
                if reason is None:
                    continue
                self._charge(req, int(cnt[p]), int(deny[p]), int(emul[p]),
                             int(kills[p]))
                self._checkpoint_lane(p)
                to_checkpoint.append(p)
                checkpointed.add(req.rid)
                self._queue.append(req)
                self.evictions += 1
                self._tstat(req.tenant)["evictions"] += 1
                if req.tenant not in evicted_tenants:
                    evicted_tenants.add(req.tenant)
                    self.sched.quarantine.punish(req.tenant, gen,
                                                 reason="eviction:" + reason)
            # budget exhaustion: window usage + uncharged in-flight deltas
            by_tenant: Dict[str, List] = {}
            for p, req in running:
                if req.rid not in checkpointed:
                    by_tenant.setdefault(req.tenant, []).append((p, req))
            for tenant, lanes in by_tenant.items():
                inflight_svc = sum(int(cnt[p]) - r.charged_svc
                                   for p, r in lanes)
                inflight_deny = sum(int(deny[p]) - r.charged_deny
                                    for p, r in lanes)
                reason = self.sched.exhausted(tenant, inflight_svc,
                                              inflight_deny)
                if reason is None:
                    continue
                for p, req in lanes:
                    self._charge(req, int(cnt[p]), int(deny[p]),
                                 int(emul[p]), int(kills[p]))
                    self._checkpoint_lane(p)
                    to_checkpoint.append(p)
                    checkpointed.add(req.rid)
                    self._queue.append(req)
                    self.evictions += 1
                    self._tstat(req.tenant)["evictions"] += 1
                self.sched.ledger.reset_window(tenant, generation=gen,
                                               reason=reason)
                self._tstat(tenant)["budget_exhaustions"] += 1
                self.sched.quarantine.punish(tenant, gen,
                                             reason="budget:" + reason)

        # SLO preemption: a deadline-risk queued request that would not
        # get a slot checkpoints the lowest-priority running lane below
        # its own priority
        ordered = self.sched.admission_order(list(self._queue), gen,
                                             self.gen_steps)
        n_free = len(self._free_slots())
        overflow = ordered[n_free:] if n_free < len(ordered) else []
        for cand in overflow:
            if cand.checkpoint is not None and cand.rid in checkpointed:
                continue                      # just evicted this pass
            if not self.sched.at_risk(cand, gen, self.gen_steps):
                continue
            live = [req for p, req in running
                    if req.rid not in checkpointed
                    and self._slots[req.slot] is req]
            victim = self.sched.pick_victim(cand, live)
            if victim is None:
                continue
            p = next(p for p, req in running if req is victim)
            if self._trace is not None and enforcing:
                # without enforcement the charge point stays put and the
                # final publish-time charge covers the whole attempt
                self._charge(victim, int(cnt[p]), int(deny[p]),
                             int(emul[p]), int(kills[p]))
            self._checkpoint_lane(p)
            to_checkpoint.append(p)
            checkpointed.add(victim.rid)
            self._queue.append(victim)
            self.preemptions += 1
            self._tstat(victim.tenant)["preemptions"] += 1

        if to_checkpoint:
            # park the vacated physical lanes (fuel-0 dummies): they stop
            # stepping and the harvest skips them (their slots are empty)
            self._prev_icount[to_checkpoint] = 0
            lanes = [self._pad_state] * len(to_checkpoint)
            if self._trace is None:
                self._states = F.admit_lanes(self._states, to_checkpoint,
                                             lanes)
            else:
                self._states, self._trace = F.admit_lanes(
                    self._states, to_checkpoint, lanes, trace=self._trace,
                    policies=[None] * len(lanes))

    def _grow_to(self, target: int) -> None:
        """Re-expand the pool up the ladder: pad the carry with all-halted
        lanes and back previously-compacted-away free slots."""
        add = target - self._W
        backed = set(int(s) for s in self._order)
        new_slots = [s for s in range(self.pool) if s not in backed][:add]
        assert len(new_slots) == add, "ladder grew past the free slots"
        pad_s = F.make_halted_states(add, device=self.device)
        if self._trace is None:
            self._states = F.concat_lanes(self._states, pad_s)
        else:
            pad_t = F.make_empty_trace(add, self._trace.buf.shape[2],
                                       device=self.device)
            self._states, self._trace = F.concat_lanes(
                (self._states, self._trace), (pad_s, pad_t))
        self._order = np.concatenate([self._order, np.asarray(new_slots)])
        self._prev_icount = np.concatenate(
            [self._prev_icount, np.zeros(add, np.int64)])
        self._W = target
        self.pool_grows += 1

    def _shrink_to(self, target: int) -> None:
        """Compact occupied lanes into a dense prefix (one
        gather-permutation over every carry leaf) and drop the free
        suffix; the dropped lanes carry no request state."""
        occ = np.asarray([self._slots[self._order[p]] is not None
                          for p in range(self._W)])
        perm = np.argsort(~occ, kind="stable")       # occupied lanes first
        keep, drop = perm[:target], perm[target:]
        if self._trace is None:
            self._states, _ = F.permute_split(self._states, keep, drop)
        else:
            (self._states, self._trace), _ = F.permute_split(
                (self._states, self._trace), keep, drop)
        self._order = self._order[keep]
        self._prev_icount = self._prev_icount[keep]
        self._W = target
        self.pool_shrinks += 1
        self.min_bucket_seen = min(self.min_bucket_seen, target)

    def _rebucket(self) -> None:
        """Pick the occupancy-chosen rung for the next generation:
        occupied lanes plus the demand about to be admitted, with the
        hysteresis margin guarding borderline shrinks."""
        if not self.compact_enabled:
            return
        occupied = self._occupied_lanes()
        if self.sched is None:
            admissible = len(self._queue)
        else:
            # quarantined tenants won't admit this generation: growing the
            # bucket for them would dispatch parked lanes all backoff long
            admissible = sum(
                1 for r in self._queue
                if not self.sched.quarantine.blocked(r.tenant,
                                                     self.generation))
        demand = min(admissible, self.pool - occupied)
        target = F.choose_bucket(
            self._ladder, occupied + demand, cur=self._W,
            hysteresis=self.cfg.compact_hysteresis)
        if target > self._W:
            self._grow_to(target)
        elif target < self._W:
            self._shrink_to(target)

    def _admit_pending(self) -> None:
        """Fill freed slots: C3 recycles first, then the request queue —
        one admission for the whole batch (the trace rings and
        policy tables recycle in the same call).  In a compacted pool the
        admission targets *physical* lanes; the pool was re-bucketed
        first, so every queued request that fits the pool has a backed
        lane waiting.

        With a scheduler the queue is taken in
        :meth:`repro_torch.sched.scheduler.PolicyScheduler.admission_order`
        (quarantine-gated, deadline-risk first, then priority) instead of
        FIFO, and checkpointed requests re-admit through a second, full
        restore (:func:`repro_torch.core.fleet.restore_lanes`) that
        resumes them bit for bit where preemption froze them."""
        phys_of = {int(s): p for p, s in enumerate(self._order)}
        lanes_idx, lanes, pols = [], [], []
        r_idx: List[int] = []                    # checkpoint restores
        r_states: List[M.MachineState] = []
        r_traces: List[F.TraceState] = []
        for req in self._readmit:                # slot already owned
            lanes_idx.append(phys_of[req.slot])
            lanes.append(initial_state(req.pp, fuel=req.fuel, regs=req.regs))
            pols.append(req.policy)
            self._ids[req.slot] = req.row
            self._fuel[req.slot] = req.fuel
            self._record_resume(req, "c3_readmit")
        self._readmit.clear()
        self._readmit_rids.clear()
        if self.sched is None:
            pending: Deque[FleetRequest] = self._queue
        else:
            ordered = self.sched.admission_order(
                list(self._queue), self.generation, self.gen_steps)
            if len(ordered) < len(self._queue):
                self.quarantine_blocks += 1
            pending = deque(ordered)
        for slot in self._free_slots():
            if not pending:
                break
            p = phys_of.get(slot)
            if p is None:
                continue                 # compacted-away slot: not backed
            req = None
            while pending:
                cand = pending[0]
                if cand.checkpoint is None:
                    try:
                        cand.row = self.table.admit(cand.pp)
                    except RuntimeError:
                        # table transiently full: rows free as lanes
                        # finish.  Without a scheduler the FIFO head
                        # blocks; with one, the blocked candidate is
                        # skipped (it stays in _queue) so checkpoint
                        # restores — which need no table row and
                        # eventually release theirs — and other tenants
                        # keep flowing instead of livelocking behind it.
                        if self.sched is None:
                            break
                        pending.popleft()
                        continue
                pending.popleft()
                req = cand
                break
            if req is None:
                break
            if self.sched is not None:
                self._queue.remove(req)
            req.slot = slot
            if req.admitted_gen < 0:     # first admission: latency metrics
                req.admitted_gen = self.generation
                req.admitted_s = obs_now()
                self._wait_gens.append(req.admitted_gen - req.submitted_gen)
                self._wait_s.append(req.admitted_s - req.submitted_s)
                if self._obs is not None:
                    self._obs.spans.event(str(req.rid), "admit",
                                          req.tenant or "default",
                                          req.admitted_s)
            else:
                # re-admission of a parked (preempted / evicted) lane:
                # its wait belongs to the resume histogram, not the
                # first-admission one above
                self._record_resume(req, "resume")
            self._slots[slot] = req
            self._ids[slot] = req.row
            self._fuel[slot] = req.fuel
            if req.checkpoint is not None:       # resume, don't restart
                state, tr = req.checkpoint
                req.checkpoint = None
                r_idx.append(p)
                r_states.append(state)
                r_traces.append(tr)
                continue
            lanes_idx.append(p)
            lanes.append(initial_state(req.pp, fuel=req.fuel, regs=req.regs))
            pols.append(req.policy)
        if lanes_idx:
            self._prev_icount[lanes_idx] = 0     # admitted lanes restart
            if self._trace is None:
                self._states = F.admit_lanes(self._states, lanes_idx, lanes)
            else:
                self._states, self._trace = F.admit_lanes(
                    self._states, lanes_idx, lanes, trace=self._trace,
                    policies=pols)
        if r_idx:
            # restored lanes resume their step counts (one host copy)
            self._prev_icount[r_idx] = torch.stack(
                [s.icount for s in r_states]).cpu().numpy()
            if self._trace is None:
                self._states = F.restore_lanes(self._states, r_idx, r_states)
            else:
                self._states, self._trace = F.restore_lanes(
                    self._states, r_idx, r_states, trace=self._trace,
                    lane_traces=r_traces)

    def _harvest(self) -> List[FleetResult]:
        halted, icount = F._host_rows(self._states.halted,
                                      self._states.icount)
        # occupancy ledger: lane-steps actually executed this generation vs
        # the lane-steps the dispatch paid for (bucket width x chunks run)
        delta = icount - self._prev_icount
        chunks_run = int(-(-int(delta.max()) // self.chunk)) if delta.max() \
            else 0
        self.dispatched_steps += self._W * chunks_run * self.chunk
        self.executed_steps += int(delta.sum())
        self._prev_icount = icount.copy()
        patched = F.finish_halt_codes(halted, icount, self._fuel[self._order])
        done = patched != M.RUNNING
        if done.any():  # one host copy per carry part, only when publishing
            if self._trace is None:
                enosys, emul_served = F._host_rows(
                    self._states.enosys_count, self._states.emul_served)
            else:
                (enosys, emul_served, trace_cnt, trace_deny, trace_emul,
                 trace_kill) = F._host_rows(
                    self._states.enosys_count, self._states.emul_served,
                    self._trace.count, self._trace.deny_count,
                    self._trace.emul_count, self._trace.kill_count)
                if self._stream is None:
                    # classic mode decodes rings from the carry; streamed
                    # lanes publish from the TraceStream, so the (large)
                    # double-buffer copy is skipped entirely
                    trace_buf = self._trace.buf.cpu().numpy()
                trace_hist = self._trace.hist.cpu().numpy()

        # batch C3 diagnosis over every faulted, recyclable lane at once
        # (indexed by physical lane, like the carry)
        c3_pps: List[Optional[PreparedProcess]] = [None] * self._W
        for i in range(self._W):
            req = self._slots[self._order[i]]
            if (req is not None and done[i]
                    and halted[i] == M.HALT_SEGV
                    and req.builder is not None and req.cfg.enable_c3):
                c3_pps[i] = req.pp
        events = (diagnose_c3_fleet(c3_pps, self._states, halted=halted)
                  if any(p is not None for p in c3_pps)
                  else [None] * self._W)

        results: List[FleetResult] = []
        published: List[int] = []        # the physical lane of each result
        for i in range(self._W):
            req = self._slots[self._order[i]]
            if req is None or not done[i]:
                continue
            ev = events[i]
            if ev is not None:
                # append to the "config file" (Figure 4) — even on the final
                # attempt, exactly as run_with_c3 does
                req.cfg.pin(lib=ev.lib, offset=ev.offset,
                            syscall_nr=ev.syscall_nr)
                req.events.append(ev)
            if ev is not None and req.attempts < req.cfg.serve_max_restarts:
                # trap -> config -> re-execute, without leaving the fleet.
                # Admission order guards against a transiently full table:
                # a solely-owned row is released first (its slot then serves
                # the re-prepared image); a shared row needs a spare slot,
                # and if none exists the fault is published instead of
                # corrupting the harvest.
                new_pp = prepare(req.builder(), req.mechanism,
                                 virtualize=req.virtualize, cfg=req.cfg)
                if self.table.refs(req.row) == 1:
                    self.table.release(req.row)
                    new_row = self.table.admit(new_pp)
                else:
                    try:
                        new_row = self.table.admit(new_pp)
                    except RuntimeError:
                        new_row = None
                    if new_row is not None:
                        self.table.release(req.row)
                if new_row is not None:
                    req.pp, req.row = new_pp, new_row
                    req.attempts += 1
                    self.discarded_steps += int(icount[i])
                    req.parked_gen = self.generation
                    req.parked_s = obs_now()
                    self._readmit.append(req)
                    self._readmit_rids.add(req.rid)
                    if self._stream is not None:
                        # the published trace must hold only the final
                        # attempt's records; the epoch bump keeps sink
                        # dedup correct across attempts
                        self._stream.reset(req.rid)
                    # a C3 recycle restarts the attempt from scratch and
                    # its ring counters reset with it: roll any usage the
                    # discarded attempt already charged (at a preemption /
                    # budget checkpoint) back OUT of the ledger, or the
                    # replay would double-bill the same syscalls
                    self._charge(req, 0, 0, 0, 0)
                    self.c3_readmissions += 1
                    continue
            if self._trace is None:
                recs, dropped = [], 0
                hist = {}
            else:
                if self._stream is not None:
                    # streamed dispatch ends every generation with a flip,
                    # so the lane's full record stream already sits in the
                    # sink — publish is a pop, not a device decode
                    recs, dropped = self._stream.pop(req.rid)
                else:
                    recs, dropped = trace_recorder.harvest_lane(
                        trace_buf[i], trace_cnt[i])
                hist = trace_recorder.lane_histogram(trace_hist[i])
                self._hist_total += trace_hist[i]
            results.append(FleetResult(
                rid=req.rid, state=None, events=req.events,
                attempts=req.attempts, submitted_gen=req.submitted_gen,
                admitted_gen=req.admitted_gen, completed_gen=self.generation,
                admission_wait_gens=req.admitted_gen - req.submitted_gen,
                admission_wait_s=req.admitted_s - req.submitted_s,
                trace=recs, trace_dropped=dropped, histogram=hist,
                tenant=req.tenant, preemptions=req.preemptions))
            published.append(i)
            self.harvested_steps += int(icount[i])
            self.enosys_total += int(enosys[i])
            self.emul_served_total += int(emul_served[i])
            self.trace_records += len(recs)
            self.trace_dropped += dropped
            self.completed += 1
            if self._obs is not None:
                self._obs.spans.event(str(req.rid), "complete",
                                      req.tenant or "default")
            if self._trace is not None:
                self._charge(req, int(trace_cnt[i]), int(trace_deny[i]),
                             int(trace_emul[i]), int(trace_kill[i]),
                             enosys=int(enosys[i]))
            else:
                self._charge(req, req.charged_svc, req.charged_deny,
                             req.charged_emul, req.charged_kill,
                             enosys=int(enosys[i]))
            t = self._tstat(req.tenant)
            t["completed"] += 1
            if self.sched is not None:
                if patched[i] == M.HALT_KILL:
                    t["killed"] += 1
                    self.sched.quarantine.punish(req.tenant, self.generation,
                                                 reason="halt_kill")
                elif patched[i] == M.HALT_EXIT:
                    self.sched.quarantine.clear(req.tenant)
            elif patched[i] == M.HALT_KILL:
                t["killed"] += 1
            self.table.release(req.row)
            self._slots[self._order[i]] = None
        if published:
            # the published lanes, gathered into fresh tensors (the carry's
            # own lanes are reused by the next admission), with the
            # host-side HALT_FUEL patch of lanes out of fuel
            idx = torch.tensor(published, device=self.device)
            pub = M.MachineState(*(x.index_select(0, idx)
                                   for x in self._states))
            pub.halted.copy_(torch.from_numpy(patched[published]))
            for j, r in enumerate(results):
                r.state = F.unstack_state(pub, j)
        return results

    def _phase(self, name: str):
        """Phase timer against this server's hub (a shared no-op when
        observation is off)."""
        return obs_phase(self._obs, name)

    def _dispatch(self, ids: np.ndarray) -> None:
        if self._trace is None:
            with self._phase("dispatch"):
                self._states = F.run_fleet_span(
                    self.table.images, self._states, ids,
                    steps=self.gen_steps, chunk=self.chunk,
                    engine=self.engine, device=self.device)
        elif self._stream is None:
            with self._phase("dispatch"):
                self._states, self._trace = F.run_fleet_span(
                    self.table.images, self._states, ids,
                    steps=self.gen_steps, chunk=self.chunk, trace=self._trace,
                    engine=self.engine, device=self.device)
        else:
            self._dispatch_streamed(ids)

    def _dispatch_streamed(self, ids: np.ndarray) -> None:
        """The generation as sub-spans of at most ``trace_cap`` steps with
        a ring half-flip between them: a half can never wrap inside a
        sub-span (worst case one record per step), so every record reaches
        the stream — zero drops at fixed ring capacity.  Each cold half
        goes to pinned host memory behind an event and is decoded after
        the NEXT sub-span's launches are queued, waiting on its event
        first, so the copy overlaps device compute."""
        interval = F.stream_interval(self.cfg.trace_cap, self.chunk)
        keys = [self._slots[self._order[p]].rid
                if self._slots[self._order[p]] is not None else None
                for p in range(self._W)]
        left = self.gen_steps
        pending = None
        while left > 0:
            steps = min(interval, left)
            with self._phase("dispatch"):
                self._states, self._trace = F.run_fleet_span(
                    self.table.images, self._states, ids,
                    steps=steps, chunk=self.chunk, trace=self._trace,
                    engine=self.engine, device=self.device)
            if pending is not None:
                with self._phase("stream_flush"):
                    self._stream.push_block(keys, F._landed(*pending[0]),
                                            *pending[1:])
            with self._phase("dispatch"):
                self._trace, cold, counts, bases = F.flip_trace(self._trace)
                pending = (F._to_host_async(cold), counts, bases)
            left -= steps
        with self._phase("stream_flush"):
            self._stream.push_block(keys, F._landed(*pending[0]),
                                    *pending[1:])
            self._stream.flush()

    def _drop_request(self, req: FleetRequest, reason: str) -> None:
        """Load-shed one queued request: reject-with-reason, releasing any
        image-table row its frozen checkpoint still holds."""
        if req.checkpoint is not None and req.row >= 0:
            self.table.release(req.row)
        if self._stream is not None:
            self._stream.pop(req.rid)  # release any buffered records
        self.shed.append({"rid": req.rid, "tenant": req.tenant,
                          "reason": reason, "generation": self.generation})
        if self._obs is not None:
            self._obs.spans.event(str(req.rid), "shed",
                                  req.tenant or "default")
        self.shed_requests += 1
        self._tstat(req.tenant)["shed"] += 1
        if self._dur is not None:
            self._dur.on_shed(self, req, reason)

    def _shed_queue(self, reason: str) -> None:
        """Reject every queued request (retries exhausted: the server
        cannot currently dispatch, so holding the queue would just
        time-out clients silently)."""
        while self._queue:
            self._drop_request(self._queue.popleft(), reason)

    def _apply_shed(self, rid: int, reason: str) -> None:
        """Journal-replay twin of a shed record."""
        for req in list(self._queue):
            if req.rid == rid:
                self._queue.remove(req)
                self._drop_request(req, reason)
                return

    def _skip_generation(self, reason: str) -> None:
        """Tick the generation clock without dispatching — the
        retries-exhausted path.  ``gen_steps`` invariance makes a skipped
        dispatch semantics-free: lanes just run those steps in a later
        generation."""
        self.generation += 1
        self.idle_generations += 1

    def _replay_skipped_generation(self) -> None:
        """Journal-replay twin of a skipped generation: the pre-dispatch
        phases (scheduling, re-bucket, admissions) DID run live before
        the dispatch gave up, so replay must run them too — otherwise
        admission timing (``admitted_gen``) would diverge."""
        if self.sched is not None:
            self._sched_pass()
        self._rebucket()
        self._admit_pending()
        self._skip_generation("replay")

    def _adopt(self, other: "FleetServer") -> None:
        """Become ``other`` (a replica recovered from disk on the same
        device): the chaos rollback path.  Durability/chaos wiring and
        cumulative chaos-era counters stay ours; everything the replay
        rebuilt — carry, image table, stream, slots, queue, scheduler,
        tenant stats — is taken wholesale.  The replica's carry becomes
        ours, not a copy: nothing else holds it once the replica is
        dropped, and every span builds the kernel's arguments (pointers
        and decode table) anew from the carry it is given."""
        keep = {"_dur", "_chaos", "retries", "rollbacks", "shed_requests",
                "recovery_generations", "watchdog_trips",
                # the live hub's counters/spans are cumulative (and
                # monotone); the replica's replay-era copy would regress
                # the phase timings the corrupted window already recorded
                "_obs"}
        for k, v in other.__dict__.items():
            if k not in keep:
                self.__dict__[k] = v

    def step(self) -> List[FleetResult]:
        """One generation: scheduler pass (evict/exhaust/preempt) ->
        re-bucket -> admit -> one bounded dispatch at the occupancy-chosen
        width -> harvest.

        With chaos attached the dispatch is wrapped in a bounded
        exponential-backoff retry loop: injected faults (raised *before*
        the generation's first launch, so the carry is untouched) are
        retried up to ``cfg.chaos_max_retries`` extra attempts, then the
        queue is load-shed with a reason and the generation skipped.  A
        real error (a failed build or launch, a CUDA error) is never
        chaos: it is raised, not retried.  With durability attached every
        generation (dispatched, idle or skipped) is journaled so replay
        re-walks the same sequence.

        An observed server (``repro_torch.obs``) times the whole generation
        and each stage of it through the phase profiler, refreshes the
        ledger gauges, and gives the snapshot sink a chance to write — all
        host-side bookkeeping; published states stay bit-identical."""
        if self._obs is None:
            return self._step()
        t0 = obs_now()
        self._obs.gen_begin(t0)
        try:
            return self._step()
        finally:
            self._obs.maybe_snapshot()
            self._refresh_gauges()
            self._obs.gen_end(t0)

    def _step(self) -> List[FleetResult]:
        if self.sched is not None:
            with self._phase("sched_pass"):
                self._sched_pass()
        with self._phase("rebucket"):
            self._rebucket()
        with self._phase("admission"):
            self._admit_pending()
        if all(r is None for r in self._slots):
            if self.sched is not None and (self._queue or self._readmit):
                # every queued tenant is waiting out quarantine: tick the
                # generation clock so backoffs expire (no dispatch)
                self.generation += 1
                self.idle_generations += 1
                if self._dur is not None:
                    return self._dur.after_generation(self, [])
            return []
        ids = self._ids[self._order]
        if self._dur is not None:
            with self._phase("journal_append"):
                self._dur.before_dispatch(self)
        skipped = False
        if self._chaos is None:
            self._dispatch(ids)
        else:
            tries, faults = 0, []
            while True:
                try:
                    # faults fire before the first launch: the kernel
                    # writes the carry in place, so a retry must start
                    # from an untouched one
                    self._chaos.pre_dispatch(self)
                    self._dispatch(ids)
                    if faults:
                        self._chaos.resolve(faults, "retried")
                    break
                except Exception as e:
                    kind = getattr(e, "chaos_kind", None)
                    if kind is None:
                        raise                    # a real error, not chaos
                    faults.append(e.injection_id)
                    if kind == "watchdog":
                        self.watchdog_trips += 1
                    tries += 1
                    self.retries += 1
                    if tries > self.cfg.chaos_max_retries:
                        self._chaos.resolve(faults, "shed")
                        self._shed_queue(f"retries_exhausted:{kind}")
                        skipped = True
                        break
                    with self._phase("retry_backoff"):
                        time.sleep(self.cfg.chaos_backoff_base_ms
                                   * (1 << (tries - 1)) / 1000.0)
        if skipped:
            self._skip_generation("retries_exhausted")
            results: List[FleetResult] = []
        else:
            self.dispatches += 1
            self.generation += 1
            if self._obs is not None:
                # split the device wait out of the harvest readbacks so the
                # breakdown separates "the card still computing" from
                # "host-side publish work" (harvest would block on its
                # first copy anyway: this moves the wait, it does not add
                # one)
                with self._phase("device_sync"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            with self._phase("harvest"):
                results = self._harvest()
        if self._dur is not None:
            results = self._dur.after_generation(self, results,
                                                 skipped=skipped)
        return results

    @classmethod
    def recover(cls, directory, *, builders: Optional[Dict] = None,
                chaos=None, fsync: Optional[bool] = None, device=None):
        """Rebuild a crashed durable server from its durability directory
        on ``device`` (``None`` means the card); returns ``(server,
        replayed_results)``.  See :func:`repro_torch.serve.durability.
        recover`."""
        from . import durability as D
        return D.recover(directory, builders=builders, chaos=chaos,
                         fsync=fsync, device=device)

    def run(self, max_generations: int = 1_000_000) -> List[FleetResult]:
        """Serve until the queue and every lane drain; results in
        completion order.  On exceeding ``max_generations`` the raised
        error carries the already-published results as ``.results``."""
        out: List[FleetResult] = []
        for _ in range(max_generations):
            if (not self._queue and not self._readmit
                    and all(r is None for r in self._slots)):
                break
            out.extend(self.step())
        else:
            err = RuntimeError(
                f"max_generations ({max_generations}) exceeded with "
                f"{len(out)} results already published")
            err.results = out
            raise err
        return out

    def follow(self, max_generations: int = 1_000_000):
        """Serve like :meth:`run` but yield strace-style lines live, in
        emission order across the whole fleet — the ``strace -f`` view of
        a streamed server.  Each generation's flipped halves drain into
        the stream sink and are rendered as ``[rid <key>] <record>``
        between steps.  Requires streaming (``trace_stream`` /
        ``stream=``).

        Published results accumulate on ``self.follow_results`` (completion
        order, same :class:`FleetResult` objects :meth:`run` would return),
        since the generator's yields are spoken for by the trace lines."""
        if self._stream is None:
            raise ValueError("follow() needs the streaming pipeline: "
                             "construct with stream=True (or set "
                             "cfg.trace_stream)")
        self._stream.enable_follow()
        self.follow_results: List[FleetResult] = []
        for _ in range(max_generations):
            if (not self._queue and not self._readmit
                    and all(r is None for r in self._slots)):
                break
            self.follow_results.extend(self.step())
            for key, seq, rec in self._stream.drain_follow():
                yield f"[rid {key}] " + trace_recorder.format_record(rec)
        else:
            raise RuntimeError(f"max_generations ({max_generations}) "
                               f"exceeded in follow()")

    # -- telemetry ------------------------------------------------------------

    def stats(self) -> dict:
        waits_g = self._wait_gens or [0]
        waits_s = self._wait_s or [0.0]
        r_gens = self._resume_wait_gens or [0]
        r_s = self._resume_wait_s or [0.0]
        return {
            "pool": self.pool,
            "gen_steps": self.gen_steps,
            "generations": self.generation,
            "dispatches": self.dispatches,
            "completed": self.completed,
            "harvested_steps": self.harvested_steps,
            "discarded_steps": self.discarded_steps,
            "c3_readmissions": self.c3_readmissions,
            "scalar_reexecutions": self.scalar_reexecutions,
            "image_admissions": self.table.admissions,
            "image_dedup_hits": self.table.dedup_hits,
            "enosys_total": self.enosys_total,
            "emul_served_total": self.emul_served_total,
            "trace_enabled": self.trace_enabled,
            "trace_records": self.trace_records,
            "trace_dropped": self.trace_dropped,
            "trace_stream": self.stream_enabled,
            "stream": (self._stream.stats()
                       if self._stream is not None else {}),
            "trace_histogram": trace_recorder.lane_histogram(
                self._hist_total),
            "compact_enabled": self.compact_enabled,
            "ladder": list(self._ladder),
            "bucket_width": self._W,
            "min_bucket_seen": self.min_bucket_seen,
            "pool_grows": self.pool_grows,
            "pool_shrinks": self.pool_shrinks,
            "dispatched_steps": self.dispatched_steps,
            "executed_steps": self.executed_steps,
            "wasted_steps": self.dispatched_steps - self.executed_steps,
            "occupancy": round(self.executed_steps / self.dispatched_steps, 4)
            if self.dispatched_steps else 1.0,
            "admission_waits": len(self._wait_gens),
            "admission_wait_gens_mean": float(np.mean(waits_g)),
            "admission_wait_gens_max": int(np.max(waits_g)),
            "admission_wait_ms_mean": 1e3 * float(np.mean(waits_s)),
            "admission_wait_ms_max": 1e3 * float(np.max(waits_s)),
            # re-admission latency of parked lanes (preempt/evict/C3),
            # recorded separately from the first-admission waits above
            "resume_waits": len(self._resume_wait_gens),
            "resume_wait_gens_mean": float(np.mean(r_gens)),
            "resume_wait_gens_max": int(np.max(r_gens)),
            "resume_wait_ms_mean": 1e3 * float(np.mean(r_s)),
            "resume_wait_ms_max": 1e3 * float(np.max(r_s)),
            # policy scheduler (repro_torch.sched) + per-tenant accounting
            "scheduler_enabled": self.sched is not None,
            "preemptions": self.preemptions,
            "evictions": self.evictions,
            "policy_updates": self.policy_updates,
            "quarantine_blocks": self.quarantine_blocks,
            "idle_generations": self.idle_generations,
            "tenants": {t: dict(v) for t, v in self._tenants.items()},
            "budget_exhaustions": (len(self.sched.ledger.events)
                                   if self.sched is not None else 0),
            "budget_events": (list(self.sched.ledger.events)
                              if self.sched is not None else []),
            "quarantine": (self.sched.quarantine.state()
                           if self.sched is not None else None),
            # durable serving (repro_torch.serve.durability) + chaos
            "durability_enabled": self._dur is not None,
            "chaos_enabled": self._chaos is not None,
            "retries": self.retries,
            "rollbacks": self.rollbacks,
            "shed_requests": self.shed_requests,
            "shed": [dict(s) for s in self.shed],
            "recovery_generations": self.recovery_generations,
            "watchdog_trips": self.watchdog_trips,
            "snapshots": (self._dur.snapshots if self._dur else 0),
            "snapshot_bytes": (self._dur.snapshot_bytes if self._dur else 0),
            "snapshot_rewrites": (self._dur.snapshot_rewrites
                                  if self._dur else 0),
            "journal_records": (self._dur.journal.records
                                if self._dur and self._dur.journal else 0),
            "chaos": (self._chaos.summary() if self._chaos else None),
            "obs_enabled": self._obs is not None,
        }

    def _refresh_gauges(self) -> None:
        """Mirror the serving ledgers into the registry so one scrape
        covers occupancy, step accounting, pool geometry, quarantine
        pressure and journal growth."""
        ob = self._obs
        if ob is None:
            return
        g = ob.registry.gauge
        g("server_occupancy",
          "executed / dispatched lane-steps").set(
            self.executed_steps / self.dispatched_steps
            if self.dispatched_steps else 1.0)
        g("server_dispatched_steps", "lane-steps paid for").set(
            self.dispatched_steps)
        g("server_executed_steps", "lane-steps actually run").set(
            self.executed_steps)
        g("server_bucket_width", "current compaction rung").set(self._W)
        g("server_pool_lanes", "configured pool width").set(self.pool)
        g("server_queue_depth", "requests waiting for a lane").set(
            len(self._queue))
        g("server_occupied_lanes", "lanes running a request").set(
            self._occupied_lanes())
        g("server_generation", "generation clock").set(self.generation)
        g("server_completed", "requests published").set(self.completed)
        if self.sched is not None:
            g("sched_quarantine_depth",
              "tenants waiting out backoff").set(
                self.sched.quarantine.depth(self.generation))
        if self._dur is not None and self._dur.journal is not None:
            g("journal_bytes", "write-ahead journal size").set(
                self._dur.journal.bytes_written)
            g("journal_records", "write-ahead journal records").set(
                self._dur.journal.records)

    def metrics(self, fmt: str = "dict"):
        """The observability surface (``repro_torch.obs``): the registry
        view plus the phase breakdown and span summary.

        ``fmt="dict"`` returns a JSON-able snapshot — counters, gauges,
        histogram summaries, per-phase wall-clock breakdown with its
        coverage ratio (the share of generation time the phases explain),
        and the request-span summary with per-tenant latency percentiles.
        ``fmt="prometheus"`` returns the text exposition format instead.
        An unobserved server returns ``{}`` / ``""``."""
        if self._obs is None:
            return "" if fmt == "prometheus" else {}
        self._refresh_gauges()
        if fmt == "prometheus":
            return self._obs.registry.render_prometheus()
        if fmt != "dict":
            raise ValueError(
                f"metrics fmt must be 'dict' or 'prometheus', got {fmt!r}")
        snap = self._obs.registry.snapshot()
        b = self._obs.profiler.breakdown()
        snap["phases"] = b["phases"]
        snap["generation"] = b["generation"]
        snap["phase_coverage"] = b["coverage"]
        snap["spans"] = self._obs.spans.summary()
        snap["sink_writes"] = self._obs.sink_writes
        return snap
