"""The completeness-strategy configuration file (paper §3.3).

The paper drives its completeness strategies from a config file: which svc
sites must be intercepted via signals, whether to use ``brk`` or an illegal
instruction, and which strategies are enabled.  Sites can be pinned by
(library, offset) — the shareable form, valid for every process using the
same library build — or by raw virtual address, or by syscall number.
Strategy C3 *appends* to this file at fault time and the application is
re-executed (Figure 4).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List, Optional


@dataclasses.dataclass
class PinnedSite:
    lib: str = ""
    offset: int = -1
    vaddr: int = -1
    syscall_nr: int = -1

    def matches(self, lib: str, offset: int, vaddr: int) -> bool:
        if self.vaddr >= 0:
            return self.vaddr == vaddr
        if self.lib and self.offset >= 0:
            return self.lib == lib and self.offset == offset
        return False


@dataclasses.dataclass
class PolicyRule:
    """One seccomp-style filter line of the config file (repro.trace).

    ``syscall_nr`` selects the syscall (-1 = every syscall, i.e. the
    default-action line; an unmodelled number selects the whole UNKNOWN
    class).  ``action`` is one of ``allow`` / ``deny`` / ``emulate`` /
    ``kill``; ``arg`` carries the errno (deny) or the constant return
    value (emulate).  Later rules override earlier ones, like seccomp's
    last-match-wins filter programs.
    """

    syscall_nr: int = -1
    action: str = "allow"
    arg: int = 0


@dataclasses.dataclass
class HookConfig:
    # Paper default: completeness strategies are OFF (pure-R1/R2 fast path,
    # "the primary purpose of our Completeness policy is for insurance").
    # We default the *static* strategies ON because they are free at rewrite
    # time; flip them off to measure the paper's default posture.
    enable_c1: bool = True   # static: missing x8 assignment / broken ABI
    enable_c2: bool = True   # static: direct-jump target between the pair
    enable_c3: bool = True   # dynamic: trap -> config -> re-exec (Figure 4)
    use_brk: bool = True     # brk vs illegal instruction for R3 sites
    backward_window: int = 20  # paper: "the preceding 20 instructions"
    max_l1_slots: int = 3840   # paper's slot budget; lower it to force R2
    # Fleet engine: steps per inner lax.scan chunk.  Loop-condition checks
    # (and with them host round-trips) happen once per chunk; results are
    # invariant to this value, only dispatch count changes.
    fleet_chunk: int = 8
    # Which chunk dispatcher the fleet entry points use: "xla" (the
    # lax.scan select-chain) or "pallas" (the fused megastep kernel,
    # repro.kernels.megastep; interpret-mode on CPU).  Both run the same
    # spec-generated executor body, so results are bit-identical — this
    # only changes how the inner loop is dispatched.
    fleet_engine: str = "xla"
    # Continuous-batching server (serve.fleet_server): masked steps per
    # generation (harvest/admission happens between generations; results
    # are invariant, only scheduling granularity changes) and the C3
    # re-admission cap per request (the serving analogue of run_with_c3's
    # max_restarts).
    serve_gen_steps: int = 256
    serve_max_restarts: int = 4
    # Live-lane compaction (fleet.run_fleet_compact / FleetServer): when
    # enabled, a fleet compacts still-live lanes into a dense prefix at
    # chunk boundaries and re-dispatches at the narrowest power-of-two
    # bucket width >= the live count, down to compact_min_bucket (every
    # rung is a precompiled executable — no mid-run XLA compiles).
    # compact_hysteresis is the shrink margin: a rung is only taken when
    # the live count also clears rung * (1 - hysteresis), which keeps a
    # serving pool from oscillating when admissions re-expand it.
    # Results are bit-identical and lane-ordered either way.
    compact_enabled: bool = False
    compact_min_bucket: int = 8
    compact_hysteresis: float = 0.125
    # Syscall tracing + policy subsystem (repro.trace): ring capacity per
    # lane, whether the serving layer (FleetServer) traces by default —
    # fleet entry points only trace on an explicit trace= argument, so
    # their return arity never depends on config state — and the default
    # seccomp-style policy (empty = allow everything, which keeps traced
    # machine states bit-identical to untraced runs).
    trace_enabled: bool = False
    trace_cap: int = 64
    # Streaming trace pipeline (repro.trace.stream): when trace_stream is
    # on, a traced FleetServer dispatches each generation in sub-spans of
    # at most trace_cap steps, flipping the double-buffered rings between
    # them and draining the cold halves into a host-side TraceStream —
    # zero dropped records at fixed ring capacity (the classic mode keeps
    # the single-ring drop-oldest contract).  trace_sink selects the
    # stream's writer: "" = in-memory reassembly only, "memory" = a
    # MemoryWriter, anything else = a JSONL file path appended to as
    # records emit (exactly-once by (key, epoch, seq) across crash
    # recovery).
    trace_stream: bool = False
    trace_sink: str = ""
    # Guest-kernel emulation (repro.emul): when on, lanes carry a per-lane
    # fd table + in-memory filesystem and openat/close/read/write/lseek/
    # dup/fstat/pipe2/getrandom/ioctl get real semantics; when off, lanes
    # reproduce the legacy stubs exactly (openat -> 3, close -> 0, the
    # rest -> -ENOSYS).  Per-lane gate: mixed fleets are fine.
    emul_enabled: bool = True
    # Policy-driven serving scheduler (repro.sched / FleetServer).  The
    # tenant label is the accounting principal: per-tenant verdict counts,
    # syscall/deny budgets, quarantine and live policy updates all key on
    # it ("" = the anonymous default tenant).  Budgets of 0 are unlimited;
    # an exhausted tenant's lanes are checkpointed, re-queued and the
    # tenant backs off (its usage window then resets — throttling, not a
    # permanent ban, so serving always drains).  sched_deadline_steps is
    # the latency SLO in simulated steps from submission (0 = none);
    # sched_slo_margin_gens is how many generations before the deadline a
    # queued request counts as at-risk (eligible to preempt a
    # lower-priority lane).  sched_deny_rate evicts a lane whose
    # DENY-verdict fraction exceeds it (0.0 = off; only judged past
    # sched_deny_min_svc syscalls so short bursts don't trip it).
    # Quarantine backoff after a HALT_KILL / eviction is exponential:
    # base * 2^(streak-1) generations, capped.
    tenant: str = ""
    sched_priority: int = 0
    sched_deadline_steps: int = 0
    sched_slo_margin_gens: int = 2
    budget_svc: int = 0
    budget_deny: int = 0
    sched_deny_rate: float = 0.0
    sched_deny_min_svc: int = 8
    sched_backoff_base: int = 2
    sched_backoff_cap: int = 64
    # Durable serving (repro.serve.durability / FleetServer(durability=)).
    # snapshot_interval is the generation cadence of full-fleet snapshots
    # (0 = journal-only: recovery then replays the whole journal from the
    # initial state); snapshot_keep bounds the snapshot directory like
    # CheckpointManager's keep-k GC.  journal_fsync controls whether the
    # write-ahead journal fsyncs at its commit points (one group-fsync per
    # generation, not one per record); turning it off trades crash
    # durability for write latency, e.g. in soak tests on slow disks.
    snapshot_interval: int = 8
    snapshot_keep: int = 3
    journal_fsync: bool = True
    # Wall-clock generation watchdog (seconds; 0 = off): a generation that
    # has already blown this budget before its dispatch launches is failed
    # and retried like any other dispatch fault.
    serve_watchdog_s: float = 0.0
    # Chaos fault injection (repro.serve.chaos / FleetServer(chaos=)).
    # Rates are per-opportunity probabilities drawn from a deterministic
    # generator seeded by chaos_seed: dispatch faults and hangs are drawn
    # once per dispatch attempt, snapshot corruption and lane-carry
    # bit-flips once per snapshot written.  Faults are answered by bounded
    # exponential-backoff retry (chaos_max_retries extra attempts,
    # chaos_backoff_base_ms doubling per attempt), lane rollback to the
    # last snapshot, quarantine escalation, and load-shedding.
    chaos_seed: int = 0
    chaos_dispatch_fault_rate: float = 0.0
    chaos_hang_rate: float = 0.0
    chaos_bitflip_rate: float = 0.0
    chaos_snapshot_corrupt_rate: float = 0.0
    chaos_max_retries: int = 3
    chaos_backoff_base_ms: int = 1
    # Host-side observability (repro.obs / FleetServer.metrics()).  When
    # obs_enabled a server carries an ObsHub: a metrics registry with
    # counters/gauges/log-bucketed histograms, a generation-loop phase
    # profiler, and per-request lifecycle spans — all on the monotonic
    # obs.now() clock, never steering results (obs-on states are
    # bit-identical to obs-off; benchmarks/obs_overhead.py prices the
    # layer).  obs_sink selects a push target ("" = pull-only via
    # metrics(); "memory"; "jsonl:<path>" or a *.jsonl path; or
    # "prom:<path>" for a Prometheus textfile) — anything else raises
    # ValueError naming the value.  obs_snapshot_interval_s throttles
    # sink writes to at most one per interval at generation boundaries
    # (0 = only explicit/final writes).
    obs_enabled: bool = False
    obs_sink: str = ""
    obs_snapshot_interval_s: float = 0.0
    policy: List[PolicyRule] = dataclasses.field(default_factory=list)
    pinned: List[PinnedSite] = dataclasses.field(default_factory=list)

    # -- persistence -----------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict (the exact shape :meth:`from_dict` accepts).
        Hand-rolled rather than ``dataclasses.asdict``: the only nested
        dataclasses are ``policy``/``pinned``, and the recursive deep
        copy is ~10x slower — this sits on the durable server's
        per-request journal path."""
        d = dict(self.__dict__)
        d["policy"] = [dataclasses.asdict(r) for r in self.policy]
        d["pinned"] = [dataclasses.asdict(p) for p in self.pinned]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HookConfig":
        d = dict(d)
        pins = [PinnedSite(**x) for x in d.pop("pinned", [])]
        rules = [PolicyRule(**x) for x in d.pop("policy", [])]
        return cls(pinned=pins, policy=rules, **d)

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "HookConfig":
        p = pathlib.Path(path)
        if not p.exists():
            return cls()
        return cls.from_dict(json.loads(p.read_text()))

    def pin(self, *, lib: str = "", offset: int = -1, vaddr: int = -1,
            syscall_nr: int = -1) -> None:
        site = PinnedSite(lib=lib, offset=offset, vaddr=vaddr, syscall_nr=syscall_nr)
        if not any(p == site for p in self.pinned):
            self.pinned.append(site)

    def is_pinned(self, lib: str, offset: int, vaddr: int) -> bool:
        return any(p.matches(lib, offset, vaddr) for p in self.pinned)
