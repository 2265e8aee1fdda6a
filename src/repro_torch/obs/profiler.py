"""Phase profiler for the FleetServer generation loop (repro_torch.obs).

Answers "where does a generation's wall-clock go" the way ASC-Hook's
cycle-breakdown tables answer "where do a hook's cycles go": every
stage of ``FleetServer.step()`` runs inside a named phase —

    sched_pass      policy admission ordering / preemption / eviction
    rebucket        compaction permute + ladder re-dispatch prep
    admission       pending-queue scatter into free lanes
    dispatch        the generation's megastep launches (the CUDA kernel)
    device_sync     torch.cuda.synchronize on the card (obs-only split)
    harvest         device->host readback, publish, C3 diagnose
    stream_flush    cold-half trace drain into the TraceStream
    journal_append  write-ahead journal group commit
    snapshot_write  full-fleet snapshot
    rollback_verify chaos-mode replay-verify at snapshot boundaries
    retry_backoff   chaos retry sleeps
    obs_snapshot    sink snapshot writes (self-observation, priced too)

Timings come from :func:`repro_torch.obs.metrics.now` (monotonic) and land in
one labelled histogram (``server_phase_seconds{phase=...}``) plus a
plain totals dict, so ``breakdown()`` can report both percentiles and
the coverage ratio — the share of measured generation time the phases
explain, which the JAX package's ``benchmarks/obs_overhead.py``
requires to be >= 90%.

Phases never nest on the same profiler: the timer is a plain class
(not a generator contextmanager) to keep per-phase overhead at two
clock reads and two dict ops.
"""
from __future__ import annotations

from typing import Dict, Optional

from .metrics import Histogram, MetricsRegistry, now

PHASES = (
    "sched_pass", "rebucket", "admission", "dispatch", "device_sync",
    "harvest", "stream_flush", "journal_append", "snapshot_write",
    "rollback_verify", "retry_backoff", "obs_snapshot",
)


class _PhaseTimer:
    """``with prof.phase("harvest"):`` — records on exit, even on error."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "PhaseProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = now()
        self._prof._inflight = self._name
        self._prof._inflight_t0 = self._t0
        return self

    def __exit__(self, *exc):
        self._prof._inflight = None
        self._prof.record(self._name, now() - self._t0)
        return False


class _NullTimer:
    """Shared no-op timer for the disabled path (zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_TIMER = _NullTimer()


class PhaseProfiler:
    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._hist: Histogram = registry.histogram(
            "server_phase_seconds", "wall-clock per generation-loop phase")
        self._gen: Histogram = registry.histogram(
            "server_generation_seconds", "wall-clock per generation")
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.gen_total = 0.0
        self.gen_count = 0
        # the phase timer currently open, if any: exports taken from
        # *inside* a phase (journal watermarks, snapshot writes) credit
        # it with its elapsed-so-far time so counts stay exactly
        # monotone across a crash-recovery cut
        self._inflight: Optional[str] = None
        self._inflight_t0 = 0.0

    # -- recording ------------------------------------------------------
    def phase(self, name: str) -> _PhaseTimer:
        return _PhaseTimer(self, name)

    def record(self, name: str, dt: float) -> None:
        self._hist.observe(dt, phase=name)
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def record_generation(self, dt: float) -> None:
        self._gen.observe(dt)
        self.gen_total += dt
        self.gen_count += 1

    # -- views ----------------------------------------------------------
    def breakdown(self) -> dict:
        """Per-phase totals/percentiles + share of generation time."""
        phases = {}
        for name in sorted(self.totals):
            s = self._hist.summary(phase=name)
            phases[name] = {
                "count": self.counts[name],
                "total_s": self.totals[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
                "p50_ms": 1e3 * s["p50"],
                "p95_ms": 1e3 * s["p95"],
                "p99_ms": 1e3 * s["p99"],
                "share": (self.totals[name] / self.gen_total
                          if self.gen_total else 0.0),
            }
        covered = sum(self.totals.values())
        return {
            "phases": phases,
            "generation": {"count": self.gen_count, "total_s": self.gen_total,
                           **{k: 1e3 * v for k, v in
                              (("p50_ms", self._gen.summary()["p50"]),
                               ("p95_ms", self._gen.summary()["p95"]),
                               ("p99_ms", self._gen.summary()["p99"]))}},
            "coverage": (covered / self.gen_total) if self.gen_total else 0.0,
        }

    # -- durability -----------------------------------------------------
    # Histogram state lives in the registry (snapshotted there); only the
    # plain totals need explicit export.
    def export(self) -> dict:
        d = {"totals": dict(self.totals), "counts": dict(self.counts),
             "gen_total": self.gen_total, "gen_count": self.gen_count}
        if self._inflight is not None:
            name = self._inflight
            d["counts"][name] = d["counts"].get(name, 0) + 1
            d["totals"][name] = (d["totals"].get(name, 0.0)
                                 + (now() - self._inflight_t0))
        return d

    def restore(self, d: Optional[dict]) -> None:
        if not d:
            return
        for k, v in d["totals"].items():
            self.totals[k] = self.totals.get(k, 0.0) + v
        for k, v in d["counts"].items():
            self.counts[k] = self.counts.get(k, 0) + v
        self.gen_total += d["gen_total"]
        self.gen_count += d["gen_count"]

    def raise_to(self, d: Optional[dict]) -> None:
        """Floor every total/count at a journaled watermark (elementwise
        max) — recovery's monotonicity backstop for timings the crashed
        server recorded after its last snapshot export."""
        if not d:
            return
        for k, v in d["totals"].items():
            self.totals[k] = max(self.totals.get(k, 0.0), v)
        for k, v in d["counts"].items():
            self.counts[k] = max(self.counts.get(k, 0), v)
        self.gen_total = max(self.gen_total, d["gen_total"])
        self.gen_count = max(self.gen_count, d["gen_count"])
