"""Serving telemetry layer (repro_torch.obs; PyTorch port of the JAX
package's ``repro.obs``: host code only, a copy of the original).

ASC-Hook's argument is *measured* overhead; this package is the serving
stack's always-on equivalent of the paper's measurement tables — a
metrics registry (`metrics`), a generation-loop phase profiler
(`profiler`) and per-request lifecycle spans (`spans`), coordinated by
one :class:`ObsHub` per :class:`~repro_torch.serve.fleet_server.FleetServer`.

Enable with ``HookConfig(obs_enabled=True)`` (optionally
``obs_sink="jsonl:/tmp/m.jsonl"`` / ``"prom:/tmp/m.prom"`` /
``"memory"`` and ``obs_snapshot_interval_s``), then read
``server.metrics()`` or ``server.metrics("prometheus")``.  A disabled
server holds no hub at all — zero registry allocations, zero per-phase
clock reads beyond a single null context manager.

The whole layer observes, never steers: published guest states are
bit-identical with obs on and off (asserted by
``tests/test_torch_obs.py``; the JAX package's
``benchmarks/obs_overhead.py`` prices it there), and registry state
exports and restores (``export``/``restore``, ``watermark``) so a durable
server can keep counters monotone and spans complete across a recovery.

Apart from the server, :func:`span` and :func:`count` name the program's
own work (the census driver's chunks, the train step's passes, the
collective hook's own time) while a ``torch.profiler`` runs, on the
profiler's clock, and :func:`recorded` returns what they recorded
(``spans``); with no profiler running a span site is the shared no-op
timer.
"""
from __future__ import annotations

from typing import Optional

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               make_sink, now)
from .profiler import NULL_TIMER, PHASES, PhaseProfiler
from .spans import (RECORDER, Span, SpanRecorder, SpanTracker, count,
                    recorded, recording, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ObsHub",
    "PHASES", "PhaseProfiler", "RECORDER", "Span", "SpanRecorder",
    "SpanTracker", "count", "make_sink", "now", "phase", "recorded",
    "recording", "span",
]


class ObsHub:
    """One server's observability surface: registry + profiler + spans
    + optional snapshot sink."""

    def __init__(self, cfg=None, *, sink: Optional[str] = None,
                 snapshot_interval_s: Optional[float] = None):
        self.registry = MetricsRegistry()
        self.profiler = PhaseProfiler(self.registry)
        self.spans = SpanTracker(self.registry)
        spec = sink if sink is not None else (
            getattr(cfg, "obs_sink", "") if cfg is not None else "")
        self.sink = make_sink(spec)
        self.snapshot_interval_s = float(
            snapshot_interval_s if snapshot_interval_s is not None else
            getattr(cfg, "obs_snapshot_interval_s", 0.0) if cfg is not None
            else 0.0)
        self.sink_writes = 0
        self._last_sink = now()
        self._gen_t0: Optional[float] = None

    # -- phases ---------------------------------------------------------
    def phase(self, name: str):
        return self.profiler.phase(name)

    def gen_begin(self, t0: float) -> None:
        self._gen_t0 = t0

    def gen_end(self, t0: float) -> None:
        self._gen_t0 = None
        self.profiler.record_generation(now() - t0)

    # -- sink -----------------------------------------------------------
    def maybe_snapshot(self, force: bool = False) -> bool:
        """Write to the sink if one is configured and due (or forced)."""
        if self.sink is None:
            return False
        t = now()
        if not force and self.snapshot_interval_s > 0 \
                and t - self._last_sink < self.snapshot_interval_s:
            return False
        if not force and self.snapshot_interval_s <= 0:
            return False
        with self.profiler.phase("obs_snapshot"):
            self.sink.write(self.registry, t)
        self.sink_writes += 1
        self._last_sink = t
        return True

    # -- durability -----------------------------------------------------
    def _profile_snapshot(self) -> dict:
        """Profiler export with in-flight credit: durability exports run
        mid-generation (the snapshot write IS a step phase), so the
        in-flight generation — and the in-flight phase, via the
        profiler's own export — are credited with elapsed-so-far time.
        Keeps a recovered server's counts from sitting below the last
        value a ``metrics()`` caller could have read."""
        prof = self.profiler.export()
        if self._gen_t0 is not None:
            prof["gen_count"] += 1
            prof["gen_total"] += now() - self._gen_t0
        return prof

    def export(self) -> dict:
        return {"registry": self.registry.export(),
                "profiler": self._profile_snapshot(),
                "spans": self.spans.export(),
                "sink_writes": self.sink_writes}

    def restore(self, d: Optional[dict]) -> None:
        if not d:
            return
        self.registry.restore(d.get("registry", {}))
        self.profiler.restore(d.get("profiler"))
        self.spans.restore(d.get("spans"))
        self.sink_writes += int(d.get("sink_writes", 0))

    def watermark(self) -> dict:
        """What a gen record journals: monotone floors for everything a
        deterministic tail replay cannot fully re-derive — counter values
        and the profiler's timing totals (replayed phases time the
        *replay's* wall-clock, not the original's)."""
        return {"counters": self.registry.counter_watermark(),
                "profile": self._profile_snapshot()}

    def apply_watermark(self, wm: Optional[dict]) -> None:
        if not wm:
            return
        self.registry.apply_watermark(wm.get("counters") or {})
        self.profiler.raise_to(wm.get("profile"))


def phase(hub: Optional[ObsHub], name: str):
    """Phase timer against ``hub``, or a shared no-op when obs is off —
    call sites stay one-liners: ``with obs.phase(self._obs, "harvest"):``."""
    return hub.profiler.phase(name) if hub is not None else NULL_TIMER
