"""Per-request lifecycle spans (repro_torch.obs).

A span follows one ``FleetRequest`` through the server:

    submit -> admit -> [preempt -> resume]* -> [c3_readmit]* -> complete
                                                             -> shed

Each transition is stamped with the monotonic obs clock and, when the
span closes, decomposed into the wall-clock quantities the ROADMAP's
SLO items need — end-to-end latency, queue wait (submit to first
admission), parked time (preempt to resume), and on-lane execution
time — aggregated into per-tenant log-bucketed histograms:

    request_latency_seconds{tenant=...}
    request_queue_wait_seconds{tenant=...}
    request_parked_seconds{tenant=...}
    request_exec_seconds{tenant=...}

Completion is **idempotent per rid**: publication is at-least-once
(recovery replays the journal tail), so a rid that re-completes after
a crash-replay is counted exactly once — the closed-rid set rides in
``export()``/``restore()`` through snapshot metadata.  That is what
makes recovered histograms *span-complete*: no lifecycle lost, none
double-counted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, now

# Events that put a request on a lane / take it off one.
_RUN_EVENTS = ("admit", "resume", "c3_readmit")
_STOP_EVENTS = ("preempt", "complete", "shed")


class SpanTracker:
    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._events = registry.counter(
            "span_events_total", "request lifecycle transitions")
        self._completed = registry.counter(
            "requests_completed_total", "spans closed by publication")
        self._shed = registry.counter(
            "requests_shed_total", "spans closed by load-shedding")
        self._open_g = registry.gauge("spans_open", "in-flight request spans")
        self._lat = registry.histogram(
            "request_latency_seconds", "submit -> complete wall-clock")
        self._queue = registry.histogram(
            "request_queue_wait_seconds", "submit -> first admission")
        self._parked = registry.histogram(
            "request_parked_seconds", "preempt -> resume, summed per span")
        self._exec = registry.histogram(
            "request_exec_seconds", "time on a lane, summed per span")
        self._open: Dict[str, dict] = {}    # rid -> {tenant, events}
        self._done: Dict[str, int] = {}     # rid -> completions seen (dedup)

    # -- recording ------------------------------------------------------
    def event(self, rid: str, name: str, tenant: str = "default",
              t: Optional[float] = None) -> None:
        t = now() if t is None else t
        span = self._open.get(rid)
        if span is None:
            if rid in self._done:
                # Replayed lifecycle of an already-counted rid: at-least-
                # once publication, count nothing twice.
                self._done[rid] += 1
                return
            span = self._open[rid] = {"tenant": tenant, "events": []}
            self._open_g.set(len(self._open))
        span["events"].append((name, t))
        self._events.inc(1, event=name)
        if name in ("complete", "shed"):
            self._close(rid, span, shed=(name == "shed"))

    def submit(self, rid: str, tenant: str = "default",
               t: Optional[float] = None) -> None:
        self.event(rid, "submit", tenant, t)

    # -- closing --------------------------------------------------------
    def _close(self, rid: str, span: dict, *, shed: bool) -> None:
        del self._open[rid]
        self._open_g.set(len(self._open))
        self._done[rid] = self._done.get(rid, 0) + 1
        tenant = span["tenant"]
        if shed:
            self._shed.inc(1, tenant=tenant)
            return
        self._completed.inc(1, tenant=tenant)
        ev = span["events"]
        t_submit = ev[0][1]
        t_end = ev[-1][1]
        self._lat.observe(max(0.0, t_end - t_submit), tenant=tenant)
        first_admit = next((t for n, t in ev if n == "admit"), None)
        if first_admit is not None:
            self._queue.observe(max(0.0, first_admit - t_submit),
                                tenant=tenant)
        parked = exec_s = 0.0
        run_start = park_start = None
        for n, t in ev:
            if n in _RUN_EVENTS:
                if park_start is not None:
                    parked += max(0.0, t - park_start)
                    park_start = None
                if run_start is None:
                    run_start = t
            elif n in _STOP_EVENTS:
                if run_start is not None:
                    exec_s += max(0.0, t - run_start)
                    run_start = None
                if n == "preempt":
                    park_start = t
        self._parked.observe(parked, tenant=tenant)
        self._exec.observe(exec_s, tenant=tenant)

    # -- views ----------------------------------------------------------
    @property
    def open_count(self) -> int:
        return len(self._open)

    @property
    def completed_count(self) -> int:
        """Distinct rids counted as completed (dedup'd)."""
        return int(self._completed.total)

    def latency_quantiles(self, tenant: str = "default") -> dict:
        """The wall-clock SLO signal: per-tenant latency percentiles."""
        return self._lat.summary(tenant=tenant)

    def summary(self) -> dict:
        events = {k[0][1]: v for k, v in self._events.series()}
        tenants = sorted({k[0][1] for k, _ in self._lat.series()})
        return {
            "open": len(self._open),
            "completed": int(self._completed.total),
            "shed": int(self._shed.total),
            "events": events,
            "latency_by_tenant": {t: self._lat.summary(tenant=t)
                                  for t in tenants},
        }

    # -- durability -----------------------------------------------------
    # Monotonic clocks do not survive a process: open-span timestamps are
    # exported as ages relative to export time and re-based on restore,
    # exactly how the server re-bases FleetRequest.submitted_s.
    def export(self) -> dict:
        t0 = now()
        open_spans = {}
        for rid, span in self._open.items():
            open_spans[rid] = {
                "tenant": span["tenant"],
                "events": [[n, t0 - t] for n, t in span["events"]],
            }
        return {"open": open_spans, "done": list(self._done)}

    def restore(self, d: Optional[dict]) -> None:
        if not d:
            return
        t0 = now()
        for rid, span in d["open"].items():
            self._open[rid] = {
                "tenant": span["tenant"],
                "events": [(n, t0 - age) for n, age in span["events"]],
            }
        for rid in d["done"]:
            self._done[rid] = self._done.get(rid, 0) + 1
        self._open_g.set(len(self._open))
