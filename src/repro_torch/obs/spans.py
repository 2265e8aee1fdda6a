"""Spans (repro_torch.obs): a request's lifecycle in the server, and
the program's own work while a torch profiler runs.

**Request spans** (:class:`SpanTracker`).  A span follows one
``FleetRequest`` through the server:

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

**Program spans** (:func:`span`, :func:`count`, :func:`recorded`).
``with span("fleet.launch"):`` names a stretch of the program's host
time.  Recording follows ``torch.profiler``: while no profiler runs
(``torch.autograd._profiler_enabled()`` is false) a span site returns
the shared :data:`~repro_torch.obs.profiler.NULL_TIMER`, with no
allocation and no clock read.  While one runs, each span keeps its name,
start and end (the :func:`~repro_torch.obs.metrics.now` timebase,
``perf_counter``, shifted by one offset to Unix-epoch time, taken when
recording begins after a stretch without a profiler: the clock of the
profiler's own events), its enclosing span on the same thread, and the
counts :func:`count` adds to it; a span made with ``device=True``
records a CUDA event at each end on the current stream when the card is
in use, resolved to milliseconds only by :func:`recorded`.  The
recorder runs no dispatcher operator (a ``TorchDispatchMode`` sees
nothing of it, where ``torch.profiler.record_function`` is two
operators) and keeps at most ``MAX_SPANS``, counting those it drops.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .metrics import MetricsRegistry, now
from .profiler import NULL_TIMER

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


# -- program spans -------------------------------------------------------

MAX_SPANS = 1 << 18

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A recorded program span: ``start`` and ``end`` in Unix-epoch
    seconds (the profiler's clock), ``parent`` the index of the enclosing
    span in the same list (None for a root), ``thread`` the recording
    thread's ident, ``device_ms`` the time between its CUDA events (a
    ``device=True`` span on the card), else None."""
    name: str
    start: float
    end: float
    parent: Optional[int]
    counts: Dict[str, int]
    thread: int
    device_ms: Optional[float]


class _Open:
    """A span being recorded (times in epoch nanoseconds)."""

    __slots__ = ("rec", "name", "start", "end", "parent", "counts",
                 "thread", "events", "ms")

    def __init__(self, rec: "SpanRecorder", name: str, events):
        self.rec, self.name, self.events = rec, name, events
        self.end = self.counts = self.ms = None

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter_ns() + self.rec.offset
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns() + self.rec.offset
        if self.events is not None:
            self.events[1].record()
        self.rec._stack().pop()
        return False


class SpanRecorder:
    """The program's spans while a profiler runs (one per process:
    :data:`RECORDER`; the module functions are its methods)."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self.spans: List[_Open] = []
        self.dropped = 0
        self.live = False     # recording since the last span site
        self.offset = 0       # epoch ns less perf_counter ns
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, device: bool = False):
        """``with span(name):`` records the stretch while a profiler
        runs, else is the shared no-op timer."""
        if not _profiler_enabled():
            self.live = False
            return NULL_TIMER
        if not self.live:
            p0 = time.perf_counter_ns()
            wall = time.time_ns()
            self.offset = wall - (p0 + time.perf_counter_ns()) // 2
            self.live = True
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return NULL_TIMER
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        sp = _Open(self, name, events)
        self.spans.append(sp)
        return sp

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` to ``key`` of the innermost span open on this thread
        (nothing while no profiler runs)."""
        if not _profiler_enabled():
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[key] = top.counts.get(key, 0) + n

    def recording(self) -> bool:
        """Whether span sites record now (a profiler runs)."""
        return _profiler_enabled()

    def recorded(self) -> List[Span]:
        """The closed spans, in the order they began."""
        done = [s for s in self.spans if s.end is not None]
        index = {id(s): i for i, s in enumerate(done)}
        out = []
        for s in done:
            if s.events is not None and s.ms is None:
                s.events[1].synchronize()
                s.ms = s.events[0].elapsed_time(s.events[1])
            out.append(Span(s.name, s.start * 1e-9, s.end * 1e-9,
                            None if s.parent is None
                            else index.get(id(s.parent)),
                            dict(s.counts or {}), s.thread, s.ms))
        return out

    def clear(self) -> None:
        """Forget the recorded spans and the count of those dropped."""
        self.spans = []
        self.dropped = 0


RECORDER = SpanRecorder()
span = RECORDER.span
count = RECORDER.count
recording = RECORDER.recording
recorded = RECORDER.recorded
