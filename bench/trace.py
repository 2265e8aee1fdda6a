"""The traced run's reduction: from ``torch.profiler`` traces to the
device's busy time, the time of each kernel, and the idle gaps labelled
by what the host was doing.

A traced run takes two profiles.  The device profile records the card's
activity alone (kernels, copies, fills) over the window's first
``TRACE_SECONDS``, to the end of the unit of work (a census, a step)
that crosses them; the rest of the window runs untraced.  It records no
host operator, so the host runs at nearly its own speed and the busy
time, the kernels and the launches read as in an untraced run; its
window is timed by the host's clock.  The labelled profile records the
host's operators and the benchmark's spans (``bench.*``, around its
calls into each layer) as well, over units of work run after the window
has closed until ``LABEL_SECONDS`` have passed: it only names what the
host was doing in each idle gap, since recording every operator slows a
host-bound step.

Even the card's activity alone costs the host some time a launch (on the
hooked train step about a sixth of a step, on the census about 2 %), so
a reading that sets the device's time against the wall's takes the wall
time of a unit of work from the window's untraced remainder, and the
device's time of a unit from the device profile.  Times are in seconds.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW_SPAN = "bench.window"
TRACE_SECONDS = 15.0
LABEL_SECONDS = 1.0


class Interval(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    window_s: float
    device: List[Interval]    # kernels, copies and fills, by start
    host: List[Interval]      # operators and the benchmark's spans
    # the labelled profile's window span on the trace's clock
    window: Optional[Tuple[float, float]] = None


def _profile(activities):
    from torch.profiler import profile
    return profile(activities=activities)


class Tracer:
    """The device profile (the card's activity alone; without a card the
    host's operators, which leave it empty of device intervals) over the
    window's first ``limit`` seconds.  ``tick(units)`` after each unit of
    work stops it once the limit has passed; ``units`` then holds the
    units done inside the traced window and ``window_s`` its length."""

    def __init__(self, card: bool, limit: float = TRACE_SECONDS):
        from torch.profiler import ProfilerActivity
        self.prof = _profile([ProfilerActivity.CUDA if card
                              else ProfilerActivity.CPU])
        self.limit = limit
        self.on = False
        self.units = 0

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()
        self.on = True

    def tick(self, units: int) -> None:
        if self.on and time.perf_counter() - self.t0 >= self.limit:
            self.stop(units)

    def stop(self, units: int) -> None:
        if self.on:
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()
            self.on = False
            self.units = units

    def reduce(self) -> Trace:
        device, _ = _events(self.prof)
        return Trace(self.window_s, sorted(device, key=lambda iv: iv.start),
                     [])


def _events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) of a profile."""
    from torch.autograd import DeviceType
    device: List[Interval] = []
    host: List[Interval] = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        iv = Interval(e.name(), start, start + dur)
        if e.device_type() == DeviceType.CPU:
            host.append(iv)
        elif dur > 0 and not e.is_user_annotation():
            device.append(iv)
    return device, host


def labelled(unit, card: bool, seconds: float = LABEL_SECONDS) -> Trace:
    """Run ``unit`` under the labelled profile, inside the span
    ``WINDOW_SPAN``, until ``seconds`` have passed (once at least); its
    intervals clipped to the span."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                     else [])
    prof = _profile(acts)
    prof.start()
    t0 = time.perf_counter()
    with torch.profiler.record_function(WINDOW_SPAN):
        while True:
            unit()
            if time.perf_counter() - t0 >= seconds:
                break
    prof.stop()
    device, host = _events(prof)
    spans = [iv for iv in host if iv.name == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    lo, hi = spans[0].start, spans[0].end

    def clip(ivs):
        return sorted((Interval(n, max(s, lo), min(t, hi))
                       for n, s, t in ivs if t > lo and s < hi),
                      key=lambda iv: iv.start)

    return Trace(hi - lo, clip(device), clip(host), (lo, hi))


def union(ivs: List[Interval]) -> List[Tuple[float, float]]:
    """The device's busy stretches: the union of the intervals (several
    streams may overlap)."""
    out: List[List[float]] = []
    for _, s, t in sorted(ivs, key=lambda iv: iv.start):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(tr: Trace) -> float:
    return sum(t - s for s, t in union(tr.device))


def device_time(tr: Trace, match) -> Tuple[float, int]:
    """(seconds, count) of the device intervals whose name ``match``es."""
    sel = [iv for iv in tr.device if match(iv.name)]
    return sum(iv.end - iv.start for iv in sel), len(sel)


def unit_s(ctx) -> Optional[float]:
    """The wall time of a unit of work in the window's untraced remainder
    (None where the remainder holds none)."""
    if not ctx["rest_units"]:
        return None
    return ctx["rest_s"] / ctx["rest_units"]


def idle_share(ctx) -> Optional[float]:
    """The device's idle share of an untraced unit of work (%): one less
    the device profile's busy time a unit over ``unit_s``."""
    wall = unit_s(ctx)
    if wall is None or not ctx["units"]:
        return None
    return (1.0 - busy_s(ctx["trace"]) / ctx["units"] / wall) * 100.0


def top_device_ops(tr: Trace, n: int = 10) -> List[list]:
    by: Dict[str, float] = defaultdict(float)
    for iv in tr.device:
        by[iv.name] += iv.end - iv.start
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace) -> List[Tuple[float, float]]:
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in union(tr.device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_host(tr: Trace, n: int = 10) -> List[list]:
    """The device's idle time in the window by what the host was doing at
    the middle of each gap (the latest-started host interval still open
    there, the window span aside), the largest ``n``."""
    host = [iv for iv in tr.host if iv.name != WINDOW_SPAN]
    by: Dict[str, float] = defaultdict(float)
    stack: List[Interval] = []
    i = 0
    for s, e in idle_gaps(tr):
        t = 0.5 * (s + e)
        while i < len(host) and host[i].start <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        by[stack[-1].name if stack else "host idle"] += e - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(device: Trace, labelled: Trace) -> Dict[str, list]:
    """The kernels that took most time in the device profile, and the
    longest idle gaps of the labelled one by what the host was doing."""
    return {"device_ops": top_device_ops(device),
            "idle_gaps": idle_by_host(labelled)}
