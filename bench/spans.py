"""The program's own spans (``repro_torch.obs.span``) read against the
device profile (``trace.py``).

The program records its spans while a profiler runs, on the profiler's
clock, and keeps them in memory; a traced run's device profile and its
labelled profile both record them.  A reader takes the spans that
overlap the device profile's range, from its first device interval's
start to its last one's end: the units of work the profile traced.  The
idle time of that range is split into the gaps of the union of the
device intervals, and each gap is put down to the innermost span open
at its middle on the thread that recorded the reader's root span (as
``trace.idle_by_host`` names the labelled profile's gaps).  A program
that records no spans (one older than its span recorder) gives no
spans, and the readers then read nothing.  Times are in seconds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from bench.trace import Interval, Trace, idle_by_host


def recorded() -> list:
    """The program's recorded spans, or none where it records none."""
    from repro_torch import obs
    rec = getattr(obs, "recorded", None)
    return rec() if rec is not None else []


def device_range(tr: Trace) -> Optional[Tuple[float, float]]:
    if not tr.device:
        return None
    return (min(iv.start for iv in tr.device),
            max(iv.end for iv in tr.device))


def window(ctx) -> list:
    """The spans that overlap the device profile's range (none where the
    profile holds no device interval)."""
    rng = device_range(ctx["trace"])
    if rng is None:
        return []
    lo, hi = rng
    return [s for s in recorded() if s.end > lo and s.start < hi]


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def idle_by_span(tr: Trace, spans, root: str) -> Dict[str, float]:
    """The idle time of the device profile's range by the innermost span
    open at each gap's middle on the thread that recorded the first
    ``root`` span (``trace.idle_by_host`` over those spans); the key
    ``host idle`` holds the idle outside every span."""
    thread = next(s.thread for s in spans if s.name == root)
    own = sorted((Interval(s.name, s.start, s.end) for s in spans
                  if s.thread == thread), key=lambda iv: iv.start)
    return dict(idle_by_host(tr._replace(host=own, window=device_range(tr)),
                             n=len(own) + 1))


def idle_per_unit(ctx, root: str, names) -> Optional[float]:
    """The idle seconds put down to the spans ``names`` over the root
    spans of the device profile's range (None where it holds none)."""
    spans = window(ctx)
    roots = named(spans, root)
    if not roots:
        return None
    by = idle_by_span(ctx["trace"], spans, root)
    return sum(by.get(n, 0.0) for n in names) / len(roots)
