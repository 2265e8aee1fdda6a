"""Low-overhead metrics registry for the serving stack (repro_torch.obs).

One :class:`MetricsRegistry` per server holds three metric families —
counters, gauges, and log-bucketed (HDR-style) histograms — each with
optional label support.  The registry renders to the Prometheus text
exposition format (v0) or to a JSON-able snapshot dict, and ships with
pluggable sinks (in-memory ring, append-only JSONL, Prometheus text
file) selected by ``HookConfig.obs_sink``.

Design constraints, in order:

* **Cheap when on.**  The hot path (``Counter.inc`` / ``Histogram.observe``)
  is a dict lookup plus an integer add — no locks, no allocation after
  the first observation of a label set.  The fleet server records ~10
  phase timings per *generation* (milliseconds), not per syscall, so
  Python-level bookkeeping is far below the <5% overhead bar that
  the JAX package's ``benchmarks/obs_overhead.py`` enforces.
* **Zero cost when off.**  A disabled server never constructs a
  registry (``MetricsRegistry.created_total`` lets tests assert this).
* **Durable.**  ``export()`` / ``restore()`` round-trip the full state
  (sparse histogram buckets included) through snapshot metadata, and
  ``counter_watermark()`` / ``apply_watermark()`` give recovery the
  same monotone-across-a-crash guarantee the trace stream's
  emission watermarks give its sequence numbers.

All wall-clock timestamps in the obs layer come from :func:`now` — the
monotonic ``time.perf_counter`` clock, never ``time.time`` — so phase
timings, span latencies and snapshot intervals share one timebase.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple


def now() -> float:
    """The obs timebase: monotonic seconds (``time.perf_counter``).

    Every timestamp the obs layer records — phase timers, span events,
    snapshot intervals — goes through this helper so subsystems can
    never mix the wall clock into latency arithmetic.
    """
    return time.perf_counter()


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join('%s="%s"' % (k, v.replace('"', '\\"')) for k, v in key)
    return "{" + inner + "}"


# --------------------------------------------------------------------------
# metric families
# --------------------------------------------------------------------------

class Counter:
    """Monotone counter family; children keyed by label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        self._children[key] = self._children.get(key, 0) + n

    def get(self, **labels: str) -> float:
        return self._children.get(_label_key(labels), 0)

    @property
    def total(self) -> float:
        return sum(self._children.values())

    def series(self) -> Iterable[Tuple[LabelKey, float]]:
        return self._children.items()

    # -- durability -----------------------------------------------------
    def export(self) -> list:
        return [[list(map(list, k)), v] for k, v in self._children.items()]

    def restore(self, data: list) -> None:
        for k, v in data:
            self._children[tuple(tuple(p) for p in k)] = v

    def raise_to(self, key: LabelKey, floor: float) -> None:
        """Monotonicity backstop: never let a series sit below ``floor``."""
        if self._children.get(key, 0) < floor:
            self._children[key] = floor


class Gauge(Counter):
    """Point-in-time value family (same storage, settable)."""

    kind = "gauge"

    def set(self, v: float, **labels: str) -> None:
        self._children[_label_key(labels)] = v


# HDR-style log bucketing: SUB buckets per octave over [LO, inf).  With
# SUB=8 the relative quantile error is bounded by 2**(1/8)-1 ~= 9%.
_HIST_LO = 1e-7          # 100ns floor — below that everything is bucket 0
_HIST_SUB = 8            # sub-buckets per power of two
_HIST_OCTAVES = 44       # 1e-7 .. ~1.7e6 seconds
_HIST_N = _HIST_OCTAVES * _HIST_SUB
_LOG2_LO = math.log2(_HIST_LO)


def _bucket_index(v: float) -> int:
    if v <= _HIST_LO:
        return 0
    i = int((math.log2(v) - _LOG2_LO) * _HIST_SUB)
    return i if i < _HIST_N else _HIST_N - 1


def _bucket_upper(i: int) -> float:
    return 2.0 ** (_LOG2_LO + (i + 1) / _HIST_SUB)


class _HistogramChild:
    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}   # sparse: bucket index -> count
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, v: float) -> None:
        i = _bucket_index(v)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Approximate quantile: upper bound of the covering bucket."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                return min(_bucket_upper(i), self.max)
        return self.max

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": 0.0 if self.count == 0 else self.min,
            "max": self.max,
            "mean": (self.sum / self.count) if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class Histogram:
    """Log-bucketed histogram family (seconds by convention)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: Dict[LabelKey, _HistogramChild] = {}

    def child(self, **labels: str) -> _HistogramChild:
        key = _label_key(labels)
        c = self._children.get(key)
        if c is None:
            c = self._children[key] = _HistogramChild()
        return c

    def observe(self, v: float, **labels: str) -> None:
        self.child(**labels).observe(v)

    def summary(self, **labels: str) -> dict:
        key = _label_key(labels)
        c = self._children.get(key)
        return c.summary() if c is not None else _HistogramChild().summary()

    def series(self) -> Iterable[Tuple[LabelKey, _HistogramChild]]:
        return self._children.items()

    @property
    def count(self) -> int:
        return sum(c.count for c in self._children.values())

    # -- durability -----------------------------------------------------
    def export(self) -> list:
        out = []
        for k, c in self._children.items():
            out.append([list(map(list, k)),
                        {"buckets": [[i, n] for i, n in sorted(c.buckets.items())],
                         "count": c.count, "sum": c.sum,
                         "min": None if c.min is math.inf else c.min,
                         "max": c.max}])
        return out

    def restore(self, data: list) -> None:
        for k, d in data:
            c = self._children.setdefault(tuple(tuple(p) for p in k),
                                          _HistogramChild())
            for i, n in d["buckets"]:
                c.buckets[int(i)] = c.buckets.get(int(i), 0) + int(n)
            c.count += int(d["count"])
            c.sum += float(d["sum"])
            if d["min"] is not None and d["min"] < c.min:
                c.min = d["min"]
            if d["max"] > c.max:
                c.max = d["max"]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> metric family.  One per observed server."""

    # Tests assert the disabled path allocates nothing: every registry
    # construction bumps this class-level counter.
    created_total = 0

    def __init__(self):
        MetricsRegistry.created_total += 1
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise TypeError("metric %r already registered as %s"
                            % (name, m.kind))
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- views ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able point-in-time view (summaries, not raw buckets)."""
        counters, gauges, hists = {}, {}, {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.kind == "histogram":
                hists[name] = {(_fmt_labels(k) or "_"): c.summary()
                               for k, c in m.series()}
            elif m.kind == "gauge":
                gauges[name] = {(_fmt_labels(k) or "_"): v
                                for k, v in m.series()}
            else:
                counters[name] = {(_fmt_labels(k) or "_"): v
                                  for k, v in m.series()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append("# HELP %s %s" % (name, m.help))
            lines.append("# TYPE %s %s" % (name, m.kind))
            if m.kind == "histogram":
                for key, c in sorted(m.series()):
                    cum = 0
                    for i in sorted(c.buckets):
                        cum += c.buckets[i]
                        le = _fmt_labels(key + (("le", "%.9g" % _bucket_upper(i)),))
                        lines.append("%s_bucket%s %d" % (name, le, cum))
                    inf = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append("%s_bucket%s %d" % (name, inf, c.count))
                    lines.append("%s_sum%s %.9g" % (name, _fmt_labels(key), c.sum))
                    lines.append("%s_count%s %d" % (name, _fmt_labels(key), c.count))
            else:
                for key, v in sorted(m.series()):
                    g = ("%.9g" % v) if isinstance(v, float) else str(v)
                    lines.append("%s%s %s" % (name, _fmt_labels(key), g))
        return "\n".join(lines) + "\n"

    # -- durability -----------------------------------------------------
    def export(self) -> dict:
        """Full-fidelity state for snapshot metadata (raw buckets)."""
        return {name: {"kind": m.kind, "help": m.help, "data": m.export()}
                for name, m in self._metrics.items()}

    def restore(self, data: dict) -> None:
        cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
        for name, d in data.items():
            m = self._get(cls[d["kind"]], name, d.get("help", ""))
            m.restore(d["data"])

    def counter_watermark(self) -> dict:
        """Flat ``name{labels} -> value`` map of every counter series —
        journaled per generation so recovery can clamp counters up."""
        wm = {}
        for name, m in self._metrics.items():
            if m.kind == "counter":
                for key, v in m.series():
                    wm[name + _fmt_labels(key)] = v
        return wm

    def apply_watermark(self, wm: dict) -> None:
        """Raise each counter series to at least its journaled value.

        Replay normally re-derives the exact totals; the watermark is
        the backstop that makes monotonicity a guarantee rather than a
        property of replay determinism.
        """
        index: Dict[str, Tuple[Counter, LabelKey]] = {}
        for name, m in self._metrics.items():
            if m.kind == "counter":
                for key, _ in list(m.series()):
                    index[name + _fmt_labels(key)] = (m, key)
        for flat, floor in wm.items():
            hit = index.get(flat)
            if hit is not None:
                hit[0].raise_to(hit[1], floor)
            else:
                # Series the replay never touched: recreate it at the floor.
                name, _, rest = flat.partition("{")
                labels: Dict[str, str] = {}
                if rest:
                    for part in rest.rstrip("}").split('","'):
                        if "=" in part:
                            k, _, v = part.partition("=")
                            labels[k] = v.strip('"')
                self.counter(name).inc(0, **labels)
                self.counter(name).raise_to(_label_key(labels), floor)


# --------------------------------------------------------------------------
# sinks
# --------------------------------------------------------------------------

class MemorySink:
    """Keeps the last ``cap`` snapshots in memory (for tests / REPL)."""

    def __init__(self, cap: int = 64):
        self.cap = cap
        self.snapshots: List[dict] = []

    def write(self, registry: MetricsRegistry, ts: float) -> None:
        self.snapshots.append({"ts": ts, **registry.snapshot()})
        if len(self.snapshots) > self.cap:
            del self.snapshots[0]


class JsonlSink:
    """Appends one JSON snapshot line per write."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, registry: MetricsRegistry, ts: float) -> None:
        line = json.dumps({"ts": ts, **registry.snapshot()},
                          separators=(",", ":"), sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")


class PromFileSink:
    """Rewrites a Prometheus text file on every write (node-exporter
    textfile-collector style)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, registry: MetricsRegistry, ts: float) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(registry.render_prometheus())
        os.replace(tmp, self.path)


def make_sink(spec: str):
    """Build a sink from a ``HookConfig.obs_sink`` spec.

    * ``""`` — no sink (metrics still collected, pull-only).
    * ``"memory"`` — in-memory ring of snapshots.
    * ``"jsonl:<path>"`` or a bare ``*.jsonl`` path — JSONL appender.
    * ``"prom:<path>"`` — Prometheus textfile, rewritten atomically.

    Anything else raises ``ValueError`` naming the offending value.
    """
    if not spec:
        return None
    if spec == "memory":
        return MemorySink()
    if spec.startswith("jsonl:"):
        return JsonlSink(spec[len("jsonl:"):])
    if spec.startswith("prom:"):
        return PromFileSink(spec[len("prom:"):])
    if spec.endswith(".jsonl"):
        return JsonlSink(spec)
    raise ValueError(
        "obs_sink=%r is not a recognised sink: use '', 'memory', "
        "'jsonl:<path>', 'prom:<path>', or a path ending in .jsonl" % (spec,))
