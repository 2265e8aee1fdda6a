"""The device's idle time a chunk of the census driver (us): the idle
gaps of the device profile put down to the spans ``fleet.alive`` (the
liveness test and its sync) and ``fleet.launch`` (the chunk's launch),
over the ``chunks`` counted by the ``fleet.run`` spans of its range
(``bench/spans.py``)."""
from bench.spans import idle_by_span, named, window


def read(ctx):
    spans = window(ctx)
    chunks = sum(s.counts.get("chunks", 0) for s in named(spans,
                                                          "fleet.run"))
    if not chunks:
        return None
    by = idle_by_span(ctx["trace"], spans, "fleet.run")
    return (by.get("fleet.alive", 0.0) + by.get("fleet.launch", 0.0)) \
        / chunks * 1e6
