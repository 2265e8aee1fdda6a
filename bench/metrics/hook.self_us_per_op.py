"""The collective hook's own host time an operator (us): the ``self_ns``
of the ``hook.mode`` spans of the device profile's range (the time
inside the dispatch mode's ``__torch_dispatch__`` outside the operator
it runs) over their ``dispatched`` (``bench/spans.py``)."""
from bench.spans import named, window


def read(ctx):
    modes = named(window(ctx), "hook.mode")
    ops = sum(s.counts.get("dispatched", 0) for s in modes)
    if not ops:
        return None
    return sum(s.counts.get("self_ns", 0) for s in modes) / ops * 1e-3
