"""The device's idle time a train step in the forward pass (ms): the
idle gaps of the device profile put down to the span ``train.forward``
(``lm.loss_fn``), over the ``train.step`` spans of its range
(``bench/spans.py``)."""
from bench.spans import idle_per_unit


def read(ctx):
    v = idle_per_unit(ctx, "train.step", ("train.forward",))
    return None if v is None else v * 1e3
