"""AdamW's time a train step on the device's timeline (ms): the CUDA-event
time of the ``train.optimizer`` spans of the device profile's range
(from its first event to its last, gaps included), over the
``train.step`` spans there (``bench/spans.py``)."""
from bench.spans import named, window


def read(ctx):
    spans = window(ctx)
    steps = named(spans, "train.step")
    ms = [s.device_ms for s in named(spans, "train.optimizer")
          if s.device_ms is not None]
    if not steps or not ms:
        return None
    return sum(ms) / len(steps)
