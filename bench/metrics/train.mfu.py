"""The whole step's share of the card's bf16 peak (%): the model FLOPs a
step (``bench/counts.py``, PaLM's convention) over a step's wall time in
the window's untraced remainder and 989 TFLOP/s (NVIDIA's H100 SXM data
sheet, dense bf16; the result's ``device.power_limit_w`` gives the
card's power limit beside it)."""
from bench.counts import BF16_FLOPS_PER_S
from bench.trace import unit_s


def read(ctx):
    wall = unit_s(ctx)
    if wall is None:
        return None
    return ctx["cell"].flops_per_step() / wall / BF16_FLOPS_PER_S * 100.0
