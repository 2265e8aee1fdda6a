"""The megastep kernels' share of their roofline (%): the least time the
censuses of the traced window need by their bytes (``bench/counts.py``,
counted from the census's lanes, images and I/O) over the megastep
kernels' device time there."""
from bench.trace import device_time


def read(ctx):
    busy, n = device_time(ctx["trace"], lambda n: n.startswith("megastep"))
    cell = ctx["cell"]
    if not n or busy <= 0 or not ctx["units"]:
        return None
    return cell.least_s() * ctx["units"] / busy * 100.0
