"""The driver's host gap a chunk (us): a census's wall time in the
window's untraced remainder less the megastep kernels' device time a
census in the device profile, over the chunk kernel's launches a
census."""
from bench.trace import device_time, unit_s


def read(ctx):
    tr, units, wall = ctx["trace"], ctx["units"], unit_s(ctx)
    busy, _ = device_time(tr, lambda n: n.startswith("megastep"))
    _, launches = device_time(tr, lambda n: n.startswith("megastep_kernel"))
    if not launches or wall is None:
        return None
    return (wall - busy / units) / (launches / units) * 1e6
