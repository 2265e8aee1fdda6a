"""The device's idle time a census in the census driver's once-a-census
work (us): the idle gaps of the device profile put down to the span
``fleet.run`` itself and its children ``fleet.inputs`` (input
placement), ``fleet.check`` (operand checks, the image-id sync),
``fleet.args`` (the kernel's arguments) and ``fleet.patch_fuel``, over
the ``fleet.run`` spans of its range (``bench/spans.py``)."""
from bench.spans import idle_per_unit

NAMES = ("fleet.run", "fleet.inputs", "fleet.check", "fleet.args",
         "fleet.patch_fuel")


def read(ctx):
    v = idle_per_unit(ctx, "fleet.run", NAMES)
    return None if v is None else v * 1e6
