"""Packing's host seconds in set-up (``core/runtime.pack_fleet``: the
decode tables, the stacked initial states, the copy to the card)."""


def read(ctx):
    return ctx["cell"].counters.get("pack_s")
