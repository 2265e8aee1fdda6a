"""A frozen copy of the census's plain pieces, the reference that
``bench`` holds the port's census against.

Copied from ``src/repro_torch`` (``core``: the ISA, image, scanner,
rewriter, trampolines, guest programs, hook config, cost model, machine
state, op-spec tables and the eager fleet step; ``emul``: the guest
kernel) and left as it was, so that a later change to the port is held
against what the census computed when the benchmark was defined.  It
imports nothing outside this package but numpy and torch.
"""
