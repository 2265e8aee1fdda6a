"""Loops over time (``lax.scan``'s place): the sLSTM's steps and the
chunked mLSTM's chunks.

:func:`time_loop` is the eager loop, one step at a time, on every device.
``launch.opanalysis.analyze`` puts its loop-aware count in its place while
it counts a step (:data:`HOOK`): one traced step's operators counted for
the steps that repeat, as the JAX package's ``hloanalysis`` multiplies a
``while`` body by its trip count.
"""
from __future__ import annotations

# the loop time_loop runs instead of its own (launch.opanalysis.analyze)
HOOK = [None]


def time_loop(step, carry, consts, n: int):
    """``carry, y_t = step(consts, carry, t)`` for t in 0 .. n-1: the last
    carry and the list of the n values y_t.  ``consts`` are the tensors
    every step reads (the sequences it slices, the weights); a step reads
    no other tensor that needs a gradient."""
    if HOOK[0] is not None:
        return HOOK[0](step, carry, consts, n)
    ys = []
    for t in range(n):
        carry, y = step(consts, carry, t)
        ys.append(y)
    return carry, ys
