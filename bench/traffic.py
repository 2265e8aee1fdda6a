"""The one generator: every cell's inputs, made from ``--seed`` and the
parameters in its configuration and workload files.

Every seed gets the same work in another order: each copy of the census
takes the grid's own iteration counts, and the seed only deals them to
lanes; a training step's token ids
are uniform over the vocabulary.  Seeds may be any whole number up to a
little over ``2**31`` and beyond; numpy's generators take them as they
are.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np


class Lane(NamedTuple):
    mechanism: str
    virtualize: bool
    program: str
    iters: int


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def census_cells(cfg: Dict) -> List[tuple]:
    """The (mechanism, virtualize, program) cells in the census's order."""
    return [(m, bool(v), p) for m, v in cfg["mechanisms"]
            for p in cfg["programs"]]


def census_lanes(cfg: Dict, seed: int) -> List[Lane]:
    """``copies`` x cells x ``scales`` lanes, copy by copy in the census's
    cell order.  Each copy is the census's own grid: a cell's lanes take
    the iteration counts ``max(2, int(base * s))``, one for each of the
    configuration's ``scales``; the seed deals each copy's counts of a
    cell to that copy's lanes of the cell."""
    scales = cfg["scales"]
    rng = _rng(seed, 0)
    lanes = []
    for _ in range(cfg["copies"]):
        for m, v, p in census_cells(cfg):
            base = cfg["base_iters"][p][m]
            iters = [max(2, int(base * s)) for s in scales]
            lanes.extend(Lane(m, v, p, iters[i])
                         for i in rng.permutation(len(iters)))
    return lanes


def census_sample(cfg: Dict, lanes: List[Lane], seed: int,
                  per_cell: int) -> List[int]:
    """The lanes the reference checks: ``per_cell`` of each cell's lanes,
    drawn from the seed (sorted)."""
    rng = _rng(seed, 1)
    by_cell: Dict[tuple, List[int]] = {}
    for i, ln in enumerate(lanes):
        by_cell.setdefault((ln.mechanism, ln.program), []).append(i)
    out = []
    for idx in by_cell.values():
        out.extend(idx[j] for j in rng.choice(len(idx), size=per_cell,
                                              replace=False))
    return sorted(out)


def token_seed(seed: int) -> int:
    """The seed of the token stream's generator on the card."""
    return int(_rng(seed, 2).integers(0, 2**62))


def param_seed(seed: int, leaf: int) -> int:
    """The seed of one parameter leaf's generator on the card."""
    return int(_rng(seed, 3 + leaf).integers(0, 2**62))
