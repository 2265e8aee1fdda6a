"""The harness on the card at the tiny sizes: the megastep kernel and the
NCCL world under the same drivers, comparisons and readers as the cells.
Marked ``cuda``; each test skips without a card."""
from __future__ import annotations

import pytest

from bench import run
from bench.conftest import TINY_CENSUS, TINY_TRAIN, tiny_spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [TINY_CENSUS, TINY_TRAIN])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_on_the_card(card, tiny_root, cell, traced):
    res, checks = run.run_cell(cell, 2**31 + 77, 0.5, traced,
                               device=str(card), spec=tiny_spec(),
                               root=tiny_root, trace_seconds=0.1)
    assert res["correct"], checks
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if traced:
        assert res["device"]["busy_s"] > 0
        assert res["breakdown"]["device_ops"]
        assert res["breakdown"]["idle_gaps"]
        assert {m for m in res["metrics"] if m.endswith("device_idle")}
    else:
        assert res["metrics"]["setup_s"]["value"] > 0
