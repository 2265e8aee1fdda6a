"""The CUDA megastep kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one (a skip is not a pass).
They import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernel to the same standard at the full
census size.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import interop, pack_fleet, run_fleet_prepared
from repro_torch.core.machine import MachineState
from repro_torch.kernels.megastep import ops as mops
from repro_torch.kernels.megastep.ref import megastep_chunk_ref

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_cuda", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the kernel on the "
                    "H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def census_every_tenth(card):
    pps, regs = SMOKE.census_processes()
    pps, regs = pps[::10], regs[::10]  # 50 lanes, all 25 images
    imgs, ids, s = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs, device=card)
    return pps, regs, imgs, ids, s


def _clone(s):
    return MachineState(*(x.clone() for x in s))


def _assert_equal(a, b, what):
    bad = [f for f, x, y in zip(MachineState._fields, a, b)
           if not torch.equal(x, y)]
    assert not bad, f"{what}: leaves {bad}"


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_kernel_matches_plain(census_every_tenth, chunk, seed):
    """One chunk from the initial state and from seeded random states, at
    a block size with a ragged edge and one without."""
    pps, _, imgs, ids, s0 = census_every_tenth
    if seed is not None:
        leaves = SMOKE.scramble(interop.state_to_numpy(s0),
                                SMOKE.code_of(pps),
                                np.random.default_rng(seed))
        s0 = interop.state_from_numpy(leaves, s0.pc.device)
    want = megastep_chunk_ref(imgs, ids, _clone(s0), chunk=chunk)
    for block in (16, 32, 128):
        got = mops.megastep_chunk(imgs, ids, _clone(s0), chunk=chunk,
                                  block=block)
        torch.cuda.synchronize()
        _assert_equal(want, got, f"chunk={chunk} seed={seed} block={block}")


def test_run_on_card_matches_cpu(census_every_tenth, card):
    """The whole path to halt on the card equals the CPU path, and each
    chunk is one launch."""
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], regs[:10]
    for r in regs:
        r[19] = 3
    mops.megastep_chunk.launches = 0
    got = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=64, regs=regs,
                             device=card)
    launches = mops.megastep_chunk.launches
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=64, regs=regs,
                              device="cpu")
    _assert_equal(want, MachineState(*(x.cpu() for x in got)), "run")
    assert launches == -(-int(want.icount.max()) // 64)
