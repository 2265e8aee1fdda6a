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

from repro_torch.core import (HookConfig, interop, pack_fleet,
                              run_fleet_prepared)
from repro_torch.core.machine import MachineState
from repro_torch.core.runtime import fleet_trace
from repro_torch.kernels.megastep import ops as mops
from repro_torch.kernels.megastep.ref import megastep_chunk_ref
from repro_torch.trace import policy as tpolicy

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_cuda", ROOT / "chip_smoke.py")
CONFIGS = {"emul_off": HookConfig(emul_enabled=False),
           "default": HookConfig()}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the kernel on the "
                    "H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=list(CONFIGS))
def census_every_tenth(card, request):
    pps, regs = SMOKE.census_processes(CONFIGS[request.param])
    pps, regs = pps[::10], regs[::10]  # 50 lanes, all 25 images
    imgs, ids, s = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs, device=card)
    return pps, regs, imgs, ids, s


def _clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def _assert_equal(a, b, what):
    bad = [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    assert not bad, f"{what}: leaves {bad}"


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_kernel_matches_plain(census_every_tenth, chunk, seed):
    """One chunk from the initial state and from seeded random states
    (random guest-kernel tables too when emulation is on), at a block size
    with a ragged edge and one without."""
    pps, _, imgs, ids, s0 = census_every_tenth
    if seed is not None:
        rng = np.random.default_rng(seed)
        code = SMOKE.code_of(pps)
        leaves = SMOKE.scramble(interop.state_to_numpy(s0), code, rng)
        if int(s0.k_enabled.sum()):
            leaves = SMOKE.scramble_kern(leaves, code, rng)
        s0 = interop.state_from_numpy(leaves, s0.pc.device)
    want = megastep_chunk_ref(imgs, ids, _clone(s0), chunk=chunk)
    for block in (16, 32, 128):
        got = mops.megastep_chunk(imgs, ids, _clone(s0), chunk=chunk,
                                  block=block)
        torch.cuda.synchronize()
        _assert_equal(want, got, f"chunk={chunk} seed={seed} block={block}")


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_traced_kernel_matches_plain(census_every_tenth, chunk, seed):
    """Traced: random per-lane policies (DENY, EMULATE on emulated and other
    numbers, one KILL) on fresh rings, and a scrambled trace carry on a
    scrambled state; every MachineState and TraceState leaf."""
    pps, _, imgs, ids, s0 = census_every_tenth
    dev = s0.pc.device
    B = int(s0.pc.shape[0])
    rng = np.random.default_rng(seed)
    pols = SMOKE.random_policies(B, rng, kill_lane=3)
    tr0 = fleet_trace(pps, device=dev)
    if seed == 0:
        pa, pg = tpolicy.policy_rows(pols)
        tr0 = tr0._replace(pol_action=torch.from_numpy(pa).to(dev),
                           pol_arg=torch.from_numpy(pg).to(dev))
    else:
        code = SMOKE.code_of(pps)
        leaves = SMOKE.scramble(interop.state_to_numpy(s0), code, rng)
        if int(s0.k_enabled.sum()):
            leaves = SMOKE.scramble_kern(leaves, code, rng)
        s0 = interop.state_from_numpy(leaves, dev)
        tr0 = interop.trace_from_numpy(SMOKE.scramble_trace(
            B, int(tr0.buf.shape[2]), rng, pols), dev)
    want = megastep_chunk_ref(imgs, ids, _clone(s0), _clone(tr0), chunk=chunk)
    for block in (16, 32):
        got = mops.megastep_chunk(imgs, ids, _clone(s0), _clone(tr0),
                                  chunk=chunk, block=block)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            _assert_equal(w, g, f"traced chunk={chunk} seed={seed} "
                                f"block={block}")


def test_run_on_card_matches_cpu(census_every_tenth, card):
    """The whole path to halt on the card equals the CPU path, and each
    chunk is one launch."""
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], [dict(r) for r in regs[:10]]
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


def test_traced_run_on_card_matches_cpu(census_every_tenth, card):
    """trace=True to halt on the card equals the CPU path, states and
    rings, with policy overrides on two lanes."""
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], [dict(r) for r in regs[:10]]
    for r in regs:
        r[19] = 3
    over = {1: [tpolicy.deny(-1, 13)], 4: [tpolicy.emulate(63, 8)]}
    got = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=32, regs=regs,
                             trace=True, policy_overrides=over, device=card)
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=32, regs=regs,
                              trace=True, policy_overrides=over,
                              device="cpu")
    for w, g in zip(want, got):
        _assert_equal(w, type(g)(*(x.cpu() for x in g)), "traced run")
    assert int(want[1].deny_count[1]) > 0
