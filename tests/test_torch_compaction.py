"""The port's live-lane compaction against the JAX package, on the CPU.

Under test: the ladder and the bucket choice (``compact_ladder``,
``choose_bucket``), the lane builders and permutations
(``make_halted_states``, ``make_empty_trace``, ``permute_split``,
``concat_lanes``), the compacted driver (``run_fleet_compact`` with its
``stats`` ledger) and its config path (``run_fleet_prepared(compact=)``,
``precompile_compact``).  The same prepared processes go through both
packages; the tolerance is exact on every ``MachineState`` and
``TraceState`` leaf and on every entry of the ledger.
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import fleet as jfleet
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_fleet_prepared as jrun_fleet_prepared

from repro_torch.core import (HookConfig, Mechanism, fleet, pack_fleet,
                              precompile_compact, prepare, programs,
                              run_fleet, run_fleet_prepared)

ROOT = Path(__file__).resolve().parents[1]
FUEL = 150_000


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_compact", ROOT / "chip_smoke.py")


def _equal(want, got, what):
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


# -- the ladder and the bucket choice -----------------------------------------

def test_compact_ladder_matches_jax():
    for n, mb, div in itertools.product(
            [1, 2, 3, 7, 8, 9, 16, 31, 100, 128, 129, 500], [1, 2, 3, 8, 64],
            [1, 2, 4]):
        assert (fleet.compact_ladder(n, mb, divisor=div)
                == jfleet.compact_ladder(n, mb, divisor=div)), (n, mb, div)
    assert fleet.compact_ladder(500) == [500, 256, 128, 64, 32, 16, 8]
    with pytest.raises(ValueError):
        fleet.compact_ladder(0)


@pytest.mark.parametrize("hysteresis", [0.0, 0.125, 0.25, 0.5, 0.9])
def test_choose_bucket_matches_jax(hysteresis):
    for ladder in ([500, 256, 128, 64, 32, 16, 8], [10, 8, 4, 2], [7]):
        for n_live in range(0, max(ladder) + 2, 1 if max(ladder) < 20 else 3):
            for cur in (None, *ladder):
                assert (fleet.choose_bucket(ladder, n_live, cur=cur,
                                            hysteresis=hysteresis)
                        == jfleet.choose_bucket(ladder, n_live, cur=cur,
                                                hysteresis=hysteresis)), \
                    (ladder, n_live, cur)


# -- the lane builders and permutations ---------------------------------------

def test_lane_builders_match_jax():
    _equal(jfleet.make_halted_states(3), fleet.make_halted_states(
        3, device="cpu"), "halted states")
    _equal(jfleet.make_empty_trace(3, 5), fleet.make_empty_trace(
        3, 5, device="cpu"), "empty trace")
    s = fleet.make_halted_states(2, device="cpu")
    assert len({x.data_ptr() for x in s}) == len(s)  # no shared buffers


def test_permute_split_and_concat_match_jax():
    rng = np.random.default_rng(5)
    B = 6
    s = fleet.make_halted_states(B, device="cpu")
    tr = fleet.make_empty_trace(B, 4, device="cpu")
    for x in (*s, *tr):
        x.copy_(torch.from_numpy(rng.integers(-99, 99, tuple(x.shape)))
                .to(x.dtype))
    js = jfleet.MachineState(*(x.numpy() for x in s))
    jt = jfleet.TraceState(*(x.numpy() for x in tr))
    keep, drop = np.array([4, 0, 2]), np.array([1, 5, 3])
    (wk, wt), (dk, dt) = jfleet.permute_split((js, jt), keep, drop)
    (gk, gt), (ek, et) = fleet.permute_split((s, tr), keep, drop)
    for w, g in ((wk, gk), (wt, gt), (dk, ek), (dt, et)):
        _equal(w, g, "permute_split")
    assert gk.mem.data_ptr() != s.mem.data_ptr()
    want = jfleet.concat_lanes((wk, wt), (dk, dt))
    got = fleet.concat_lanes((gk, gt), (ek, et))
    _equal(want[0], got[0], "concat states")
    _equal(want[1], got[1], "concat carry")


# -- the compacted driver -----------------------------------------------------

def _processes(pkg, cfg=None):
    """Eight lanes, tail-heavy: most halt early, two run long; getpid and
    read loops under four mechanisms and a guest-kernel lane."""
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    prep = prepare if pkg == "torch" else jprepare
    cfg = cfg or (HookConfig() if pkg == "torch" else JHookConfig())
    cells = [prep(P.getpid_loop_param(), M.ASC, virtualize=True, cfg=cfg),
             prep(P.read_loop_param(256), M.SIGNAL, virtualize=True,
                  cfg=cfg),
             prep(P.getpid_loop_param(), M.NONE, cfg=cfg),
             prep(P.file_churn_param(64), M.LD_PRELOAD, virtualize=True,
                  cfg=cfg)]
    pick = [2, 0, 2, 3, 1, 2, 3, 2]
    iters = [1, 1, 2, 1, 1, 6, 3, 40]  # 14 to 287 steps
    return [cells[i] for i in pick], [{19: n} for n in iters]


@pytest.fixture(scope="module")
def processes():
    return _processes("jax"), _processes("torch")


@pytest.fixture(scope="module")
def jax_compacted(processes):
    """The JAX package's compacted run (min_bucket 2, chunk 4), traced
    under all-ALLOW policies: its states are the untraced run's too (the
    JAX package's tracing is invisible to the machine), so one run serves
    both cases and each rung is compiled once."""
    (jpps, regs), _ = processes
    ji, jd, js, jt = jpack_fleet(jpps, fuel=FUEL, regs=regs, trace=True)
    stats = {}
    out = jfleet.run_fleet_compact(ji, js, jd, chunk=4, min_bucket=2,
                                   trace=jt, stats=stats)
    return out, stats


@pytest.mark.parametrize("traced", [False, True])
def test_run_fleet_compact_matches_jax(processes, jax_compacted, traced):
    """min_bucket 2, chunk 4, spans of 32 steps: the compacted states (and
    carry) equal the JAX package's compacted run and the port's own
    fixed-width run, lane for lane, and the occupancy ledger equals the
    JAX package's; the lanes come back in the carry passed in."""
    (_, regs), (tpps, _) = processes
    want, want_stats = jax_compacted
    ti, td, ts, tt = pack_fleet(tpps, fuel=FUEL, regs=regs, trace=True,
                                device="cpu")
    stats = {}
    got = fleet.run_fleet_compact(ti, ts, td, chunk=4, min_bucket=2,
                                  trace=tt if traced else None, stats=stats,
                                  device="cpu")
    assert stats == want_stats
    assert len(stats["compactions"]) >= 2 and stats["final_bucket"] == 2
    assert stats["occupancy"] < 1.0
    _, _, fs, ft = pack_fleet(tpps, fuel=FUEL, regs=regs, trace=True,
                              device="cpu")
    fixed = run_fleet(ti, fs, td, chunk=4, trace=ft if traced else None,
                      device="cpu")
    pairs = zip(want, got, fixed) if traced else [(want[0], got, fixed)]
    for w, g, f in pairs:
        _equal(w, g, "compacted vs JAX")
        _equal(f, g, "compacted vs fixed width")
    assert (got[0] if traced else got).mem is ts.mem


def test_run_fleet_prepared_compact_config_path(jax_compacted):
    """compact=None defers to HookConfig.compact_enabled, with the config's
    min bucket and hysteresis: the states (and carry) equal the JAX
    package's config path and the uncompacted run, the arity is
    unchanged, and the ledger equals the JAX package's."""
    jpps, regs = _processes("jax", JHookConfig(compact_enabled=True,
                                               compact_min_bucket=2))
    tpps, _ = _processes("torch", HookConfig(compact_enabled=True,
                                             compact_min_bucket=2))
    want_stats, stats = {}, {}
    want = jrun_fleet_prepared(jpps, fuel=FUEL, chunk=4, regs=regs,
                               trace=True, compact_stats=want_stats)
    got = run_fleet_prepared(tpps, fuel=FUEL, chunk=4, regs=regs,
                             trace=True, compact_stats=stats, device="cpu")
    assert len(got) == 2
    assert stats == want_stats and stats["compactions"]
    _equal(want[0], got[0], "config path vs JAX")
    _equal(want[1], got[1], "config path carry vs JAX")
    plain = run_fleet_prepared(tpps, fuel=FUEL, chunk=4, regs=regs,
                               compact=False, device="cpu")
    _equal(plain, got[0], "config path vs fixed width")
    assert precompile_compact(tpps, device="cpu") == \
        jfleet.compact_ladder(len(tpps), 2)
    sharded_stats = {}
    sharded = run_fleet_prepared(tpps, fuel=FUEL, chunk=4, regs=regs,
                                 trace=True, shard=True,
                                 compact_stats=sharded_stats, device="cpu")
    _equal(want[0], sharded[0], "config path, shard=True, vs JAX")
    _equal(want[1], sharded[1], "config path carry, shard=True, vs JAX")
    assert sharded_stats == want_stats  # one device: the same ladder


# The JAX package's compacted census (HookConfig's ladder, chunk 128), from
# scripts/torch_port_pins.py; the traced run's ledger is the same.
COMPACT_STATS_JAX = {
    "ladder": [500, 256, 128, 64, 32, 16, 8], "interval": 1024,
    "dispatches": 9, "compactions": [{"from": 500, "to": 8, "live": 2}],
    "final_bucket": 8, "dispatched_lane_steps": 4_097_024,
    "useful_steps": 3_603_972, "occupancy": 0.8797,
    "wasted_lane_steps": 493_052}


def test_chip_smoke_compact_pins_match_jax_records():
    """chip_smoke.py holds the compacted census to the JAX package's
    ledger, untraced and traced; the useful lane-steps are the census's."""
    assert SMOKE.COMPACT_STATS == COMPACT_STATS_JAX
    assert SMOKE.COMPACT_STATS_TRACED == COMPACT_STATS_JAX
    assert COMPACT_STATS_JAX["useful_steps"] == \
        SMOKE.CENSUS_DEFAULT_EXPECTED["total_steps"]
    # 8 spans of 8 chunks at 500 lanes, then one chunk at 8
    assert COMPACT_STATS_JAX["dispatched_lane_steps"] == \
        (8 * 8 * 500 + 8) * 128
