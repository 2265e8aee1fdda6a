"""The PyTorch port's fleet path against the JAX package, on the CPU.

Everything runs with ``HookConfig(emul_enabled=False)``, the configuration
the port covers so far.  The tolerance is bit-exact on every one of the 34
``MachineState`` leaves: the whole computation is int64/int32/bool.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import fleet as jfleet
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core.machine import MachineState as JMachineState
from repro.kernels.megastep import ops as jmops

from repro_torch.core import (HALT_EXIT, HALT_FUEL, RUNNING, HookConfig,
                              Mechanism, fleet, hook_invocations, interop,
                              pack_fleet, prepare, programs,
                              run_fleet_prepared, run_prepared, unstack_state)
from repro_torch.core.machine import MachineState

ROOT = Path(__file__).resolve().parents[1]
FUEL = 300_000
FUZZ_STEPS = 24

# What the JAX package gives for the full 500-lane census with emulation
# off (run_fleet_prepared, chunk 128, fuel 10M).  That run takes minutes on
# the CPU, so tier-1 pins the numbers here and chip_smoke.py asserts them
# for the port on the card.
CENSUS_JAX = {"lanes": 500, "total_steps": 3_603_972,
              "longest_lane_steps": 8_306, "enosys_total": 10_850}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_fleet", ROOT / "chip_smoke.py")

# tests/test_fleet_parity.py's PROGS, by name so each package builds its own
PROGS = {
    "getpid": lambda p: p.getpid_loop(20),
    "read": lambda p: p.read_loop(4, 256),
    "mixed": lambda p: p.mixed_ops(3, 128),
    "io_bw": lambda p: p.io_bandwidth(3, 4096),
    "retry": lambda p: p.retry_loop(2),
    "caller_x8": lambda p: p.caller_x8(3),
}
CENSUS = {
    "getpid": lambda p: p.getpid_loop_param(),
    "read": lambda p: p.read_loop_param(1024),
    "mixed": lambda p: p.mixed_ops_param(512),
    "io_bw": lambda p: p.io_bandwidth_param(4096),
    "churn": lambda p: p.file_churn_param(512),
}
# lanes that run out of fuel: (mechanism, workload, x19, fuel)
FUEL_LANES = [("ASC", "getpid", 1000, 500), ("PTRACE", "read", 100, 777)]


def _grid(pkg):
    """The test fleet in one package: the PROGS grid, one lane per census
    image (x19 = 2 or 3), and two lanes that exhaust their fuel."""
    if pkg == "jax":
        mechs, progs = JMechanism, jprograms
        cfg = JHookConfig(emul_enabled=False)
        prep = jprepare
    else:
        mechs, progs = Mechanism, programs
        cfg = HookConfig(emul_enabled=False)
        prep = prepare
    pps, regs = [], []
    for mech in Mechanism:
        for build in PROGS.values():
            for virt in ([True, False] if mech is not Mechanism.NONE
                         else [False]):
                pps.append(prep(build(progs), mechs[mech.name],
                                virtualize=virt, cfg=cfg))
                regs.append(None)
    for i, (_, mech, virt) in enumerate(SMOKE.MECHS):
        for j, build in enumerate(CENSUS.values()):
            pps.append(prep(build(progs), mechs[mech.name], virtualize=virt,
                            cfg=cfg))
            regs.append({19: 2 + (i + j) % 2})
    for mech, wl, n, _ in FUEL_LANES:
        pps.append(prep(CENSUS[wl](progs), mechs[mech], virtualize=True,
                        cfg=cfg))
        regs.append({19: n})
    fuel = np.full(len(pps), FUEL, np.int64)
    fuel[-len(FUEL_LANES):] = [f for *_, f in FUEL_LANES]
    return pps, regs, fuel


@pytest.fixture(scope="module")
def packed():
    """Both packages' packed fleets from the same grid."""
    jpps, regs, fuel = _grid("jax")
    tpps, _, _ = _grid("torch")
    jimgs, jids, js = jpack_fleet(jpps, fuel=FUEL, regs=regs)
    js = js._replace(fuel=jnp.asarray(fuel))
    timgs, tids, ts = pack_fleet(tpps, fuel=FUEL, regs=regs, device="cpu")
    ts.fuel.copy_(torch.from_numpy(fuel))
    jleaves = {f: np.asarray(getattr(js, f)) for f in JMachineState._fields}
    return dict(jpps=jpps, tpps=tpps, regs=regs, fuel=fuel,
                jimgs=jimgs, jids=np.asarray(jids), jleaves=jleaves,
                timgs=timgs, tids=tids, ts=ts)


def _fresh(packed):
    return interop.state_from_numpy(packed["jleaves"], "cpu")


def _jax_state(leaves):
    return JMachineState(*(jnp.asarray(leaves[f])
                           for f in JMachineState._fields))


def _assert_leaves_equal(want: dict, got: MachineState, what):
    assert list(want) == list(MachineState._fields)
    for f in MachineState._fields:
        a, b = want[f], getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        if not np.array_equal(a, b):
            lanes = np.unique(np.argwhere(a != b)[:, 0]).tolist()
            raise AssertionError(f"{what}: leaf {f!r} differs in lanes "
                                 f"{lanes[:10]}")


def test_pack_fleet_matches_jax(packed):
    """Images, image ids and all 34 state leaves, also through interop."""
    assert np.array_equal(packed["tids"].numpy(), packed["jids"])
    assert packed["tids"].dtype == torch.int32
    for f in ("packed", "imm"):
        assert np.array_equal(getattr(packed["timgs"], f).numpy(),
                              np.asarray(getattr(packed["jimgs"], f))), f
    _assert_leaves_equal(packed["jleaves"], packed["ts"], "pack_fleet")
    _assert_leaves_equal(packed["jleaves"], _fresh(packed), "interop")
    back = interop.state_to_numpy(packed["ts"])
    _assert_leaves_equal(back, _fresh(packed), "state_to_numpy")
    imgs = interop.images_from_numpy(
        {f: np.asarray(getattr(packed["jimgs"], f)) for f in ("packed", "imm")})
    for a, b in zip(imgs, packed["timgs"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_fuzz_matches_jax(packed, seed):
    """Seeded random states (registers, memory, flags, signal state, pc in
    the text; negative and unaligned x1/x2) through FUZZ_STEPS steps of
    ``_step_core`` in both packages."""
    leaves = SMOKE.scramble(packed["jleaves"], SMOKE.code_of(packed["tpps"]),
                            np.random.default_rng(seed))
    want = jmops.megastep(packed["jimgs"], jnp.asarray(packed["jids"]),
                          _jax_state(leaves), chunk=FUZZ_STEPS, impl="ref")
    want = {f: np.asarray(getattr(want, f)) for f in JMachineState._fields}
    s = interop.state_from_numpy(leaves, "cpu")
    for _ in range(FUZZ_STEPS):
        s, _ = fleet._step_core(packed["timgs"], packed["tids"], s)
    _assert_leaves_equal(want, s, f"fuzz seed {seed}")
    # the fuzz must reach the rare paths, not just fault at once
    assert (want["icount"] == FUZZ_STEPS).any()
    assert (want["halted"] != RUNNING).any()
    assert (want["enosys_count"] > 0).any()
    assert ((want["in_off"] != leaves["in_off"]) | (want["out_count"] != 0)
            ).any()  # a read fill or a write sum happened


@pytest.fixture(scope="module")
def jax_run(packed):
    out = jfleet.run_fleet(packed["jimgs"], _jax_state(packed["jleaves"]),
                           jnp.asarray(packed["jids"]), chunk=8)
    return {f: np.asarray(getattr(out, f)) for f in JMachineState._fields}


@pytest.fixture(scope="module")
def port_run(packed):
    """The port's chunk-8 run of the grid (checked against JAX below)."""
    return fleet.run_fleet(packed["timgs"], _fresh(packed), packed["tids"],
                           chunk=8, device="cpu")


@pytest.mark.parametrize("chunk", [1, 8, 128])
def test_whole_run_matches_jax(packed, jax_run, port_run, chunk):
    """The PROGS grid + one lane per census image, run to halt: the port
    at chunk 1, 8 and 128 against one JAX run."""
    out = port_run if chunk == 8 else fleet.run_fleet(
        packed["timgs"], _fresh(packed), packed["tids"], chunk=chunk,
        device="cpu")
    _assert_leaves_equal(jax_run, out, f"run_fleet chunk={chunk}")
    assert (out.halted.numpy()[:-len(FUEL_LANES)] == HALT_EXIT).all()


def test_summary_and_hook_counts_match_jax(jax_run, port_run):
    """fleet_summary rows and hook_invocations read the same results."""
    want = jfleet.fleet_summary(_jax_state(jax_run))
    assert fleet.fleet_summary(port_run) == want
    assert hook_invocations(port_run) == sum(r["hooks"] for r in want) > 0
    assert hook_invocations(unstack_state(port_run, 3)) == want[3]["hooks"]


def test_fleet_matches_width1_run_prepared(packed, port_run):
    """Fleet lanes equal the port's own width-1 run_prepared."""
    out = port_run
    n = len(packed["tpps"])
    # short lanes covering signal delivery, ptrace, trampolines, I/O and a
    # fuel-exhausted lane
    icount = out.icount.numpy()
    for lane in sorted(set(np.argsort(icount)[:4].tolist() + [n - 2])):
        ref = run_prepared(packed["tpps"][lane], fuel=int(packed["fuel"][lane]),
                           regs=packed["regs"][lane], device="cpu")
        got = unstack_state(out, lane)
        for f in MachineState._fields:
            assert torch.equal(getattr(ref, f), getattr(got, f)), (lane, f)


def test_fuel_exhaustion_and_span(packed, port_run):
    """Out-of-fuel lanes halt with HALT_FUEL at icount == fuel after a run;
    spans leave them RUNNING, and spans chained into a run give the run's
    result."""
    out = port_run
    k = len(FUEL_LANES)
    assert (out.halted.numpy()[-k:] == HALT_FUEL).all()
    assert np.array_equal(out.icount.numpy()[-k:], packed["fuel"][-k:])
    s = fleet.run_fleet_span(packed["timgs"], _fresh(packed), packed["tids"],
                             steps=800, chunk=16, device="cpu")
    assert (s.halted.numpy()[-k:] == RUNNING).all()
    assert np.array_equal(s.icount.numpy()[-k:], packed["fuel"][-k:])
    s = fleet.run_fleet(packed["timgs"], s, packed["tids"], chunk=8,
                        device="cpu")
    for f in MachineState._fields:
        assert torch.equal(getattr(s, f), getattr(out, f)), f


def test_per_call_cycles_match_jax():
    """The port's per-call cycles equal benchmarks/hook_overhead.py's JAX
    differential and reproduce Table 3 (asc 105, ld_preload 18, signal
    2812, ptrace 5940).  A loop iteration costs the same at any N, so the
    port runs the differential at N = 40 / 20."""
    bench = _load("_bench_hook_overhead",
                  ROOT / "benchmarks" / "hook_overhead.py")
    want = bench._per_call_cycles()
    got = SMOKE.per_call_cycles(device="cpu", n_hi=40, n_lo=20)
    assert got == want
    assert SMOKE.table3(got) == SMOKE.TABLE3_CYCLES


def test_census_counts_are_pinned():
    """chip_smoke.py holds the port to the JAX census counts."""
    assert SMOKE.CENSUS_EXPECTED == CENSUS_JAX


def test_unported_paths_raise():
    """Every fleet path is ported now: ``shard=True`` (on one device the
    JAX package's no-op), ``compact=True`` and ``pack_fleet(table=)`` run
    and agree with the fixed-width run; what still raises is what raises
    in JAX (an unknown engine, ``engine="pallas"`` with ``shard=True``)."""
    from repro_torch.core import FleetImageTable
    cfg = HookConfig(emul_enabled=False)
    pps = [prepare(programs.getpid_loop(3), Mechanism.ASC, virtualize=True,
                   cfg=cfg)] * 2
    with pytest.raises(ValueError, match="does not compose with shard"):
        run_fleet_prepared(pps, device="cpu", shard=True, engine="pallas")
    fixed = run_fleet_prepared(pps, device="cpu")
    sharded = run_fleet_prepared(pps, device="cpu", shard=True)
    assert all(torch.equal(x, y) for x, y in zip(fixed, sharded))
    compacted = run_fleet_prepared(pps, device="cpu", compact=True)
    assert all(torch.equal(x, y) for x, y in zip(fixed, compacted))
    imgs, ids, _ = pack_fleet(pps, table=FleetImageTable(2, device="cpu"),
                              device="cpu")
    assert imgs.packed.shape[0] == 2 and ids.tolist() == [0, 0]
    with pytest.raises(ValueError, match="unknown fleet engine"):
        run_fleet_prepared(pps, engine="mosaic", device="cpu")
    # both JAX engine names run the one dispatcher, with equal results
    a = run_fleet_prepared(pps, engine="xla", device="cpu")
    b = run_fleet_prepared(pps, engine="pallas", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
