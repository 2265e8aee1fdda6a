"""The port's syscall tracing and policy against the JAX package, on the CPU.

Under test: :mod:`repro_torch.trace` (policy compilation, the trace carry,
ring decoding and strace rendering) and the traced executor — the policy
gate, the record ring, the histogram and the verdict counters.  Inputs are
made with numpy from a seed and go through both packages; the tolerance is
exact on every ``MachineState`` and ``TraceState`` leaf and on the decoded
text.
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
from repro.core import run_fleet_prepared as jrun_fleet_prepared
from repro.core.hookcfg import PolicyRule as JPolicyRule
from repro.core.machine import MachineState as JMachineState
from repro.kernels.megastep import ops as jmops
from repro.trace import policy as jpolicy
from repro.trace import recorder as jrecorder

from repro_torch.core import (HookConfig, Mechanism, fleet, interop,
                              pack_fleet, prepare, programs,
                              run_fleet_prepared)
from repro_torch.core.fleet import TraceState
from repro_torch.core.hookcfg import PolicyRule
from repro_torch.core.machine import MachineState
from repro_torch.core.runtime import fleet_trace
from repro_torch.trace import policy as tpolicy
from repro_torch.trace import recorder as trecorder

ROOT = Path(__file__).resolve().parents[1]
FUEL = 300_000
FUZZ_STEPS = 12


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_trace", ROOT / "chip_smoke.py")


def _jrules(rules):
    return None if rules is None else [
        JPolicyRule(syscall_nr=r.syscall_nr, action=r.action, arg=r.arg)
        for r in rules]


def _equal(want, got, what):
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


# -- (d) policy compilation ---------------------------------------------------

def test_policy_compilation_matches_jax():
    """compile_policy / policy_rows on seeded random rule lists (every
    action, every modelled number, unmodelled numbers, the -1 default
    line, last match wins) equal the JAX package's."""
    rng = np.random.default_rng(0)
    nrs = [-1, 0, 17, 56, 57, 62, 63, 64, 93, 139, 172, 181, 278, 1023]
    lists = []
    for _ in range(60):
        rules = [PolicyRule(syscall_nr=int(rng.choice(nrs)),
                            action=str(rng.choice(["allow", "deny", "emulate",
                                                   "kill", "DENY"])),
                            arg=int(rng.integers(-9, 9999)))
                 for _ in range(int(rng.integers(0, 6)))]
        lists.append(rules if rng.random() < 0.9 else None)
    for rules in lists:
        if rules is None:
            continue
        want = jpolicy.compile_policy(_jrules(rules))
        got = tpolicy.compile_policy(rules)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jpolicy.policy_rows([_jrules(r) for r in lists]),
                    tpolicy.policy_rows(lists)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [int(a) for a in tpolicy.Action] == [int(a) for a in jpolicy.Action]


@pytest.mark.parametrize("bad", [
    dict(syscall_nr=63, action="block"), dict(syscall_nr=-2),
    dict(syscall_nr=1024), dict(syscall_nr=True), dict(syscall_nr=63,
                                                       arg="7"),
    dict(syscall_nr=63, action="deny", arg=False)])
def test_validate_rules_matches_jax(bad):
    """Malformed rules raise ValueError with the same message in both."""
    with pytest.raises(ValueError) as want:
        jpolicy.validate_rules([JPolicyRule(**bad)])
    with pytest.raises(ValueError) as got:
        tpolicy.validate_rules([PolicyRule(**bad)])
    assert str(got.value) == str(want.value).replace(
        "repro.core.hookcfg", "repro_torch.core.hookcfg")


def test_make_trace_state_matches_jax():
    rng = np.random.default_rng(1)
    pols = SMOKE.random_policies(9, rng, kill_lane=2)
    want = jrecorder.make_trace_state(9, 16, policies=[_jrules(p)
                                                       for p in pols])
    _equal(want, trecorder.make_trace_state(9, 16, policies=pols,
                                            device="cpu"), "pols")
    _equal(jrecorder.make_trace_state(3),
           trecorder.make_trace_state(3, device="cpu"), "default")


# -- (e) traced runs ----------------------------------------------------------

def _cells(pkg):
    """One lane per census workload x mechanism plus the emulation probes,
    default config; a few lanes carry their own HookConfig.policy."""
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    cfg_of = HookConfig if pkg == "torch" else JHookConfig
    conv = (lambda r: r) if pkg == "torch" else _jrules
    w = [lambda: P.getpid_loop_param(), lambda: P.read_loop_param(256),
         lambda: P.mixed_ops_param(128), lambda: P.file_churn_param(256),
         lambda: P.proc_probe_param(), lambda: P.bad_fd_probe()]
    pps, regs = [], []
    cfg_pols = {1: [tpolicy.deny(-1, 1)],
                8: [tpolicy.emulate(172, 99), tpolicy.deny(63, 4)]}
    for i, (_, mech, virt) in enumerate(SMOKE.MECHS):
        for j, build in enumerate(w):
            k = len(pps)
            cfg = cfg_of(policy=conv(cfg_pols[k])) if k in cfg_pols \
                else cfg_of(emul_enabled=(k % 7 != 3))
            pps.append((prepare if pkg == "torch" else jprepare)(
                build(), M[mech.name], virtualize=virt, cfg=cfg))
            regs.append({19: 2 + (i + j) % 2})
    return pps, regs


@pytest.fixture(scope="module")
def traced_runs():
    """Both packages' traced runs to halt, with seeded random per-lane
    policy overrides (DENY, EMULATE on emulated and other numbers, a KILL
    lane) on top of the configs' own policies."""
    jpps, regs = _cells("jax")
    tpps, _ = _cells("torch")
    rng = np.random.default_rng(7)
    pols = SMOKE.random_policies(len(tpps), rng, kill_lane=5)
    over = {i: p for i, p in enumerate(pols) if p and i not in (1, 8)}
    jover = {i: _jrules(p) for i, p in over.items()}
    want = jrun_fleet_prepared(jpps, fuel=FUEL, chunk=16, regs=regs,
                               trace=True, policy_overrides=jover)
    got = run_fleet_prepared(tpps, fuel=FUEL, chunk=16, regs=regs,
                             trace=True, policy_overrides=over, device="cpu")
    return want, got, (tpps, regs)


def test_traced_run_matches_jax(traced_runs):
    """Every MachineState and TraceState leaf, and the verdicts all occur
    (DENY, EMULATE routed and constant, KILL)."""
    (ws, wt), (gs, gt), _ = traced_runs
    _equal(ws, gs, "state")
    _equal(wt, gt, "trace")
    hist = gt.hist.numpy().sum(axis=(0, 1))
    assert all(hist[v] > 0 for v in range(fleet.N_VERDICTS)), hist
    assert int(gt.kill_count.sum()) == 1 and int(gs.halted[5]) == 6


def test_harvest_and_strace_match_jax(traced_runs):
    """Decoded rings, strace text and histograms equal the JAX package's."""
    (_, wt), (_, gt), _ = traced_runs
    want, got = jrecorder.harvest(wt), trecorder.harvest(gt)
    assert [([_fields(r) for r in recs], d) for recs, d in got] == \
        [([_fields(r) for r in recs], d) for recs, d in want]
    for (wr, wd), (gr, gd) in zip(want, got):
        assert (trecorder.format_strace(gr, dropped=gd, pid=4242)
                == jrecorder.format_strace(wr, dropped=wd, pid=4242))
    for b in range(gt.count.shape[0]):
        assert (trecorder.lane_histogram(gt.hist[b])
                == jrecorder.lane_histogram(np.asarray(wt.hist[b])))
    rows = trecorder.decode_rows(gt.buf[0, 0, :3])
    assert [(_fields(r), r.name, trecorder.format_record(r)) for r in rows] \
        == [(_fields(r), r.name, jrecorder.format_record(r)) for r in
            jrecorder.decode_rows(np.asarray(wt.buf[0, 0, :3]))]


def _fields(r):
    return (r.step, r.pc, r.nr, r.x0, r.x1, r.x2, r.ret, r.verdict)


def test_all_allow_trace_is_invisible(traced_runs):
    """Under all-ALLOW policies a traced run's machine states equal the
    untraced run's, and every executed svc appended one record."""
    _, _, (tpps, regs) = traced_runs
    pps = [prepare(programs.file_churn_param(256), Mechanism.ASC,
                   virtualize=True), *tpps[:6]]
    pps = [pp for pp in pps if not (pp.cfg and pp.cfg.policy)]
    regs = [{19: 3}] * len(pps)
    plain = run_fleet_prepared(pps, fuel=FUEL, chunk=8, regs=regs,
                               device="cpu")
    s, tr = run_fleet_prepared(pps, fuel=FUEL, chunk=8, regs=regs,
                               trace=True, device="cpu")
    for f in MachineState._fields:
        assert torch.equal(getattr(plain, f), getattr(s, f)), f
    assert torch.equal(tr.count, tr.hist.sum((1, 2)))
    assert int(tr.deny_count.sum() + tr.emul_count.sum()
               + tr.kill_count.sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_traced_step_fuzz_matches_jax(seed):
    """Scrambled states (guest-kernel tables too) and scrambled trace
    carries (``count < base`` included) with random policies, through
    FUZZ_STEPS steps in both packages: every leaf of both carries."""
    jpps, regs = _cells("jax")
    tpps, _ = _cells("torch")
    jimgs, jids, js = jpack_fleet(jpps, fuel=FUEL, regs=regs)
    timgs, tids, _ = pack_fleet(tpps, fuel=FUEL, regs=regs, device="cpu")
    rng = np.random.default_rng(seed)
    code = SMOKE.code_of(tpps)
    leaves = {f: np.asarray(getattr(js, f)) for f in JMachineState._fields}
    leaves = SMOKE.scramble_kern(SMOKE.scramble(leaves, code, rng), code, rng)
    B = len(tpps)
    tleaves = SMOKE.scramble_trace(B, 8, rng, SMOKE.random_policies(
        B, rng, kill_lane=B - 1))
    jtr = jfleet.TraceState(*(jnp.asarray(tleaves[f])
                              for f in jfleet.TraceState._fields))
    ws, wt = jmops.megastep(jimgs, jnp.asarray(jids),
                            JMachineState(*(jnp.asarray(leaves[f])
                                            for f in JMachineState._fields)),
                            jtr, chunk=FUZZ_STEPS, impl="ref")
    s = interop.state_from_numpy(leaves)
    tr = interop.trace_from_numpy(tleaves, "cpu")
    for _ in range(FUZZ_STEPS):
        s, tr = fleet._step_core(timgs, tids, s, tr)
    _equal(ws, s, f"fuzz seed {seed}")
    _equal(wt, tr, f"fuzz seed {seed}")
    assert (np.asarray(wt.count) > tleaves["count"]).sum() >= 3


def test_fleet_trace_and_pack_fleet_trace():
    """pack_fleet(trace=True) returns the fourth element, built from the
    configs' policies and trace_cap, equal to the JAX package's."""
    jpps, regs = _cells("jax")
    tpps, _ = _cells("torch")
    out = pack_fleet(tpps, regs=regs, trace=True, device="cpu")
    assert len(out) == 4 and isinstance(out[3], TraceState)
    want = jpack_fleet(jpps, regs=regs, trace=True)[3]
    _equal(want, out[3], "pack_fleet trace")
    _equal(want, fleet_trace(tpps, device="cpu"), "fleet_trace")
    with pytest.raises(ValueError, match="trace=True"):
        run_fleet_prepared(tpps[:2], policy_overrides={0: []}, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        run_fleet_prepared(tpps[:2], trace=True, policy_overrides={5: []},
                           device="cpu")
