"""The port's completeness strategy C3 (``repro_torch.core.completeness``)
against the JAX package's ``repro.core.completeness``, on the CPU.

Under test: ``diagnose_c3``, ``diagnose_c3_fleet`` and ``run_with_c3`` on
the R3 workloads of ``tests/test_core_completeness.py`` and
``tests/test_c3_properties.py``: the Figure-4 two-run flow, the
discrimination rule (``pc == x8 < 600`` and a ``blr`` before x30) over
real R3 faults perturbed into every neighbouring fault shape, fleet
diagnosis lane for lane, C3 disabled, and pins shared through one
config.  The same programs and the same perturbations (drawn by
hypothesis, at the repo's example count) go through both packages; the
events and the final machine states must be equal.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import HAVE_HYPOTHESIS, given, settings, st

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import diagnose_c3 as jdiagnose_c3
from repro.core import diagnose_c3_fleet as jdiagnose_c3_fleet
from repro.core import fleet as jfleet
from repro.core import isa as jisa
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_prepared as jrun_prepared
from repro.core import run_with_c3 as jrun_with_c3
from repro.core.image import APP_BASE as JAPP_BASE
from repro.core.isa import Asm as JAsm

from repro_torch.core import (HookConfig, Mechanism, diagnose_c3,
                              diagnose_c3_fleet, fleet, isa, layout as L,
                              machine as M, mem_read, prepare, programs,
                              run_prepared, run_with_c3)
from repro_torch.core.image import APP_BASE
from repro_torch.core.isa import Asm

MAX_EXAMPLES = int(os.environ.get("ASC_TEST_EXAMPLES", "25"))

_SETTINGS = dict(max_examples=MAX_EXAMPLES, deadline=None, derandomize=True)
if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck
    _SETTINGS["suppress_health_check"] = list(HealthCheck)

_CACHE = {}


def _events(evs):
    return [None if e is None else dataclasses.asdict(e) for e in evs]


def _equal_states(want, got):
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _r3_fault():
    """A real R3 fault in both packages: an indirect blr onto a rewritten
    svc (Figure 4), run to its SEGV."""
    if "r3" not in _CACHE:
        jpp = jprepare(jprograms.indirect_svc(2), JMechanism.ASC,
                       virtualize=True)
        jst = jrun_prepared(jpp, fuel=100_000)
        tpp = prepare(programs.indirect_svc(2), Mechanism.ASC,
                      virtualize=True)
        tst = run_prepared(tpp, fuel=100_000, device="cpu")
        _equal_states(jst, tst)
        assert int(tst.halted) == M.HALT_SEGV
        _CACHE["r3"] = (jpp, jst, tpp, tst)
    return _CACHE["r3"]


def _mutate(pkg, state, *, pc=None, x8=None, x30=None, halted=None):
    """The same perturbation of a JAX (``pkg == "jax"``) or a port
    state."""
    if pkg == "jax":
        regs = state.regs
        if x8 is not None:
            regs = regs.at[8].set(jnp.int64(x8))
        if x30 is not None:
            regs = regs.at[30].set(jnp.int64(x30))
        return state._replace(
            regs=regs,
            fault_pc=jnp.int64(pc) if pc is not None else state.fault_pc,
            halted=jnp.int64(halted) if halted is not None else state.halted)
    regs = state.regs.clone()
    if x8 is not None:
        regs[8] = x8
    if x30 is not None:
        regs[30] = x30
    return state._replace(
        regs=regs,
        fault_pc=torch.tensor(pc) if pc is not None else state.fault_pc,
        halted=torch.tensor(halted) if halted is not None else state.halted)


def _both(**kw):
    jpp, jst, tpp, tst = _r3_fault()
    j = jdiagnose_c3(jpp, _mutate("jax", jst, **kw))
    t = diagnose_c3(tpp, _mutate("torch", tst, **kw))
    assert _events([j]) == _events([t]), kw
    return t


# -- the two-run flow (tests/test_core_completeness.py) -----------------------

@pytest.mark.parametrize("n", [1, 3])
def test_c3_two_run_flow_matches_jax(n):
    """fault -> diagnose -> config -> re-execute: events, runs, the final
    state and the learned pin equal the JAX package's."""
    jcfg, tcfg = JHookConfig(), HookConfig()
    jst, _, jev, jruns = jrun_with_c3(lambda: jprograms.indirect_svc(n),
                                      cfg=jcfg, virtualize=True)
    tst, tpp, tev, truns = run_with_c3(lambda: programs.indirect_svc(n),
                                       cfg=tcfg, virtualize=True,
                                       device="cpu")
    assert truns == jruns == 2
    assert _events(tev) == _events(jev)
    assert tev[0].lib == "libc.so" and tev[0].offset == 4
    _equal_states(jst, tst)
    assert mem_read(tst, L.SCRATCH) == L.VIRT_PID
    assert tcfg.is_pinned("libc.so", 4, 0x18004)
    assert [dataclasses.astuple(p) for p in tcfg.pinned] == \
        [dataclasses.astuple(p) for p in jcfg.pinned]


def test_c3_disabled_leaves_the_fault():
    jst, _, jev, jruns = jrun_with_c3(lambda: jprograms.indirect_svc(1),
                                      cfg=JHookConfig(enable_c3=False))
    tst, _, tev, truns = run_with_c3(lambda: programs.indirect_svc(1),
                                     cfg=HookConfig(enable_c3=False),
                                     device="cpu")
    assert truns == jruns == 1 and not tev and not jev
    assert int(tst.halted) == M.HALT_SEGV
    _equal_states(jst, tst)


def test_config_pin_is_shareable_across_processes():
    cfg = HookConfig()
    _, _, events, _ = run_with_c3(lambda: programs.indirect_svc(1), cfg=cfg,
                                  virtualize=True, device="cpu")
    assert events
    st2, _, events2, runs2 = run_with_c3(lambda: programs.indirect_svc(5),
                                         cfg=cfg, virtualize=True,
                                         device="cpu")
    assert runs2 == 1 and not events2 and int(st2.halted) == M.HALT_EXIT


def test_genuine_wild_jump_not_diagnosed():
    """br to a null-page address with x8 != pc: not ours, in both."""
    def build(I, A, base):
        a = A(base)
        a.label("main")
        a.emit(I.movz(9, 300))
        a.emit(I.movz(8, 172, sf=0))
        a.emit(I.br(9))
        return a

    jpp = jprepare(build(jisa, JAsm, JAPP_BASE), JMechanism.ASC)
    tpp = prepare(build(isa, Asm, APP_BASE), Mechanism.ASC)
    jst = jrun_prepared(jpp)
    tst = run_prepared(tpp, device="cpu")
    _equal_states(jst, tst)
    assert int(tst.halted) == M.HALT_SEGV
    assert diagnose_c3(tpp, tst) is None and jdiagnose_c3(jpp, jst) is None


# -- the discrimination rule (tests/test_c3_properties.py) --------------------

@settings(**_SETTINGS)
@given(pc=st.integers(0, 2 * L.MAX_SYSCALL_NR),
       x8=st.integers(0, 2 * L.MAX_SYSCALL_NR))
def test_rule_requires_pc_equals_x8_below_bound(pc, x8):
    ev = _both(pc=pc, x8=x8)
    if pc != x8 or pc >= L.MAX_SYSCALL_NR:
        assert ev is None
    else:
        assert ev is not None and ev.syscall_nr == x8


@settings(**_SETTINGS)
@given(x8=st.integers(0, L.MAX_SYSCALL_NR - 1), offset=st.integers(0, 64))
def test_null_deref_never_diagnosed(x8, offset):
    pc = offset * 8
    if pc == x8:
        pc += 1
    assert _both(pc=pc, x8=x8) is None


@settings(**_SETTINGS)
@given(x30=st.integers(0, L.CODE_LIMIT + 64))
def test_bad_return_chain_matches_jax(x30):
    _both(x30=x30)


def test_non_segv_halts_never_diagnosed():
    for h in (M.RUNNING, M.HALT_EXIT, M.HALT_TRAP, M.HALT_FUEL,
              M.HALT_BADMEM):
        assert _both(halted=h) is None
    assert _both() is not None       # the untouched genuine fault


@settings(**_SETTINGS)
@given(data=st.data())
def test_fleet_diagnosis_matches_scalar_and_jax(data):
    """One host copy for the whole fleet; lane i's verdict equals
    diagnose_c3 of lane i and the JAX package's fleet verdict."""
    jpp, jst, tpp, tst = _r3_fault()
    n = data.draw(st.integers(2, 8), label="lanes")
    kws = []
    for _ in range(n):
        kind = data.draw(st.integers(0, 3), label="kind")
        if kind == 1:
            kws.append({"pc": data.draw(st.integers(0, 700), label="pc"),
                        "x8": data.draw(st.integers(0, 700), label="x8")})
        elif kind == 2:
            kws.append({"x30": data.draw(st.integers(0, L.CODE_LIMIT),
                                         label="x30")})
        elif kind == 3:
            kws.append({"halted": M.HALT_EXIT})
        else:
            kws.append({})
    jlanes = [_mutate("jax", jst, **kw) for kw in kws]
    tlanes = [_mutate("torch", tst, **kw) for kw in kws]
    pps = [tpp] * n
    pps[0] = None                    # an empty server slot
    got = diagnose_c3_fleet(pps, fleet.stack_states(tlanes))
    want = jdiagnose_c3_fleet([None] + [jpp] * (n - 1),
                              jfleet.stack_states(jlanes))
    assert _events(got) == _events(want)
    assert _events(got[1:]) == _events([diagnose_c3(tpp, s)
                                        for s in tlanes[1:]])
    halted = np.full(n, M.HALT_EXIT)
    assert diagnose_c3_fleet(pps, fleet.stack_states(tlanes),
                             halted=halted) == [None] * n
