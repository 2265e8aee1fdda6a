"""The port's lane management against the JAX package, on the CPU.

Under test: admission into a running fleet (``admit_lanes``), restore of
checkpointed lanes (``restore_lanes``), the image table
(``FleetImageTable``, ``set_image_row``, ``pack_fleet(table=)``), policy
rows swapped mid-run (``update_policy_rows``, ``update_fleet_policy``),
``finish_halt_codes``, ``unpack_images`` and the scalar machine API
(``step``, ``mem_read``, ``mem_read_block``, ``mem_write``).  The same
inputs (prepared processes, and states, carries, slots and policies made
from a seed with numpy) go through both packages; the tolerance is exact
on every ``MachineState`` and ``TraceState`` leaf.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Mechanism as JMechanism
from repro.core import fleet as jfleet
from repro.core import machine as jmachine
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import runtime as jruntime
from repro.core.hookcfg import PolicyRule as JPolicyRule
from repro.trace import policy as jpolicy

from repro_torch.core import (FleetImageTable, Mechanism, fleet, interop,
                              isa, layout as L, machine, pack_fleet, prepare,
                              programs, run_fleet, run_fleet_prepared,
                              run_fleet_span, update_fleet_policy)
from repro_torch.core.image import APP_BASE, Image
from repro_torch.core.isa import Asm
from repro_torch.core.machine import MachineState
from repro_torch.core.runtime import initial_state
from repro_torch.trace import policy as tpolicy

ROOT = Path(__file__).resolve().parents[1]
FUEL = 150_000


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_lanes", ROOT / "chip_smoke.py")


def _equal(want, got, what):
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def _jrules(rules):
    return None if rules is None else [
        JPolicyRule(syscall_nr=r.syscall_nr, action=r.action, arg=r.arg)
        for r in rules]


def _jax_tree(cls, leaves):
    return cls(*(jnp.asarray(leaves[f]) for f in cls._fields))


def _processes(pkg):
    """Eight lanes over five images: getpid and read loops under four
    mechanisms, and a guest-kernel lane (file churn), seeded counts."""
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    prep = prepare if pkg == "torch" else jprepare
    cells = [prep(P.getpid_loop_param(), M.ASC, virtualize=True),
             prep(P.read_loop_param(256), M.SIGNAL, virtualize=True),
             prep(P.getpid_loop_param(), M.PTRACE, virtualize=True),
             prep(P.file_churn_param(64), M.LD_PRELOAD, virtualize=True),
             prep(P.read_loop_param(256), M.NONE)]
    pick = [0, 1, 2, 3, 4, 0, 3, 1]
    regs = [{19: 1 + i % 3} for i in range(len(pick))]
    return [cells[i] for i in pick], regs


@pytest.fixture(scope="module")
def processes():
    return _processes("jax"), _processes("torch")


@pytest.fixture(scope="module")
def scrambled(processes):
    """A packed 8-lane fleet, scrambled (seed 3), as numpy leaves, with a
    scrambled trace carry under random policies."""
    (jpps, regs), (tpps, _) = processes
    _, _, js = jpack_fleet(jpps, fuel=FUEL, regs=regs)
    rng = np.random.default_rng(3)
    code = SMOKE.code_of(tpps)
    leaves = {f: np.asarray(getattr(js, f)) for f in MachineState._fields}
    leaves = SMOKE.scramble_kern(SMOKE.scramble(leaves, code, rng), code, rng)
    B = len(tpps)
    tleaves = SMOKE.scramble_trace(B, 8, rng, SMOKE.random_policies(B, rng))
    return leaves, tleaves


# -- admission ----------------------------------------------------------------

SLOTS = {"plain": [4, 1, 6], "padded": [5, 8, 2, 11],
         "negative": [-1, 0, -9, 3], "repeated": [2, 5, 2]}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("slots", list(SLOTS))
def test_admit_lanes_matches_jax(processes, scrambled, slots, traced):
    """Fresh initial states (and, traced, recycled rings and their
    policies) scattered into a scrambled fleet: every leaf equals the JAX
    package's, and each admitted row equals ``initial_state``."""
    (jpps, regs), (tpps, _) = processes
    leaves, tleaves = scrambled
    slots = SLOTS[slots]
    who = [(3 * i + 1) % len(tpps) for i in range(len(slots))]
    rng = np.random.default_rng(len(slots))
    rules = [r if r else None
             for r in SMOKE.random_policies(len(slots), rng)]
    jls = [jruntime.initial_state(jpps[w], fuel=FUEL, regs=regs[w])
           for w in who]
    tls = [initial_state(tpps[w], fuel=FUEL, regs=regs[w]) for w in who]
    js = _jax_tree(jfleet.MachineState, leaves)
    s = interop.state_from_numpy(leaves)
    if traced:
        jpol = [None if r is None else jpolicy.compile_policy(_jrules(r))
                for r in rules]
        tpol = [None if r is None else tpolicy.compile_policy(r)
                for r in rules]
        want_s, want_t = jfleet.admit_lanes(
            js, slots, jls, trace=_jax_tree(jfleet.TraceState, tleaves),
            policies=jpol)
        tr = interop.trace_from_numpy(tleaves)
        got_s, got_t = fleet.admit_lanes(s, slots, tls, trace=tr,
                                         policies=tpol)
        assert got_t is tr
        _equal(want_t, got_t, "admitted carry")
    else:
        want_s = jfleet.admit_lanes(js, slots, jls)
        got_s = fleet.admit_lanes(s, slots, tls)
    assert got_s is s
    _equal(want_s, got_s, "admitted states")
    B = len(tpps)
    for j, slot in enumerate(slots):
        if not -B <= slot < B or slot in slots[j + 1:]:
            continue
        row = fleet.unstack_state(got_s, slot)
        for f, x, y in zip(MachineState._fields, row, tls[j]):
            assert torch.equal(x, y), (slot, f)
        if traced:
            assert int(got_t.count[slot]) == 0
            assert not got_t.buf[slot].any() and not got_t.hist[slot].any()
            pa, pg = (tpolicy.compile_policy(rules[j]) if rules[j]
                      else tpolicy.ALLOW_ALL)
            assert np.array_equal(got_t.pol_action[slot].numpy(), pa)
            assert np.array_equal(got_t.pol_arg[slot].numpy(), pg)


def test_admit_lanes_rejects_bad_calls(processes):
    (_, regs), (tpps, _) = processes
    _, _, s, tr = pack_fleet(tpps, fuel=FUEL, regs=regs, trace=True,
                             device="cpu")
    ls = initial_state(tpps[0])
    with pytest.raises(ValueError, match="one lane state per slot"):
        fleet.admit_lanes(s, [0, 1], [ls])
    with pytest.raises(ValueError, match="policies require a trace"):
        fleet.admit_lanes(s, [0], [ls], policies=[None])
    before = [x.clone() for x in s]
    fleet.admit_lanes(s, [len(tpps), -len(tpps) - 1], [ls, ls])  # all pad
    assert all(torch.equal(x, y) for x, y in zip(before, s))


# -- restore ------------------------------------------------------------------

@pytest.mark.parametrize("traced", [False, True])
def test_restore_resumes_bit_identical(processes, traced):
    """Lanes checkpointed mid-run, their slots given to other processes
    for a span, then restored: the run ends bit-identical to an
    uninterrupted one (states and, traced, carries), and the restore
    scatter equals the JAX package's."""
    (jpps, regs), (tpps, _) = processes
    B = 6
    imgs, ids, _ = pack_fleet(tpps, fuel=FUEL, regs=regs, device="cpu")

    def fresh():
        _, _, s, tr = pack_fleet(tpps[:B], fuel=FUEL, regs=regs[:B],
                                 trace=True, device="cpu")
        return s, (tr if traced else None)

    s, tr = fresh()
    want = run_fleet(imgs, s, ids[:B].clone(), chunk=8, trace=tr,
                     device="cpu")
    s, tr = fresh()
    lane_ids = ids[:B].clone()
    run_fleet_span(imgs, s, lane_ids, steps=24, chunk=8, trace=tr,
                   device="cpu")
    slots = [1, 4]
    ck_s = [SMOKE.clone(fleet.unstack_state(s, b)) for b in slots]
    ck_t = [SMOKE.clone(fleet.unstack_trace(tr, b)) for b in slots] \
        if traced else None
    intruders = [6, 7]
    fleet.admit_lanes(s, slots, [initial_state(tpps[w], fuel=FUEL,
                                               regs=regs[w])
                                 for w in intruders], trace=tr,
                      policies=[None, None] if traced else None)
    lane_ids[slots] = ids[intruders]
    run_fleet_span(imgs, s, lane_ids, steps=16, chunk=8, trace=tr,
                   device="cpu")
    before_s = {f: x.numpy().copy() for f, x in zip(s._fields, s)}
    before_t = {f: x.numpy().copy() for f, x in zip(tr._fields, tr)} \
        if traced else None
    fleet.restore_lanes(s, slots + [B + 3], ck_s + [ck_s[0]], trace=tr,
                        lane_traces=ck_t + [ck_t[0]] if traced else None)
    ck_j = [jfleet.MachineState(*(jnp.asarray(x.numpy()) for x in c))
            for c in ck_s]
    if traced:
        ck_jt = [jfleet.TraceState(*(jnp.asarray(x.numpy()) for x in c))
                 for c in ck_t]
        js, jt = jfleet.restore_lanes(
            _jax_tree(jfleet.MachineState, before_s), slots + [B + 3],
            ck_j + [ck_j[0]], trace=_jax_tree(jfleet.TraceState, before_t),
            lane_traces=ck_jt + [ck_jt[0]])
        _equal(jt, tr, "restored carry")
    else:
        js = jfleet.restore_lanes(_jax_tree(jfleet.MachineState, before_s),
                                  slots + [B + 3], ck_j + [ck_j[0]])
    _equal(js, s, "restored states")
    lane_ids[slots] = ids[slots]
    got = run_fleet(imgs, s, lane_ids, chunk=8, trace=tr, device="cpu")
    for w, g in zip(want, got) if traced else [(want, got)]:
        _equal(w, g, "run on after the restore")


# -- the image table ----------------------------------------------------------

def test_image_table_matches_jax(processes):
    """A scripted admit/release sequence over five images in a 3-row table:
    the same rows, counters, evictions (oldest free row first, cached
    digests reused) and tables as the JAX package's, and the same error
    when every row is live."""
    (jpps, _), (tpps, _) = processes
    jt, tt = jruntime.FleetImageTable(3), FleetImageTable(3, device="cpu")
    script = [("admit", 0), ("admit", 1), ("admit", 0), ("admit", 2),
              ("release", 1), ("admit", 1), ("release", 1), ("admit", 3),
              ("release", 0), ("release", 0), ("release", 2), ("admit", 2),
              ("admit", 4), ("admit", 4), ("release", 3), ("admit", 0)]
    rows_of = {}
    for op, p in script:
        if op == "admit":
            r = jt.admit(jpps[p])
            assert tt.admit(tpps[p]) == r
            rows_of[p] = r
        else:
            jt.release(rows_of[p])
            tt.release(rows_of[p])
        assert (tt.admissions, tt.dedup_hits, tt.live_rows()) == \
            (jt.admissions, jt.dedup_hits, jt.live_rows())
        assert [tt.refs(r) for r in range(3)] == [jt.refs(r)
                                                  for r in range(3)]
        assert tt._free == jt._free
        _equal(jt.images, tt.images, f"table after {op} {p}")
    with pytest.raises(RuntimeError) as want:
        jt.admit(jpps[1])
    with pytest.raises(RuntimeError) as got:
        tt.admit(tpps[1])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="double-released"):
        FleetImageTable(1, device="cpu").release(0)


def test_pack_fleet_with_table_matches_jax(processes):
    """pack_fleet(table=) admits each process's image into the table and
    returns its images and rows; the fleet runs on them."""
    (jpps, regs), (tpps, _) = processes
    jt, tt = jruntime.FleetImageTable(6), FleetImageTable(6, device="cpu")
    jimgs, jids, js = jpack_fleet(jpps[:4], fuel=FUEL, regs=regs[:4],
                                  table=jt)
    timgs, tids, ts = pack_fleet(tpps[:4], fuel=FUEL, regs=regs[:4],
                                 table=tt, device="cpu")
    assert timgs is tt.images and tids.dtype == torch.int32
    assert np.array_equal(np.asarray(jids), tids.numpy())
    _equal(jimgs, timgs, "table images")
    _equal(js, ts, "states")
    out = run_fleet(timgs, ts, tids, chunk=8, device="cpu")
    imgs, ids, ref = pack_fleet(tpps[:4], fuel=FUEL, regs=regs[:4],
                                device="cpu")
    _equal(run_fleet(imgs, ref, ids, chunk=8, device="cpu"), out,
           "run on the table")
    with pytest.raises(ValueError, match="image table is on"):
        pack_fleet(tpps[:1], table=FleetImageTable(1, device="meta"),
                   device="cpu")


def test_set_image_row_matches_jax(processes):
    (jpps, _), (tpps, _) = processes
    jimgs = jfleet.pack_images(jfleet.stack_images([jpps[0].decoded] * 3))
    timgs = fleet.pack_images(fleet.stack_images([tpps[0].decoded] * 3))
    want = jfleet.set_image_row(jimgs, 1, jpps[3].decoded)
    packed = timgs.packed
    got = fleet.set_image_row(timgs, 1, tpps[3].decoded)
    assert got.packed is packed
    _equal(want, got, "set row")


# -- policy rows --------------------------------------------------------------

def test_update_policy_rows_matches_jax(scrambled):
    """Rows swapped for some lanes (padding and a negative lane among
    them); every other lane, and every other leaf, is untouched."""
    _, tleaves = scrambled
    B = tleaves["count"].shape[0]
    rng = np.random.default_rng(9)
    lanes = [2, B + 1, 5, -1]
    rules = SMOKE.random_policies(len(lanes), rng)
    rules[1] = None
    jrows = [None if r is None else jpolicy.compile_policy(_jrules(r))
             for r in rules]
    trows = [None if r is None else tpolicy.compile_policy(r)
             for r in rules]
    want = jfleet.update_policy_rows(_jax_tree(jfleet.TraceState, tleaves),
                                     lanes, jrows)
    tr = interop.trace_from_numpy(tleaves)
    got = fleet.update_policy_rows(tr, lanes, trows)
    assert got is tr
    _equal(want, got, "policy rows")
    moved = {2, 5, B - 1}
    for b in set(range(B)) - moved:
        for f in tr._fields:
            assert np.array_equal(getattr(tr, f)[b].numpy(), tleaves[f][b])
    want = jruntime.update_fleet_policy(
        _jax_tree(jfleet.TraceState, tleaves), [0, 3],
        [_jrules(rules[0]), None])
    got = update_fleet_policy(interop.trace_from_numpy(tleaves), [0, 3],
                              [rules[0], None])
    _equal(want, got, "update_fleet_policy")
    with pytest.raises(ValueError):
        update_fleet_policy(got, [0], [[tpolicy.PolicyRule(syscall_nr=-7)]])


def test_policy_swap_mid_run_leaves_bystanders_alone(processes):
    """A DENY rule swapped into one running lane between spans: that lane
    changes course, every other lane ends bit-identical to the run
    without the swap."""
    (_, regs), (tpps, _) = processes

    def run(swap):
        imgs, ids, s, tr = pack_fleet(tpps, fuel=FUEL, regs=regs,
                                      trace=True, device="cpu")
        run_fleet_span(imgs, s, ids, steps=16, chunk=8, trace=tr,
                       device="cpu")
        if swap:
            update_fleet_policy(tr, [2], [[tpolicy.deny(L.SYS_GETPID, 1)]])
        return run_fleet(imgs, s, ids, chunk=8, trace=tr, device="cpu")

    (s0, t0), (s1, t1) = run(False), run(True)
    assert int(t1.deny_count[2]) > 0 and int(t0.deny_count.sum()) == 0
    for b in range(len(tpps)):
        if b == 2:
            continue
        for x, y in zip((*s0, *t0), (*s1, *t1)):
            assert torch.equal(x[b], y[b]), b


# -- small helpers ------------------------------------------------------------

def test_finish_halt_codes_matches_jax():
    rng = np.random.default_rng(4)
    halted = rng.integers(0, 7, 64).astype(np.int64)
    icount = rng.integers(0, 100, 64).astype(np.int64)
    fuel = rng.integers(0, 100, 64).astype(np.int64)
    want = jfleet.finish_halt_codes(halted, icount, fuel)
    got = fleet.finish_halt_codes(halted, icount, fuel)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got == machine.HALT_FUEL).sum() > (halted == machine.HALT_FUEL
                                               ).sum()


def test_unpack_images_round_trip_matches_jax(processes):
    (jpps, _), (tpps, _) = processes
    timgs = fleet.pack_images([pp.decoded for pp in tpps[:5]])
    got = fleet.unpack_images(timgs)
    for f, x, y in zip(got._fields, got,
                       fleet.stack_images([pp.decoded for pp in tpps[:5]])):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    want = jfleet.unpack_images(
        jfleet.pack_images([pp.decoded for pp in jpps[:5]]))
    _equal(want, got, "unpack_images")
    timgs.imm.zero_()
    assert got.imm.any()  # a copy of its own


# -- the scalar machine API ---------------------------------------------------

def _exit_with_x0(a):
    a.emit(isa.movz(8, L.SYS_EXIT, sf=0))
    a.emit(isa.svc(0))
    return a


def _program(body):
    a = Asm(APP_BASE)
    a.label("main")
    body(a)
    im = Image()
    im.add_asm("app", a, rewrite=True)
    return im


def _mov48(a):
    a.emit(*isa.mov_imm48(0, 0x1234_5678_9ABC))
    _exit_with_x0(a)


def _movk(a):
    a.emit(isa.movn(0, 0), isa.movk(0, 0xBEEF, 1), isa.movz(0, 7, sf=0))
    _exit_with_x0(a)


def _alu(a):
    a.emit(*isa.mov_imm48(1, 0x7FFF_1234_5678), *isa.mov_imm48(2, 99))
    a.emit(isa.sub_r(2, isa.XZR, 2), isa.add_r(3, 1, 2), isa.sub_r(4, 1, 2),
           isa.eor_r(5, 1, 2), isa.madd(6, 1, 2), isa.movz(0, 0))
    _exit_with_x0(a)


def _conditions(a):
    a.emit(isa.movz(1, 4), isa.movz(2, 5), isa.cmp_r(1, 2))
    a.b_to("yes", cond="cc")
    a.emit(isa.movz(0, 0))
    _exit_with_x0(a)
    a.label("yes")
    a.emit(isa.movz(0, 1))
    _exit_with_x0(a)


def _stack(a):
    a.emit(isa.movz(1, 111), isa.movz(2, 222),
           isa.stp_pre(1, 2, isa.SP, -16), isa.movz(1, 0), isa.movz(2, 0),
           isa.ldp_post(3, 4, isa.SP, 16), isa.add_r(0, 3, 4),
           isa.str_pre(3, isa.SP, -16), isa.ldr_post(5, isa.SP, 16))
    _exit_with_x0(a)


def _bytes(a):
    a.emit(*isa.mov_imm48(1, L.HEAP_BASE), isa.movz(2, 0xAB),
           isa.strb(2, 1, 3), isa.ldrb(0, 1, 3))
    _exit_with_x0(a)


def _unaligned(a):
    a.emit(*isa.mov_imm48(1, L.HEAP_BASE + 4), isa.ldr_imm(0, 1, 0))
    _exit_with_x0(a)


def _null_store(a):
    a.emit(isa.movz(1, 0), isa.str_imm(0, 1, 0))
    _exit_with_x0(a)


def _null_jump(a):
    a.emit(isa.movz(9, 172), isa.br(9))


def _read_write(a):
    for nr in (L.SYS_READ, L.SYS_WRITE):
        a.emit(isa.movz(0, 3 if nr == L.SYS_READ else 1),
               *isa.mov_imm48(1, L.HEAP_BASE), isa.movz(2, 64),
               isa.movz(8, nr, sf=0), isa.svc(0))
    a.emit(isa.movz(0, 0))
    _exit_with_x0(a)


def _enosys(a):
    a.emit(isa.movz(8, 555, sf=0), isa.svc(0), isa.mov_r(0, 0))
    _exit_with_x0(a)


def _brk(a):
    a.emit(isa.brk(0))


def _spin(a):
    a.label("spin")
    a.b_to("spin")


PROGRAMS = [_mov48, _movk, _alu, _conditions, _stack, _bytes, _unaligned,
            _null_store, _null_jump, _read_write, _enosys, _brk, _spin]


@pytest.fixture(scope="module")
def jstep():
    return jax.jit(jmachine.step)


@pytest.mark.parametrize("body", PROGRAMS, ids=lambda f: f.__name__[1:])
def test_scalar_step_matches_jax(body, jstep):
    """The cases of tests/test_core_machine.py stepped one instruction at
    a time in both packages, every leaf after every step; the steps go on
    past the halt (and past the fuel, which is 6 for the spin), since
    ``step`` is unconditional; the input state is left intact."""
    im = _program(body)
    img = machine.decode_image(im.words)
    jimg = jmachine.DecodedImage(*(jnp.asarray(t.numpy()) for t in img))
    fuel = 6 if body is _spin else 100_000
    s = machine.make_state(im.sym("app:main"), fuel=fuel)
    js = jmachine.make_state(im.sym("app:main"), fuel=fuel)
    halted_at = None
    for k in range(40):
        before = [x.clone() for x in s]
        s_next = machine.step(img, s)
        assert all(torch.equal(x, y) for x, y in zip(before, s))
        s, js = s_next, jstep(jimg, js)
        _equal(js, s, f"{body.__name__} step {k}")
        if halted_at is None and (int(s.halted) or int(s.icount) >= fuel):
            halted_at = k
        if halted_at is not None and k >= halted_at + 2:
            break
    assert halted_at is not None


def test_mem_helpers_match_jax(jstep):
    """mem_read / mem_read_block / mem_write on a state after the read
    syscall: the same words as the JAX package's; mem_write returns a new
    state and leaves its input intact; bad addresses raise."""
    im = _program(_read_write)
    img = machine.decode_image(im.words)
    jimg = jmachine.DecodedImage(*(jnp.asarray(t.numpy()) for t in img))
    s = machine.make_state(im.sym("app:main"))
    js = jmachine.make_state(im.sym("app:main"))
    for _ in range(12):
        s, js = machine.step(img, s), jstep(jimg, js)
    _equal(js, s, "after read")
    base = L.HEAP_BASE
    for addr in (base, base + 8, base + 56, base + 64, L.DATA_BASE):
        assert machine.mem_read(s, addr) == jmachine.mem_read(js, addr)
    block = machine.mem_read_block(s, base, 9)
    assert np.array_equal(block, jmachine.mem_read_block(js, base, 9))
    block[:] = 0
    assert machine.mem_read(s, base + 8) == 8  # the block was a copy
    mem = s.mem.clone()
    s2 = machine.mem_write(s, base + 16, -(1 << 62))
    js2 = jmachine.mem_write(js, base + 16, -(1 << 62))
    assert torch.equal(s.mem, mem)
    _equal(js2, s2, "mem_write")
    assert machine.mem_read(s2, base + 16) == -(1 << 62)
    for bad in (base + 4, L.DATA_BASE - 8, L.MEM_LIMIT):
        with pytest.raises(ValueError):
            machine.mem_read(s, bad)
        with pytest.raises(ValueError):
            machine.mem_write(s, bad, 1)
    with pytest.raises(ValueError):
        machine.mem_read_block(s, L.MEM_LIMIT - 8, 2)


@pytest.mark.parametrize("traced", [False, True])
def test_admission_driver_matches_fixed_width(processes, traced):
    """chip_smoke.py's continuous-batching loop (a 3-lane pool, a 4-row
    image table, preemption every second span, checkpoints restored) at a
    small size on the CPU: every harvested lane equals the fixed-width
    run's, traced or not."""
    (_, regs), (tpps, _) = processes
    out_s, out_t, stats = SMOKE.admission_run(
        tpps, regs, pool=3, table_rows=4, steps=16, chunk=8,
        dev=torch.device("cpu"), traced=traced, preempt_every=2,
        preempt_n=1)
    want = run_fleet_prepared(tpps, fuel=SMOKE.FUEL, chunk=8, regs=regs,
                              trace=traced, device="cpu")
    for w, g in zip(want, (out_s, out_t)) if traced else [(want, out_s)]:
        _equal(w, g, "admission driver")
    assert stats["preempted"] > 0 and stats["restored"] == stats["preempted"]
    assert stats["admitted"] == len(tpps) and stats["dedup_hits"] > 0
    assert stats["rings_checked_empty"] == (len(tpps) if traced else 0)
