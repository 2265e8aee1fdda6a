"""The port's guest-kernel emulation against the JAX package, on the CPU.

The subsystem under test is :mod:`repro_torch.emul` and the executor that
calls it: per-lane fd tables, an in-memory filesystem, pipes, /proc,
getrandom and ioctl.  The same inputs, made with numpy from a seed, go
through both packages; the tolerance is exact (int64/int32/bool), on every
field of ``EmulEffects`` and every one of the 34 ``MachineState`` leaves.
"""
import importlib.util
import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.image as jimage
import repro.core.isa as jisa
import repro.core.layout as jL
from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_fleet_prepared as jrun_fleet_prepared
from repro.core.machine import MachineState as JMachineState
from repro.emul import engine as jengine
from repro.emul import state as jstate
from repro.kernels.megastep import ops as jmops

import repro_torch.core.image as timage
import repro_torch.core.isa as tisa
import repro_torch.core.layout as tL
from repro_torch.core import (HookConfig, Mechanism, fleet, interop,
                              pack_fleet, prepare, programs,
                              run_fleet_prepared)
from repro_torch.core.machine import MachineState
from repro_torch.emul import engine
from repro_torch.emul import state as tstate

ROOT = Path(__file__).resolve().parents[1]
FUEL = 300_000
FUZZ_STEPS = 16

# What the JAX package gives for the full 500-lane census at the default
# HookConfig (run_fleet_prepared, chunk 128, fuel 10M), untraced and traced
# (cap 64, all-ALLOW): counts and the sha256 of every leaf's int64 bytes in
# field order.  Those runs take minutes on the CPU, so tier-1 pins the
# numbers here and chip_smoke.py asserts them for the port on the card;
# scripts/torch_port_pins.py --check re-derives them from the JAX package.
CENSUS_DEFAULT_JAX = {"lanes": 500, "total_steps": 3_603_972,
                      "longest_lane_steps": 8_306, "enosys_total": 0,
                      "emul_served_total": 198_696}
CENSUS_DEFAULT_SHA256 = (
    "bf093bebe619e2036172469be1f2764435d3ca56cb2e1eeed607dd558a9c743a")
TRACED_JAX = {"records_total": 263_036, "deny": 0, "emul": 0, "kill": 0}
TRACED_SHA256 = (
    "f1897933d161359b5aa5aec31df4ff583e529837bfdceb76a9d78997b159a51b")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_emul", ROOT / "chip_smoke.py")

JAX = types.SimpleNamespace(isa=jisa, programs=jprograms, L=jL, st=jstate,
                            APP_BASE=jimage.APP_BASE, Asm=jisa.Asm,
                            prepare=jprepare, Mechanism=JMechanism,
                            HookConfig=JHookConfig)
TORCH = types.SimpleNamespace(isa=tisa, programs=programs, L=tL, st=tstate,
                              APP_BASE=timage.APP_BASE, Asm=tisa.Asm,
                              prepare=prepare, Mechanism=Mechanism,
                              HookConfig=HookConfig)


def _jstate(leaves):
    return JMachineState(*(jnp.asarray(leaves[f])
                           for f in JMachineState._fields))


def _assert_leaves_equal(want: dict, got: MachineState, what):
    for f in MachineState._fields:
        a, b = want[f], getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        if not np.array_equal(a, b):
            lanes = np.unique(np.argwhere(a != b)[:, 0]).tolist()
            raise AssertionError(f"{what}: leaf {f!r} differs in lanes "
                                 f"{lanes[:10]}")


# -- the census cells at the default config -----------------------------------

def _cells(P, copies=4):
    """``copies`` lanes per census image and per emulation probe, default
    HookConfig; x19 = 2 or 3."""
    w = {"getpid": lambda: P.programs.getpid_loop_param(),
         "read": lambda: P.programs.read_loop_param(1024),
         "mixed": lambda: P.programs.mixed_ops_param(512),
         "io_bw": lambda: P.programs.io_bandwidth_param(4096),
         "churn": lambda: P.programs.file_churn_param(512),
         "proc": lambda: P.programs.proc_probe_param(),
         "badfd": lambda: P.programs.bad_fd_probe()}
    pps, regs = [], []
    for i, (_, mech, virt) in enumerate(SMOKE.MECHS):
        for j, build in enumerate(w.values()):
            pp = P.prepare(build(), P.Mechanism[mech.name], virtualize=virt)
            pps += [pp] * copies
            regs += [{19: 2 + (i + j) % 2}] * copies
    return pps, regs


@pytest.fixture(scope="module")
def packed():
    jpps, regs = _cells(JAX)
    tpps, _ = _cells(TORCH)
    jimgs, jids, js = jpack_fleet(jpps, fuel=FUEL, regs=regs)
    timgs, tids, _ = pack_fleet(tpps, fuel=FUEL, regs=regs, device="cpu")
    leaves = {f: np.asarray(getattr(js, f)) for f in JMachineState._fields}
    return dict(jimgs=jimgs, jids=jnp.asarray(jids), leaves=leaves,
                timgs=timgs, tids=tids, tpps=tpps, regs=regs)


def _fuzz_leaves(packed, seed):
    rng = np.random.default_rng(seed)
    code = SMOKE.code_of(packed["tpps"])
    return SMOKE.scramble_kern(SMOKE.scramble(packed["leaves"], code, rng),
                               code, rng)


# -- (a) the engine functions, field by field ---------------------------------

_FAMS = ("none", "open", "close", "lseek", "dup", "fstat", "pipe", "rand",
         "ioctl", "read", "write")


def _service_inputs(leaves, seed):
    """Seeded registers, path words and one syscall family per lane."""
    rng = np.random.default_rng(seed)
    B = leaves["pc"].shape[0]
    fam = rng.integers(0, len(_FAMS), B)
    en = leaves["k_enabled"] != 0
    x0 = np.where(rng.random(B) < 0.6, rng.integers(-2, 19, B),
                  jL.HEAP_BASE + 8 * rng.integers(-8, 5000, B))
    x1 = np.select([rng.random(B) < 0.4, rng.random(B) < 0.5],
                   [jL.HEAP_BASE + 8 * rng.integers(-4, 4000, B),
                    rng.integers(-20, 5000, B)],
                   rng.choice([0, 1, 2, 3, 8, 4096, 4104, 2**62], B))
    x2 = rng.choice([0, 1, 2, 3, 8, 64, 512, 4096, 4160, -8, 12,
                     jL.O_CREAT, jL.O_CREAT | jL.O_EXCL, jL.O_TRUNC,
                     jL.O_APPEND], B)
    path_w = rng.choice(SMOKE._NAMES, B)
    io_n = x2
    io_ok = ((x1 >= jL.DATA_BASE) & (x1 < jL.MEM_LIMIT) & ((x1 & 7) == 0)
             & (x1 + io_n <= jL.MEM_LIMIT) & (io_n >= 0) & ((io_n & 7) == 0))
    masks = {f"sys_{n}": (fam == i) & (en if n not in ("read", "write")
                                       else True)
             for i, n in enumerate(_FAMS) if n != "none"}
    return dict(en=en, x0=x0.astype(np.int64), x1=x1.astype(np.int64),
                x2=x2.astype(np.int64), path_w=path_w, io_ok=io_ok,
                io_n=io_n.astype(np.int64), **masks)


def _eff_equal(want, got, what):
    for f in engine.EmulEffects._fields:
        if f == "kern":
            for k in tstate.KernelState._fields:
                a = np.asarray(getattr(want.kern, k))
                b = getattr(got.kern, k).numpy()
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (what, "kern", k)
            continue
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_matches_jax(packed, seed):
    """service / neutral / proc_rows / run_data_loop / splitmix64 on seeded
    random tables, registers and masks: every field equal."""
    leaves = _fuzz_leaves(packed, 100 + seed)
    leaves["icount"] = np.random.default_rng(seed).integers(0, 10**6,
                                                            len(leaves["pc"]))
    js, ts = _jstate(leaves), interop.state_from_numpy(leaves)
    inp = _service_inputs(leaves, seed)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    keys = [k for k in inp if k.startswith("sys_")]
    assert sum(int(inp[k].sum()) for k in keys) > len(leaves["pc"]) // 2

    want = jengine.service(js, **jin)
    got = engine.service(ts, **tin)
    _eff_equal(want, got, f"service seed {seed}")
    want_n = jengine.neutral(js, jin["sys_read"], jin["sys_write"])
    got_n = engine.neutral(ts, tin["sys_read"], tin["sys_write"])
    _eff_equal(want_n, got_n, f"neutral seed {seed}")
    proc_w = np.asarray(jengine.proc_rows(js))
    assert np.array_equal(proc_w, engine.proc_rows(ts).numpy())

    mem, ino = leaves["mem"].reshape(-1), leaves["k_ino_data"].reshape(-1)
    jm, ji = jengine.run_data_loop(jnp.asarray(mem), jnp.asarray(ino),
                                   jnp.asarray(proc_w.reshape(-1)), want)
    tm, ti = torch.from_numpy(mem.copy()), torch.from_numpy(ino.copy())
    engine.run_data_loop(tm, ti, torch.from_numpy(proc_w.reshape(-1).copy()),
                         got)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert int(np.asarray(want.fio_do).sum()) > 0  # words really moved

    x = np.random.default_rng(seed).integers(-2**63, 2**63 - 1, 4096,
                                             dtype=np.int64, endpoint=True)
    x[:4] = [0, -1, 2**63 - 1, -2**63]
    assert np.array_equal(np.asarray(jengine.splitmix64(jnp.asarray(x))),
                          engine.splitmix64(torch.from_numpy(x)).numpy())


def test_free_slot_scans_on_full_tables(packed):
    """argmax of an all-false row is 0: a full fd / OFD / inode table makes
    the lowest-free-slot scans return 0, as in the JAX package."""
    leaves = dict(packed["leaves"])
    B = leaves["pc"].shape[0]
    leaves["k_fd_ofd"] = np.full((B, tL.MAX_FDS), 3, np.int64)
    leaves["k_ofd_kind"] = np.full((B, tL.MAX_FDS), tstate.FD_FILE, np.int64)
    leaves["k_ino_kind"] = np.full((B, tL.MAX_INODES), tstate.INO_FILE,
                                   np.int64)
    inp = _service_inputs(leaves, 7)
    for n in _FAMS[1:]:
        inp[f"sys_{n}"] = np.zeros(B, bool)
    inp["sys_pipe"][::2] = True
    inp["sys_dup"][1::2] = True
    want = jengine.service(_jstate(leaves),
                           **{k: jnp.asarray(v) for k, v in inp.items()})
    got = engine.service(interop.state_from_numpy(leaves),
                         **{k: torch.from_numpy(np.asarray(v))
                            for k, v in inp.items()})
    _eff_equal(want, got, "full tables")
    assert (got.ret.numpy()[::2] < 0).all()  # -EINVAL/-EFAULT/-EMFILE
    assert (got.ret.numpy()[1::2] < 0).all()  # -EBADF/-EMFILE


# -- (b) per-step fuzz with emulation on --------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_step_fuzz_emul_on_matches_jax(packed, seed):
    """Scrambled registers, memory and guest-kernel tables through
    FUZZ_STEPS steps of ``_step_core`` in both packages: all 34 leaves."""
    leaves = _fuzz_leaves(packed, seed)
    want = jmops.megastep(packed["jimgs"], packed["jids"], _jstate(leaves),
                          chunk=FUZZ_STEPS, impl="ref")
    want = {f: np.asarray(getattr(want, f)) for f in JMachineState._fields}
    s = interop.state_from_numpy(leaves)
    for _ in range(FUZZ_STEPS):
        s, _ = fleet._step_core(packed["timgs"], packed["tids"], s)
    _assert_leaves_equal(want, s, f"emul fuzz seed {seed}")
    # the fuzz reaches the guest kernel, not just faults
    assert (want["emul_served"] > leaves["emul_served"]).sum() >= 5
    for f in ("k_fd_ofd", "k_ofd_kind", "k_ofd_off", "k_ofd_ref", "k_rng"):
        assert not np.array_equal(want[f], leaves[f]), f


def test_no_lane_writes_another_lanes_rows(packed):
    """On scrambled states every lane's steps depend on its own rows only:
    the batched plain step equals each lane run alone (width 1), so no
    lane's step changes another lane's mem or k_ino_data row — what makes
    the one-thread-per-lane kernel exact."""
    leaves = _fuzz_leaves(packed, 9)
    s = interop.state_from_numpy(leaves)
    for _ in range(6):
        s, _ = fleet._step_core(packed["timgs"], packed["tids"], s)
    B = leaves["pc"].shape[0]
    for b in range(B):
        one = MachineState(*(torch.from_numpy(leaves[f][b:b + 1].copy())
                             for f in MachineState._fields))
        for _ in range(6):
            one, _ = fleet._step_core(packed["timgs"],
                                      packed["tids"][b:b + 1], one)
        for f in MachineState._fields:
            assert torch.equal(getattr(one, f)[0], getattr(s, f)[b]), (b, f)


# -- (c) the emulation scenarios, to halt, through both packages --------------

def _store(P, a, reg, slot):
    a.emit(P.isa.movz(10, P.L.SCRATCH & 0xFFFF),
           P.isa.movk(10, P.L.SCRATCH >> 16, 1))
    a.emit(P.isa.str_imm(reg, 10, 8 * slot))


def _openat(P, a, flags, path_reg=24):
    a.emit(P.isa.movz(0, 0))
    a.emit(P.isa.mov_r(1, path_reg))
    a.emit(*P.isa.mov_imm48(2, flags))
    P.programs._raw(a, P.L.SYS_OPENAT)


def _rw(P, a, nr, fd_reg, buf, nbytes):
    a.emit(P.isa.mov_r(0, fd_reg))
    a.emit(*P.isa.mov_imm48(1, buf))
    a.emit(*P.isa.mov_imm48(2, nbytes))
    P.programs._raw(a, nr)


def _syscall3(P, a, nr, x0, x1, x2):
    a.emit(*P.isa.mov_imm48(0, x0))
    a.emit(*P.isa.mov_imm48(1, x1))
    a.emit(*P.isa.mov_imm48(2, x2))
    P.programs._raw(a, nr)


def _sc_offsets(P, a):
    heap, path = P.L.HEAP_BASE, P.L.HEAP_BASE + 2048
    a.emit(*P.isa.mov_imm48(24, path))
    P.programs._store_path(a, 24, 25, b"file.dat")
    for i, w in enumerate((0x1111, 0x2222, 0x3333)):
        a.emit(*P.isa.mov_imm48(25, w))
        a.emit(*P.isa.mov_imm48(10, heap + 8 * i))
        a.emit(P.isa.str_imm(25, 10))
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(23, 0))
    _rw(P, a, P.L.SYS_WRITE, 23, heap, 16)
    _store(P, a, 0, 0)
    _rw(P, a, P.L.SYS_WRITE, 23, heap + 16, 8)
    a.emit(P.isa.mov_r(0, 23))
    a.emit(P.isa.movz(1, 0))
    a.emit(P.isa.movz(2, P.L.SEEK_END))
    P.programs._raw(a, P.L.SYS_LSEEK)
    _store(P, a, 0, 1)
    a.emit(P.isa.mov_r(0, 23))
    a.emit(P.isa.movz(1, 8))
    a.emit(P.isa.movz(2, P.L.SEEK_SET))
    P.programs._raw(a, P.L.SYS_LSEEK)
    _rw(P, a, P.L.SYS_READ, 23, heap + 1024, 16)
    _store(P, a, 0, 2)


def _sc_dup(P, a):
    heap = P.L.HEAP_BASE
    a.emit(*P.isa.mov_imm48(24, heap + 2048))
    P.programs._store_path(a, 24, 25, b"shared")
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(23, 0))
    _rw(P, a, P.L.SYS_WRITE, 23, heap, 16)
    a.emit(P.isa.mov_r(0, 23))
    P.programs._raw(a, P.L.SYS_DUP)
    a.emit(P.isa.mov_r(26, 0))
    _rw(P, a, P.L.SYS_READ, 26, heap + 1024, 16)
    _store(P, a, 0, 0)
    a.emit(P.isa.mov_r(0, 23))
    a.emit(P.isa.movz(1, 0))
    a.emit(P.isa.movz(2, P.L.SEEK_SET))
    P.programs._raw(a, P.L.SYS_LSEEK)
    a.emit(P.isa.mov_r(0, 23))
    P.programs._raw(a, P.L.SYS_CLOSE)
    _rw(P, a, P.L.SYS_READ, 26, heap + 1024, 16)
    _store(P, a, 0, 1)


def _sc_emfile(P, a):
    a.emit(*P.isa.mov_imm48(24, P.L.HEAP_BASE + 2048))
    P.programs._store_path(a, 24, 25, b"one.file")
    a.label("loop")
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(20, 0))
    a.emit(P.isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    _store(P, a, 20, 0)


def _sc_enospc(P, a):
    a.emit(*P.isa.mov_imm48(24, P.L.HEAP_BASE + 2048))
    for i in range(P.L.MAX_INODES + 1):
        P.programs._store_path(a, 24, 25, b"f%d" % i)
        _openat(P, a, P.L.O_CREAT)
        a.emit(P.isa.mov_r(20, 0))
    _store(P, a, 20, 0)


def _sc_flags(P, a):
    heap = P.L.HEAP_BASE
    a.emit(*P.isa.mov_imm48(24, heap + 2048))
    P.programs._store_path(a, 24, 25, b"app.file")
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(23, 0))
    _rw(P, a, P.L.SYS_WRITE, 23, heap, 16)
    a.emit(P.isa.mov_r(0, 23))
    P.programs._raw(a, P.L.SYS_CLOSE)
    _openat(P, a, P.L.O_CREAT | P.L.O_EXCL)
    _store(P, a, 0, 0)
    _openat(P, a, P.L.O_APPEND)
    a.emit(P.isa.mov_r(23, 0))
    _rw(P, a, P.L.SYS_WRITE, 23, heap, 8)
    a.emit(P.isa.mov_r(0, 23))
    a.emit(*P.isa.mov_imm48(1, heap + 1024))
    P.programs._raw(a, P.L.SYS_FSTAT)
    _openat(P, a, P.L.O_TRUNC)
    a.emit(P.isa.mov_r(0, 0))
    a.emit(*P.isa.mov_imm48(1, heap + 1280))
    P.programs._raw(a, P.L.SYS_FSTAT)


def _sc_pipe(P, a):
    heap = P.L.HEAP_BASE
    a.emit(*P.isa.mov_imm48(25, 0xBEEF))
    a.emit(*P.isa.mov_imm48(10, heap))
    a.emit(P.isa.str_imm(25, 10))
    a.emit(*P.isa.mov_imm48(0, heap + 1024))
    a.emit(P.isa.movz(1, 0))
    P.programs._raw(a, P.L.SYS_PIPE2)
    a.emit(*P.isa.mov_imm48(10, heap + 1024))
    a.emit(P.isa.ldr_imm(27, 10))
    a.emit(P.isa.ldr_imm(28, 10, 8))
    _rw(P, a, P.L.SYS_WRITE, 28, heap, 8)
    _rw(P, a, P.L.SYS_READ, 27, heap + 3072, 8)
    _rw(P, a, P.L.SYS_WRITE, 28, heap, P.L.FILE_BYTES - 8)
    _store(P, a, 0, 0)
    _rw(P, a, P.L.SYS_WRITE, 28, heap, 16)
    _store(P, a, 0, 1)


def _sc_random(P, a):
    heap = P.L.HEAP_BASE
    _syscall3(P, a, P.L.SYS_GETRANDOM, heap, 64, 0)
    _syscall3(P, a, P.L.SYS_GETRANDOM, heap + 1024, 64, 0)
    _syscall3(P, a, P.L.SYS_GETRANDOM, heap, P.L.FILE_BYTES + 64, 0)
    _store(P, a, 0, 0)
    _syscall3(P, a, P.L.SYS_GETRANDOM, heap, 7, 0)
    _store(P, a, 0, 1)


def _sc_ioctl(P, a):
    a.emit(*P.isa.mov_imm48(24, P.L.HEAP_BASE + 2048))
    a.emit(*P.programs._mov_imm64(25, P.st.DEV_KEY))
    a.emit(P.isa.str_imm(25, 24))
    _openat(P, a, 0)
    a.emit(P.isa.mov_r(23, 0))
    for req in (P.st.ASC_IOCTL_PID, P.st.ASC_IOCTL_ICOUNT, 0x7777):
        a.emit(P.isa.mov_r(0, 23))
        a.emit(*P.isa.mov_imm48(1, req))
        P.programs._raw(a, P.L.SYS_IOCTL)
        _store(P, a, 0, req & 3)
    P.programs._store_path(a, 24, 25, b"reg.file")
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(0, 0))
    a.emit(*P.isa.mov_imm48(1, P.st.ASC_IOCTL_PID))
    P.programs._raw(a, P.L.SYS_IOCTL)


WRAP_MARK = 0x5A5A5A  # the last word of the escaping write's buffer
WRAP_OFF = 2**63 - 256


def _sc_wrapped_offset(P, a):
    """lseek to just below INT64_MAX, then one 32 KiB write: the write's
    end wraps negative and passes the EFBIG check (a fault of the
    reference, kept bit for bit; see
    test_wrapped_offset_write_lands_in_next_lane)."""
    heap, nbytes = P.L.HEAP_BASE, P.L.MAX_INODES * P.L.FILE_BYTES
    a.emit(*P.isa.mov_imm48(24, heap + 2 * nbytes))  # path past the buffer
    P.programs._store_path(a, 24, 25, b"wrap.dat")
    a.emit(*P.isa.mov_imm48(25, WRAP_MARK))
    a.emit(*P.isa.mov_imm48(10, heap + nbytes - 8))
    a.emit(P.isa.str_imm(25, 10))
    _openat(P, a, P.L.O_CREAT)
    a.emit(P.isa.mov_r(23, 0))
    a.emit(*P.programs._mov_imm64(1, WRAP_OFF))
    a.emit(P.isa.movz(2, P.L.SEEK_SET))
    P.programs._raw(a, P.L.SYS_LSEEK)
    _store(P, a, 0, 0)
    _rw(P, a, P.L.SYS_WRITE, 23, heap, nbytes)
    _store(P, a, 0, 1)


def _sc_legacy_lseek(P, a):
    a.emit(P.isa.movz(0, 5))
    a.emit(P.isa.movz(1, 0))
    a.emit(P.isa.movz(2, P.L.SEEK_SET))
    P.programs._raw(a, P.L.SYS_LSEEK)
    _store(P, a, 0, 0)


def _asm(P, body):
    a = P.Asm(P.APP_BASE)
    a.label("main")
    body(P, a)
    P.programs._exit0(a)
    return a


# name -> (builder(P) -> Asm, mechanism, emulation on, x19)
SCENARIOS = {
    "churn_readback": (lambda P: P.programs.file_churn_param(256), "ASC",
                       True, 3),
    "lseek_offsets": (lambda P: _asm(P, _sc_offsets), "ASC", True, 0),
    "dup_shared_ofd": (lambda P: _asm(P, _sc_dup), "ASC", True, 0),
    "emfile": (lambda P: _asm(P, _sc_emfile), "ASC", True,
               tL.MAX_FDS - tstate.N_PREOPEN + 1),
    "enospc": (lambda P: _asm(P, _sc_enospc), "ASC", True, 0),
    "excl_trunc_append": (lambda P: _asm(P, _sc_flags), "ASC", True, 0),
    "pipe_eagain": (lambda P: _asm(P, _sc_pipe), "SIGNAL", True, 0),
    # the lane after it must not touch a file (see the test below)
    "wrapped_offset": (lambda P: _asm(P, _sc_wrapped_offset), "ASC", True,
                       0),
    "getrandom": (lambda P: _asm(P, _sc_random), "ASC", True, 0),
    "ioctl": (lambda P: _asm(P, _sc_ioctl), "PTRACE", True, 0),
    "ebadf_enoent": (lambda P: P.programs.bad_fd_probe(), "ASC", True, 0),
    "proc_pid_asc": (lambda P: P.programs.proc_probe_param(), "ASC", True, 2),
    "proc_pid_ptrace": (lambda P: P.programs.proc_probe_param(), "PTRACE",
                        True, 2),
    "stub_badfd": (lambda P: P.programs.bad_fd_probe(), "ASC", False, 0),
    "stub_lseek": (lambda P: _asm(P, _sc_legacy_lseek), "ASC", False, 0),
}


def _scenario_fleet(P):
    pps, regs = [], []
    for build, mech, emul, n in SCENARIOS.values():
        pps.append(P.prepare(build(P), P.Mechanism[mech], virtualize=True,
                             cfg=P.HookConfig(emul_enabled=emul)))
        regs.append({19: n})
    return pps, regs


@pytest.fixture(scope="module")
def scenario_runs():
    jpps, regs = _scenario_fleet(JAX)
    tpps, _ = _scenario_fleet(TORCH)
    want = jrun_fleet_prepared(jpps, fuel=FUEL, chunk=32, regs=regs)
    got = run_fleet_prepared(tpps, fuel=FUEL, chunk=32, regs=regs,
                             device="cpu")
    want = {f: np.asarray(getattr(want, f)) for f in JMachineState._fields}
    return want, got


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_emulation_scenario_matches_jax(scenario_runs, name):
    """Each of the JAX package's emulation scenarios (tests/test_emul.py),
    run to halt through both packages' run_fleet_prepared: every leaf."""
    want, got = scenario_runs
    lane = list(SCENARIOS).index(name)
    for f in MachineState._fields:
        assert np.array_equal(want[f][lane], getattr(got, f)[lane].numpy()), f
    assert int(got.halted[lane]) == 1 and int(got.exit_code[lane]) == 0
    emul = SCENARIOS[name][2]
    assert (int(got.emul_served[lane]) > 0) == emul


def test_wrapped_offset_write_lands_in_next_lane(scenario_runs):
    """A fault of the reference that the port keeps bit for bit: lseek
    (SEEK_SET) accepts any offset >= 0, so after lseek(fd, 2**63 - 256)
    a 32 KiB write's end wraps negative, passes the EFBIG check, and the
    data mover (indices clipped into the whole flat plane) writes 4,096
    words from the file's last word on, into the NEXT lane's k_ino_data
    row.  Both packages do it alike: the getrandom lane that follows
    never opens a file, yet its row holds the escaping buffer's last word.
    Such a state is outside the CUDA kernel's exact domain: there each
    lane is one unsynchronised thread, so a move into another lane's rows
    races with that lane's own steps (the card tests and chip_smoke.py's
    scrambles keep file offsets in [0, FILE_BYTES + 64])."""
    want, got = scenario_runs
    names = list(SCENARIOS)
    lane = names.index("wrapped_offset")
    assert names[lane + 1] == "getrandom"
    scratch = (tL.SCRATCH - tL.DATA_BASE) // 8
    nbytes = tL.MAX_INODES * tL.FILE_BYTES
    for what, mem, ino, off in (
            ("jax", want["mem"], want["k_ino_data"], want["k_ofd_off"]),
            ("torch", got.mem.numpy(), got.k_ino_data.numpy(),
             got.k_ofd_off.numpy())):
        # lseek returned the offset, the write reported every byte
        assert mem[lane, scratch:scratch + 2].tolist() == [WRAP_OFF,
                                                           nbytes], what
        assert (off[lane] < 0).any(), what  # the stored offset wrapped
        assert (ino[lane + 1] == WRAP_MARK).sum() == 1, what
    assert np.array_equal(want["k_ino_data"], got.k_ino_data.numpy())


# -- (f) the census cells at the default config, to halt ----------------------

def test_census_cells_default_config_match_jax():
    """Every tenth lane of the 500-lane census (all 25 cells) at the
    default HookConfig, run to halt in both packages.  The census's own
    iteration counts are divided by 20 to fit the CPU budget; the full
    census is held to the JAX package's digest on the card
    (chip_smoke.py)."""
    grid = SMOKE.census_grid()[::10]
    regs = [{19: max(2, g[4] // 20)} for g in grid]
    jw = {"getpid": jprograms.getpid_loop_param,
          "read": lambda: jprograms.read_loop_param(1024),
          "mixed": lambda: jprograms.mixed_ops_param(512),
          "io_bw": lambda: jprograms.io_bandwidth_param(4096),
          "churn": lambda: jprograms.file_churn_param(512)}
    jcells = {(m, w): jprepare(jw[w](), JMechanism(mech.value),
                               virtualize=virt)
              for m, mech, virt in SMOKE.MECHS for w in jw}
    tpps, _ = SMOKE.census_processes()
    tpps = tpps[::10]
    want = jrun_fleet_prepared([jcells[(g[0], g[3])] for g in grid],
                               fuel=SMOKE.FUEL, chunk=128, regs=regs)
    got = run_fleet_prepared(tpps, fuel=SMOKE.FUEL, chunk=128, regs=regs,
                             device="cpu")
    _assert_leaves_equal({f: np.asarray(getattr(want, f))
                          for f in JMachineState._fields}, got, "census")
    assert (got.halted.numpy() == 1).all()
    assert int(got.enosys_count.sum()) == 0
    assert int(got.emul_served.sum()) > 0


# -- the pinned counts chip_smoke.py holds the card to ------------------------

def test_chip_smoke_pins_match_jax_records():
    """chip_smoke.py holds the card to the JAX package's default-census and
    traced-census results (re-derived by scripts/torch_port_pins.py), and
    to the churn counts of benchmarks/results/BENCH_emul.json."""
    assert SMOKE.CENSUS_DEFAULT_EXPECTED == CENSUS_DEFAULT_JAX
    assert SMOKE.CENSUS_DEFAULT_SHA256 == CENSUS_DEFAULT_SHA256
    assert SMOKE.TRACED_EXPECTED == TRACED_JAX
    assert SMOKE.TRACED_SHA256 == TRACED_SHA256
    rec = json.loads((ROOT / "benchmarks" / "results" /
                      "BENCH_emul.json").read_text())
    for arm in ("emul", "stub"):
        want = SMOKE.CHURN_EXPECTED[arm]
        assert want["total_steps"] == rec[arm]["total_steps"]
        assert want["emul_served_total"] == rec[arm]["emul_served"]
        assert want["enosys_total"] == rec[arm]["enosys_fallthroughs"]
        assert want["lanes"] == rec["config"]["lanes"]
    assert len(SMOKE.churn_grid()) == rec["config"]["lanes"]
    assert SMOKE.CHURN_NBYTES == rec["config"]["churn_nbytes"]


def test_census_bound_counts_moved_bytes_only(packed):
    """chip_smoke.py's bound charges mem and k_ino_data only for the bytes
    the work moves (stream I/O and the data mover's payload, each byte
    read once and written once), not for whole rows: switching emulation
    on in every lane changes nothing, and each payload byte adds two."""
    leaves = dict(packed["leaves"])
    off = interop.state_from_numpy({**leaves, "k_enabled": np.zeros_like(
        leaves["k_enabled"])})
    on = interop.state_from_numpy({**leaves, "k_enabled": np.ones_like(
        leaves["k_enabled"])})
    _, n_off, ops_off = SMOKE.census_bound_ms(off, 1000)
    _, n_on, ops_on = SMOKE.census_bound_ms(on, 1000)
    assert (n_on, ops_on) == (n_off, ops_off)
    _, n_pay, ops_pay = SMOKE.census_bound_ms(on, 1000, emul_payload=4096)
    assert n_pay - n_on == 2 * 4096 and ops_pay - ops_on == 2 * 4096 // 8
