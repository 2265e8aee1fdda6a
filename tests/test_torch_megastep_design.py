"""The CUDA megastep kernel's warp-level design, modelled on the CPU.

The kernel (``src/repro_torch/kernels/megastep/csrc/megastep.cu``) runs
one warp per lane: thread i holds guest register x_i, the bulk moves are
strided over the warp's 32 threads and the searches are ballots.  CUDA
does not run here, so each of those decompositions is written out below
as a small model over 32 "threads" and held against the plain version
(``megastep_chunk_ref``, the port's line-by-line translation of the JAX
step) or the guest-kernel engine (``repro_torch.emul.engine``) on
seeded states.  ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
the kernel itself to the plain version on the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (HookConfig, Mechanism, interop, pack_fleet,
                              prepare, programs)
from repro_torch.core import layout as L
from repro_torch.core import opspec
from repro_torch.core.fleet import FleetImages
from repro_torch.core.isa import Op
from repro_torch.core.machine import _SIGFRAME_IDX
from repro_torch.emul import engine
from repro_torch.emul import state as es
from repro_torch.kernels.megastep import ops as mops
from repro_torch.kernels.megastep.ref import megastep_chunk_ref
from repro_torch.trace import policy as tpolicy

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_megastep_design", ROOT / "chip_smoke.py")
M64 = (1 << 64) - 1
PC = L.TEXT_BASE  # every crafted lane's instruction sits here


# -- the models: 32 threads of one warp ----------------------------------------

def wrap(v: int) -> int:
    """An int as int64 (two's complement, wrapping)."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def ballot(preds) -> int:
    return sum(1 << i for i, p in enumerate(preds) if p)


def lowest(m: int) -> int:
    """Lowest set bit's index, 0 when none (``__ffs(m) - 1``)."""
    return (m & -m).bit_length() - 1 if m else 0


def highest(m: int) -> int:
    """Highest set bit's index (``31 - __clz(m)``, m != 0)."""
    return m.bit_length() - 1


def launch(B: int, block: int) -> dict:
    """The kernel's launch: ``ceil(B / block)`` blocks of ``32 * block``
    threads; thread t of block b serves lane ``b * block + t // 32`` as
    its thread ``t % 32`` (a warp past B returns)."""
    grid = -(-B // block)
    lanes = {}
    for b in range(grid):
        for t in range(32 * block):
            lane = b * block + t // 32
            if lane < B:
                lanes.setdefault(lane, []).append((b, t // 32, t % 32))
    return {"grid": grid, "threads": 32 * block, "lanes": lanes}


def warp_sum(words) -> int:
    """The stream-I/O write sum: word j added by thread j % 32, then a
    shuffle-xor tree; wrapping 64-bit adds in any order give one result."""
    parts = [0] * 32
    for j, w in enumerate(words):
        parts[j % 32] = (parts[j % 32] + int(w)) & M64
    for o in (16, 8, 4, 2, 1):
        parts = [(parts[i] + parts[i ^ o]) & M64 for i in range(32)]
    assert len(set(parts)) == 1  # every thread holds the sum
    return wrap(parts[0])


RB_READ, RB_WRITE, RB_GETPID, RB_EXIT, RB_SIGRET, RB_KNOWN = (
    1, 2, 4, 8, 16, 32)
EMUL_KINDS = (opspec.K_LSEEK, opspec.K_DUP, opspec.K_FSTAT, opspec.K_PIPE2,
              opspec.K_GETRANDOM, opspec.K_IOCTL)


def row_effect(kind: int, en: bool):
    """Thread i's row, resolved once for the lane's emulation gate:
    (flag bits, sets the constant, emulated family or None)."""
    simple = {opspec.K_IO_READ: RB_READ, opspec.K_IO_WRITE: RB_WRITE,
              opspec.K_GETPID: RB_GETPID, opspec.K_EXIT: RB_EXIT,
              opspec.K_SIGRETURN: RB_SIGRET}
    if kind in simple:
        return simple[kind] | RB_KNOWN, False, None
    if kind in (opspec.K_OPENAT, opspec.K_CLOSE):
        return RB_KNOWN, not en, kind if en else None
    if kind == opspec.K_CONST:
        return RB_KNOWN, True, None
    return (RB_KNOWN, False, kind) if en else (0, False, None)


def rows_ballot(nr: int, en: bool, rows) -> dict:
    """The syscall rows as the warp reads them: one ballot of the rows
    whose number is ``nr``, the flags OR'd, the constant and the family
    from the highest matching row that sets them."""
    match = ballot(r[0] == nr for r in rows)
    eff = [row_effect(r[1], en) for r in rows]
    bits = 0
    for i in range(len(rows)):
        if match >> i & 1:
            bits |= eff[i][0]
    cm = ballot(match >> i & 1 and eff[i][1] for i in range(len(rows)))
    fm = ballot(match >> i & 1 and eff[i][2] is not None
                for i in range(len(rows)))
    return {"read": bool(bits & RB_READ), "write": bool(bits & RB_WRITE),
            "getpid": bool(bits & RB_GETPID), "exit": bool(bits & RB_EXIT),
            "sigret": bool(bits & RB_SIGRET), "known": bool(bits & RB_KNOWN),
            "const": cm != 0, "const_val": rows[highest(cm)][2] if cm else 0,
            "fam": eff[highest(fm)][2] if fm else None}


def rows_loop(nr: int, en: bool, rows) -> dict:
    """The reference's loop over the rows (``fleet.exec_lanes``), for one
    lane: each matching row ORs its flags in; a later row's constant
    wins."""
    out = dict(read=False, write=False, getpid=False, exit=False,
               sigret=False, known=False, const=False, const_val=0, fam=None)
    names = {opspec.K_IO_READ: "read", opspec.K_IO_WRITE: "write",
             opspec.K_GETPID: "getpid", opspec.K_EXIT: "exit",
             opspec.K_SIGRETURN: "sigret"}
    for rnr, kind, const in rows:
        if rnr != nr:
            continue
        if kind in names:
            out[names[kind]] = True
        elif kind in (opspec.K_OPENAT, opspec.K_CLOSE):
            if en:
                out["fam"] = kind
            else:
                out["const"], out["const_val"] = True, const
        elif kind in EMUL_KINDS:
            if en:
                out["fam"] = kind
                out["known"] = True
            continue
        else:
            out["const"], out["const_val"] = True, const
        out["known"] = True
    return out


def policy_ballot(nr: int, actions, args, sys_nrs, emul_col, en: bool):
    """The policy gate: a ballot of the rows whose number is ``nr``; the
    highest wins, none leaves SLOT_UNKNOWN's row (thread 13)."""
    match = ballot(int(n) == nr for n in sys_nrs)
    slot = highest(match) if match else opspec.SLOT_UNKNOWN
    emulable = ballot(int(n) == nr and e for n, e in zip(sys_nrs, emul_col))
    action = int(actions[slot])
    return {"slot": slot, "action": action, "arg": int(args[slot]),
            "emulable": emulable != 0, "en": en}


# -- crafted lanes ---------------------------------------------------------------

def lanes(B: int, *, emul: bool, seed: int):
    """``B`` lanes from seeded random states (random guest-kernel tables
    with emulation on), each about to run one crafted instruction at PC;
    the images are the lanes' own (one row a lane), empty but for it."""
    pp = prepare(programs.getpid_loop(2), Mechanism.NONE,
                 cfg=HookConfig(emul_enabled=emul))
    _, _, s = pack_fleet([pp] * B, fuel=10_000, device="cpu")
    rng = np.random.default_rng(seed)
    code = SMOKE.code_of([pp] * B)
    leaves = SMOKE.scramble(interop.state_to_numpy(s), code, rng)
    if emul:
        leaves = SMOKE.scramble_kern(leaves, code, rng)
    leaves["pc"][:] = PC
    packed = np.zeros((B, L.CODE_WORDS), np.int64)
    imm = np.zeros((B, L.CODE_WORDS), np.int64)
    return leaves, packed, imm, rng


def put(packed, imm, b, op, *, rd=0, rn=0, rm=0, sh=0, cond=0, sf=1, im=0,
        pc=PC):
    packed[b, pc >> 2] = (int(op) | rd << 6 | rn << 11 | rm << 16 | sh << 22
                          | cond << 28 | sf << 32)
    imm[b, pc >> 2] = im


def step(leaves, packed, imm, tr=None, chunk=1):
    B = packed.shape[0]
    imgs = FleetImages(torch.from_numpy(packed.copy()),
                       torch.from_numpy(imm.copy()))
    ids = torch.arange(B, dtype=torch.int32)
    s = interop.state_from_numpy(leaves, "cpu")
    return megastep_chunk_ref(imgs, ids, s, tr, chunk=chunk)


# -- launch geometry ---------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 3, 4, 32])
@pytest.mark.parametrize("B", [1, 3, 500, 529, 1000])
def test_launch_geometry_gives_each_lane_one_whole_warp(B, block):
    """Every lane gets exactly one warp, all 32 threads of it in one
    block; the warps past B sit in the last block only; ``block`` is
    lanes a block, as the wrapper checks it (1..32)."""
    g = launch(B, block)
    assert g["threads"] == 32 * block <= 1024
    assert sorted(g["lanes"]) == list(range(B))
    for lane, threads in g["lanes"].items():
        assert [t[2] for t in threads] == list(range(32))
        assert len({(t[0], t[1]) for t in threads}) == 1  # one warp
    idle = g["grid"] * block - B
    assert 0 <= idle < block
    assert all(t[0] == g["grid"] - 1 for lane in range(B - (block - idle), B)
               for t in g["lanes"][lane]) or idle == 0
    leaves, packed, imm, _ = lanes(1, emul=False, seed=0)
    s = interop.state_from_numpy(leaves, "cpu")
    imgs = FleetImages(torch.from_numpy(packed), torch.from_numpy(imm))
    ids = torch.zeros(1, dtype=torch.int32)
    mops._validate(imgs, ids, s, None, 1, block)  # accepted
    for bad in (0, 33):
        with pytest.raises(ValueError, match="block"):
            mops._validate(imgs, ids, s, None, 1, bad)


# -- the syscall and policy rows as ballots ------------------------------------

ROWS = [(int(n), int(k), int(c)) for n, k, c in zip(
    opspec.SYS_NR_NP, opspec.SYS_KIND_NP, opspec.SYS_CONST_NP)]


@pytest.mark.parametrize("en", [False, True])
def test_syscall_row_ballot_matches_the_row_loop(en):
    """Every number of the table and numbers that match no row, with the
    lane's emulation on and off: the ballot model gives the reference
    loop's flags, constant and family; a later duplicate row's constant
    wins in both."""
    for nr in [*(r[0] for r in ROWS), 0, -1, 12345, 2**40]:
        assert rows_ballot(nr, en, ROWS) == rows_loop(nr, en, ROWS), nr
    const_nr = 500  # rows no table has: a constant, then a later one
    dup = ROWS + [(const_nr, opspec.K_CONST, 11),
                  (const_nr, opspec.K_CONST, 777),
                  (L.SYS_GETPID, opspec.K_CONST, -5)]
    for nr in (const_nr, L.SYS_GETPID, 12345):
        got = rows_ballot(nr, en, dup)
        assert got == rows_loop(nr, en, dup), nr
    assert rows_ballot(const_nr, en, dup)["const_val"] == 777
    assert rows_ballot(L.SYS_GETPID, en, dup)["const_val"] == -5


@pytest.mark.parametrize("en", [False, True])
def test_syscall_row_ballot_matches_the_plain_step(en):
    """Lanes on an svc of every table number and of numbers that match
    no row: where the ballot's outcome needs no guest-kernel service
    (getpid, a constant, -ENOSYS, stream I/O with the emulation off), x0
    after one plain step is the model's."""
    nrs = [r[0] for r in ROWS] + [0, 12345, -3]
    B = len(nrs)
    leaves, packed, imm, _ = lanes(B, emul=False, seed=1)
    leaves["k_enabled"][:] = int(en)
    leaves["in_signal"][:] = 0
    for b, nr in enumerate(nrs):
        put(packed, imm, b, Op.SVC)
        leaves["regs"][b, 8] = nr
        leaves["regs"][b, 1] = L.HEAP_BASE
        leaves["regs"][b, 2] = 64
    out = step(leaves, packed, imm)
    checked = 0
    for b, nr in enumerate(nrs):
        m = rows_ballot(nr, en, ROWS)
        if m["fam"] is not None or m["exit"] or m["sigret"] or (
                en and (m["read"] or m["write"])):
            continue
        if m["read"] or m["write"]:
            want = 64
        elif m["getpid"]:
            want = (L.VIRT_PID if leaves["ptrace"][b] and
                    leaves["virt_getpid"][b] else leaves["pid"][b])
        elif m["const"]:
            want = m["const_val"]
        else:
            assert not m["known"]
            want = -es.ERRNOS["ENOSYS"]
        assert int(out.regs[b, 0]) == want, (nr, en)
        checked += 1
    assert checked >= 4  # getpid and the three unmatched numbers at least


def test_policy_row_ballot_matches_the_plain_step():
    """Traced lanes on an svc, each with a random policy: the ballot's
    slot (the highest matching row, SLOT_UNKNOWN when none matches) is
    the histogram row the plain step bumps, and its action the verdict."""
    nrs = [r[0] for r in ROWS] * 2 + [0, 12345, -1, 700]
    B = len(nrs)
    leaves, packed, imm, rng = lanes(B, emul=True, seed=2)
    leaves["in_signal"][:] = 0
    for b, nr in enumerate(nrs):
        put(packed, imm, b, Op.SVC)
        leaves["regs"][b, 8] = nr
    pols = SMOKE.random_policies(B, rng, kill_lane=3)
    # a few lanes with rules on the numbers they call
    for b in range(0, B, 3):
        if 0 <= nrs[b] < 600:
            pols[b] = [tpolicy.deny(nrs[b], 7) if b % 2
                       else tpolicy.emulate(nrs[b], 99)]
    tl = SMOKE.scramble_trace(B, 4, rng, pols)
    tr = interop.trace_from_numpy(tl, "cpu")
    hist0 = tl["hist"].copy()
    s, t = step(leaves, packed, imm, tr)
    verdict_of = {opspec.POL_DENY: opspec.POL_DENY,
                  opspec.POL_EMULATE: opspec.POL_EMULATE,
                  opspec.POL_KILL: opspec.POL_KILL}
    for b, nr in enumerate(nrs):
        m = policy_ballot(nr, tl["pol_action"][b], tl["pol_arg"][b],
                          opspec.SYS_NR_NP, opspec.SYS_EMUL_NP,
                          bool(leaves["k_enabled"][b]))
        bumped = np.argwhere(t.hist[b].numpy() != hist0[b])
        assert len(bumped) == 1, (b, nr)
        slot, verdict = bumped[0]
        assert slot == m["slot"], (b, nr)
        if m["action"] in verdict_of:
            assert verdict == verdict_of[m["action"]], (b, nr)
        if m["action"] == opspec.POL_DENY:
            assert int(s.regs[b, 0]) == -m["arg"]


# -- free slots and the inode lookup as ballots --------------------------------

def _tables(kind: str, rng):
    F, N = L.MAX_FDS, L.MAX_INODES
    if kind == "full":
        return (np.arange(F) % F, np.full(F, es.FD_FILE),
                np.full(N, es.INO_FILE))
    if kind == "empty":
        return (np.full(F, -1), np.full(F, es.FD_FREE), np.full(N, es.INO_FREE))
    if kind.startswith("one_free_"):
        i = int(kind.rsplit("_", 1)[1])
        fd = np.arange(F) % F
        fd[i % F] = -1
        ok = np.full(F, es.FD_FILE)
        ok[(i * 5) % F] = es.FD_FREE
        ik = np.full(N, es.INO_PIPE)
        ik[i % N] = es.INO_FREE
        return fd, ok, ik
    return (np.where(rng.random(F) < 0.4, -1, rng.integers(0, F, F)),
            rng.choice([es.FD_FREE, es.FD_FILE, es.FD_PIPE_R], F),
            rng.choice([es.INO_FREE, es.INO_FILE, es.INO_PIPE], N))


@pytest.mark.parametrize("kind", ["full", "empty", "one_free_0",
                                  "one_free_7", "one_free_15", "random"])
def test_free_slot_ballots_match_the_engine(kind):
    """Lowest and second-lowest free fd and open-file slot, their counts,
    the lowest free inode (0 when none): the ballot model against the
    engine's argmax scans on the same tables."""
    rng = np.random.default_rng(3)
    for _ in range(20 if kind == "random" else 1):
        fd_ofd, ofd_kind, ino_kind = _tables(kind, rng)
        t = {k: torch.from_numpy(np.asarray(v, np.int64))[None]
             for k, v in (("fd", fd_ofd), ("ok", ofd_kind), ("ik", ino_kind))}
        free_fd = ballot(v < 0 for v in fd_ofd)
        free_ofd = ballot(v == es.FD_FREE for v in ofd_kind)
        free_ino = ballot(v == es.INO_FREE for v in ino_kind)
        m_fd = t["fd"] < 0
        fd_a = engine._first(m_fd)
        fd_b = engine._first(m_fd & ~engine._onehot(fd_a, L.MAX_FDS))
        m_ofd = t["ok"] == es.FD_FREE
        ofd_a = engine._first(m_ofd)
        ofd_b = engine._first(m_ofd & ~engine._onehot(ofd_a, L.MAX_FDS))
        m_ino = t["ik"] == es.INO_FREE
        assert lowest(free_fd) == int(fd_a)
        assert lowest(free_fd & (free_fd - 1)) == int(fd_b)
        assert bin(free_fd).count("1") == int(m_fd.sum())
        assert lowest(free_ofd) == int(ofd_a)
        assert lowest(free_ofd & (free_ofd - 1)) == int(ofd_b)
        assert bin(free_ofd).count("1") == int(m_ofd.sum())
        assert lowest(free_ino) == int(engine._first(m_ino))
        assert (free_ino != 0) == bool(m_ino.any())


@pytest.mark.parametrize("kind", ["none", "one", "several", "all"])
def test_inode_lookup_ballot_takes_the_lowest_match(kind):
    """openat's lookup: the lowest inode holding the name (the reference
    loop runs downward, so its last hit is the lowest) — the ballot model
    against the engine's scan, then against a plain openat step."""
    N = L.MAX_INODES
    name = es.path_key(b"f0")
    hits = {"none": [], "one": [5], "several": [6, 2, 4],
            "all": list(range(N))}[kind]
    ino_kind = np.full(N, es.INO_PIPE)
    ino_name = np.full(N, es.path_key(b"other"))
    for i in hits:
        ino_kind[i], ino_name[i] = es.INO_FILE, name
    ino_kind[N - 1] = es.INO_FREE if kind != "all" else es.INO_FILE
    found = ballot(k == es.INO_FILE and n == name
                   for k, n in zip(ino_kind, ino_name))
    fmatch = (torch.from_numpy(ino_kind)[None] == es.INO_FILE) & (
        torch.from_numpy(ino_name)[None] == name)
    assert lowest(found) == int(engine._first(fmatch))
    assert (found != 0) == bool(fmatch.any())
    # the plain step: open the name, O_CREAT; the new fd's inode is the hit
    leaves, packed, imm, _ = lanes(1, emul=True, seed=4)
    leaves["k_enabled"][:] = 1
    leaves["k_ino_kind"][0], leaves["k_ino_name"][0] = ino_kind, ino_name
    leaves["k_fd_ofd"][0] = -1
    leaves["k_ofd_kind"][0] = es.FD_FREE
    put(packed, imm, 0, Op.SVC)
    leaves["regs"][0, 8] = L.SYS_OPENAT
    leaves["regs"][0, 1] = L.HEAP_BASE
    leaves["regs"][0, 2] = L.O_CREAT
    leaves["mem"][0, (L.HEAP_BASE - L.DATA_BASE) >> 3] = name
    out = step(leaves, packed, imm)
    fd = int(out.regs[0, 0])
    assert fd == 0
    ofd = int(out.k_fd_ofd[0, fd])
    want = lowest(found) if found else lowest(
        ballot(k == es.INO_FREE for k in ino_kind))
    assert int(out.k_ofd_ino[0, ofd]) == want


# -- stream I/O strided over the warp --------------------------------------------

@pytest.mark.parametrize("io_k", [0, 1, 31, 33, 4096])
def test_stream_io_split_over_the_warp(io_k):
    """write(): the wrapping sum of io_k words near 2^63, word j by thread
    j % 32 and a shuffle tree, equals the plain step's out_sum; read():
    the fill strided over the warp writes the plain step's words."""
    leaves, packed, imm, rng = lanes(2, emul=False, seed=5 + io_k)
    leaves["in_signal"][:] = 0
    base = L.HEAP_BASE
    start = (base - L.DATA_BASE) >> 3
    words = (2**63 - 1 - rng.integers(0, 1 << 20, io_k)).astype(np.int64)
    words[::3] = -words[::3]
    leaves["mem"][0, start:start + io_k] = words
    for b, nr in enumerate((L.SYS_WRITE, L.SYS_READ)):
        put(packed, imm, b, Op.SVC)
        leaves["regs"][b, 8] = nr
        leaves["regs"][b, 1] = base
        leaves["regs"][b, 2] = 8 * io_k
    out = step(leaves, packed, imm)
    seq = 0
    for w in words:
        seq = wrap(seq + int(w))
    assert warp_sum(words) == seq
    assert int(out.out_sum[0]) == wrap(int(leaves["out_sum"][0])
                                       + warp_sum(words))
    fill = np.zeros(io_k, np.int64)
    for lid in range(32):  # thread lid writes words lid, lid + 32, ...
        for j in range(lid, io_k, 32):
            fill[j] = wrap(int(leaves["in_off"][1]) + 8 * j)
    assert np.array_equal(out.mem[1, start:start + io_k].numpy(), fill)


# -- the data mover at the plane's last lane -----------------------------------

def mover_model(mem_plane, ino_plane, nw, mem_base, ino_base, to_mem):
    """The data mover, word j by thread j % 32: sources clipped into the
    whole flat plane, destinations past its end dropped."""
    mtot, itot = mem_plane.size, ino_plane.size
    mem_plane, ino_plane = mem_plane.copy(), ino_plane.copy()
    for lid in range(32):
        for j in range(lid, nw, 32):
            if to_mem:
                d = mem_base + j
                if d < mtot:
                    mem_plane[d] = ino_plane[min(max(ino_base + j, 0),
                                                 itot - 1)]
            else:
                d = ino_base + j
                if d < itot:
                    ino_plane[d] = mem_plane[min(max(mem_base + j, 0),
                                                 mtot - 1)]
    return mem_plane, ino_plane


@pytest.mark.parametrize("direction", ["write_past_the_end",
                                       "read_from_past_the_end"])
def test_data_mover_clips_at_the_planes_last_lane(direction):
    """The last lane writes a file from an offset near INT64_MAX (the end
    wraps, the words run past the plane's end and are dropped), or reads
    one from a negative offset (the sources run past the plane's end and
    clip to its last word): the strided model equals the plain step on
    both planes."""
    B = 3
    leaves, packed, imm, rng = lanes(B, emul=True, seed=6)
    b = B - 1
    ipl = L.MAX_INODES * L.FILE_WORDS
    leaves["k_enabled"][b] = 1
    leaves["in_signal"][b] = 0
    ino = L.MAX_INODES - 2
    leaves["k_fd_ofd"][b, 3] = 4
    leaves["k_ofd_kind"][b, 4] = es.FD_FILE
    leaves["k_ofd_ino"][b, 4] = ino
    leaves["k_ofd_flags"][b, 4] = 0
    leaves["k_ino_kind"][b, ino] = es.INO_FILE
    leaves["k_ino_size"][b, ino] = L.FILE_BYTES
    put(packed, imm, b, Op.SVC)
    leaves["regs"][b, 0] = 3
    leaves["regs"][b, 1] = L.HEAP_BASE
    mem_base = b * L.MEM_WORDS + ((L.HEAP_BASE - L.DATA_BASE) >> 3)
    if direction == "write_past_the_end":
        off = 2**63 - 256
        n = 32768  # 4096 words from the file's last word on
        leaves["k_ofd_off"][b, 4] = off
        leaves["regs"][b, 8] = L.SYS_WRITE
        ino_base = b * ipl + ino * L.FILE_WORDS + L.FILE_WORDS - 1
        to_mem = False
    else:
        off = -8 * 3000
        n = 8 * 2048
        leaves["k_ofd_off"][b, 4] = off
        leaves["regs"][b, 8] = L.SYS_READ
        ino_base = b * ipl + ino * L.FILE_WORDS
        to_mem = True
    leaves["regs"][b, 2] = n
    want_mem, want_ino = mover_model(
        leaves["mem"].reshape(-1), leaves["k_ino_data"].reshape(-1), n >> 3,
        mem_base, ino_base, to_mem)
    assert (ino_base + (n >> 3) > B * ipl) or to_mem
    out = step(leaves, packed, imm)
    assert np.array_equal(out.mem.numpy().reshape(-1), want_mem)
    assert np.array_equal(out.k_ino_data.numpy().reshape(-1), want_ino)


# -- register writes in slot order -------------------------------------------------

def warp_writes(x, writes):
    """Thread i holds x_i (i < 31; thread 31's value is never read or
    written back); each write is ``x = lid == idx ? v : x`` in slot order,
    so a later write to the same register wins."""
    x = list(x)
    for idx, v in writes:
        x = [v if lid == idx else x[lid] for lid in range(32)]
    return x


def _word(leaves, b, addr):
    return int(leaves["mem"][b, (addr - L.DATA_BASE) >> 3])


@pytest.mark.parametrize("case", ["ldp_rd_is_rm", "ldr_post_base_is_rd",
                                  "ldp_post_base_is_rm", "svc_after_load",
                                  "signal", "sigreturn"])
def test_register_writes_in_slot_order(case):
    """The slot order primary, pair, base write-back, svc x0, signal
    x0/x1, sigreturn: the per-thread writes give the plain step's
    registers and SP."""
    leaves, packed, imm, _ = lanes(1, emul=False, seed=7)
    r = leaves["regs"][0]
    leaves["in_signal"][0] = 0
    addr = L.HEAP_BASE + 64
    chunk = 1
    sp = int(leaves["sp"][0])
    if case == "ldp_rd_is_rm":  # ldp x5, x5, [x3]
        r[3] = addr
        put(packed, imm, 0, Op.LDP, rd=5, rn=3, rm=5)
        writes = [(5, _word(leaves, 0, addr)), (5, _word(leaves, 0, addr + 8))]
    elif case == "ldr_post_base_is_rd":  # ldr x4, [x4], #16
        r[4] = addr
        put(packed, imm, 0, Op.LDRPOST, rd=4, rn=4, im=16)
        writes = [(4, _word(leaves, 0, addr)), (4, addr + 16)]
    elif case == "ldp_post_base_is_rm":  # ldp x1, x2, [x2], #16
        r[2] = addr
        put(packed, imm, 0, Op.LDPPOST, rd=1, rn=2, rm=2, im=16)
        writes = [(1, _word(leaves, 0, addr)), (2, _word(leaves, 0, addr + 8)),
                  (2, addr + 16)]
    elif case == "svc_after_load":  # ldr x0, [x3]; svc (getpid)
        r[3] = addr
        r[8] = L.SYS_GETPID
        put(packed, imm, 0, Op.LDRI, rd=0, rn=3)
        put(packed, imm, 0, Op.SVC, pc=PC + 4)
        leaves["ptrace"][0] = 0
        writes = [(0, _word(leaves, 0, addr)), (0, int(leaves["pid"][0]))]
        chunk = 2
    elif case == "signal":  # brk with a handler: frame, then x0/x1/SP
        leaves["sig_handler"][0] = PC + 0x100
        put(packed, imm, 0, Op.BRK)
        writes = [(0, opspec.SPECS[Op.BRK].signo), (1, L.SIGFRAME)]
        sp = L.SIGSTACK_TOP
    else:  # sigreturn: every register, SP and the flags from the frame
        r[8] = L.SYS_RT_SIGRETURN
        put(packed, imm, 0, Op.SVC)
        frame = leaves["mem"][0, _SIGFRAME_IDX:_SIGFRAME_IDX + 34]
        writes = [(i, int(frame[i])) for i in range(31)]
        sp = int(frame[31])
    x = warp_writes([*r.tolist(), 0], writes)
    out = step(leaves, packed, imm, chunk=chunk)
    assert out.regs[0].tolist() == x[:31], case
    assert int(out.sp[0]) == sp, case
    if case == "signal":  # the frame holds the PRE-step registers
        f = out.mem[0, _SIGFRAME_IDX:_SIGFRAME_IDX + 34].tolist()
        assert f[:31] == r.tolist() and f[31] == int(leaves["sp"][0])
        assert f[32] == PC and f[33] == int(leaves["nzcv"][0])
