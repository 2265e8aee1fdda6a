"""The port's durable serving against the JAX package's, on the CPU.

Under test: ``repro_torch.core.fleet``'s carry digests and snapshot
packing, ``repro_torch.checkpoint.manager``, and
``repro_torch.serve.durability`` with the server's durable paths — the
write-ahead journal, fleet snapshots and ``FleetServer.recover``.

What is held against the JAX package:

* on the same scrambled carries, ``carry_digest``, ``lane_digests``,
  ``pack_carry`` (keys and arrays), the ``unpack_carry`` round trip and
  ``flip_bit``;
* the checkpoint manager's flattened keys and ``manifest.json``;
* journals written by either package replay in the other;
* the same files: a JAX and a port durable server given the same requests
  write equal journal records (wall-clock fields and ``imp:`` builder refs
  aside) and equal snapshots;
* kill and recover: the port's server killed at fixed generations and
  recovered drains to the JAX server's uninterrupted run, and a directory
  the JAX server wrote recovers in the port.

Each JAX reference run is computed once a module.  The port runs its
plain megastep step here (a few ms a step), so the kill cases use a short
feed of ``tests/test_durability.py``'s shape — three tenants, the same
mechanisms, budget, priority, deadline and policy update — whose programs
run a few hundred steps each.
"""
import collections
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import manager as JM
from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import fleet as JF
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core import run_prepared as jrun_prepared
from repro.core.hookcfg import PolicyRule as JPolicyRule
from repro.sched import PolicyScheduler as JPolicyScheduler
from repro.sched import TenantBudget as JTenantBudget
from repro.serve import durability as JD
from repro.serve.fleet_server import FleetServer as JFleetServer

from repro_torch.checkpoint import manager as TM
from repro_torch.core import (HookConfig, Mechanism, fleet, interop,
                              pack_fleet, prepare, programs)
from repro_torch.core.hookcfg import PolicyRule
from repro_torch.sched import PolicyScheduler, TenantBudget
from repro_torch.serve import durability as D
from repro_torch.serve.fleet_server import FleetServer
from test_durability import _result_key, _sink_streams

ROOT = pathlib.Path(__file__).resolve().parents[1]
FUEL = 25_000

JAX = types.SimpleNamespace(
    name="jax", FleetServer=JFleetServer, PolicyScheduler=JPolicyScheduler,
    TenantBudget=JTenantBudget, HookConfig=JHookConfig, prepare=jprepare,
    programs=jprograms, Mechanism=JMechanism, PolicyRule=JPolicyRule, D=JD,
    kw={})
PORT = types.SimpleNamespace(
    name="torch", FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    TenantBudget=TenantBudget, HookConfig=HookConfig, prepare=prepare,
    programs=programs, Mechanism=Mechanism, PolicyRule=PolicyRule, D=D,
    kw={"device": "cpu"})


def _register(pkg):
    """The same builder names in both packages: the reference suite's, the
    short feed's (``tdur-*``) and tests/test_emul.py's churn builders."""
    P = pkg.programs
    for name, fn in (
            ("dur-getpid", lambda: P.getpid_loop(300)),
            ("dur-mixed", lambda: P.mixed_ops(24, 128)),
            ("tdur-mixed", lambda: P.mixed_ops(3, 32)),
            ("tdur-mixed2", lambda: P.mixed_ops(2, 16)),
            ("tdur-getpid", lambda: P.getpid_loop_param()),
            ("tdur-read", lambda: P.read_loop_param()),
            ("emul-churn", lambda: P.file_churn_param(256)),
            ("emul-proc", lambda: P.proc_probe_param())):
        if name not in pkg.D.BUILDERS:
            pkg.D.register_builder(name, fn)


for _pkg in (JAX, PORT):
    _register(_pkg)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's plain step on a few lanes is op overhead: one intra-op
    thread runs it fastest and leaves the other cores to other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _smoke():
    """chip_smoke.py as a module (its scramblers)."""
    if "_chip_smoke_durability" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "_chip_smoke_durability", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["_chip_smoke_durability"] = mod
    return sys.modules["_chip_smoke_durability"]


def _drained(srv) -> bool:
    return (not srv._queue and not srv._readmit
            and all(r is None for r in srv._slots))


def _policy(pkg):
    return [pkg.PolicyRule(-1, "allow"), pkg.PolicyRule(63, "emulate", 5)]


def _mk(pkg, directory=None, *, pool=4, sched=True, interval=3, budget=12,
        **cfg_kw):
    """tests/test_durability.py's ``_mk_server`` in ``pkg`` (budget 40
    there; 12 suits the short feed's budget cycles)."""
    cfg = pkg.HookConfig(trace_enabled=True, compact_enabled=True,
                         snapshot_interval=interval, journal_fsync=False,
                         **cfg_kw)
    scheduler = (pkg.PolicyScheduler(
        budgets={"b": pkg.TenantBudget(max_svc=budget)}) if sched else None)
    dur = (pkg.D.DurabilityManager(directory) if directory is not None
           else None)
    return pkg.FleetServer(pool, cfg=cfg, gen_steps=48, fuel=FUEL,
                           scheduler=scheduler, durability=dur, **pkg.kw)


def _feed_mixed(pkg, srv, mech):
    """tests/test_durability.py's ``_feed_mixed``."""
    m = getattr(pkg.Mechanism, mech)
    virt = mech != "NONE"
    for _ in range(3):
        srv.submit(pkg.programs.getpid_loop, mechanism=m, virtualize=virt,
                   fuel=FUEL, tenant="a", priority=1)
        srv.submit(pkg.D.BUILDERS["dur-mixed"], mechanism=m, virtualize=virt,
                   fuel=FUEL, tenant="b")
        srv.submit(pkg.programs.read_loop, mechanism=m, virtualize=virt,
                   fuel=FUEL, tenant="c", deadline_steps=4000)


def _feed_short(pkg, srv, mech, *, registered=False):
    """``_feed_mixed``'s shape with short programs: ``imp:`` builders (or,
    ``registered``, only ``reg:`` ones) with their iterations in x19."""
    m = getattr(pkg.Mechanism, mech)
    virt = mech != "NONE"
    B = pkg.D.BUILDERS
    getpid = B["tdur-getpid"] if registered else pkg.programs.getpid_loop_param
    read = B["tdur-read"] if registered else pkg.programs.read_loop_param
    for _ in range(3):
        srv.submit(getpid, mechanism=m, virtualize=virt, fuel=FUEL,
                   regs={19: 3}, tenant="a", priority=1)
        srv.submit(B["tdur-mixed2"], mechanism=m, virtualize=virt, fuel=FUEL,
                   tenant="b")
        srv.submit(read, mechanism=m, virtualize=virt, fuel=FUEL,
                   regs={19: 2}, tenant="c", deadline_steps=400)


STATS_KEYS = ("tenants", "completed", "preemptions", "evictions",
              "quarantine", "budget_exhaustions", "c3_readmissions",
              "shed_requests")


def _union(*outs):
    """At-least-once publication: the last result of each rid wins."""
    union = {}
    for out in outs:
        for r in out:
            union[r.rid] = r
    return union


def _keys(results):
    return sorted(_result_key(r) for r in results)


@pytest.fixture(scope="module")
def jax_short():
    """The JAX server's uninterrupted run of the short feed, once for each
    (mechanism, pool, scheduled, registered builders): (result keys,
    stats)."""
    cache = {}

    def get(mech, pool, sched=True, registered=False):
        key = (mech, pool, sched, registered)
        if key not in cache:
            srv = _mk(JAX, pool=pool, sched=sched)
            _feed_short(JAX, srv, mech, registered=registered)
            srv.update_policy("c", _policy(JAX))
            cache[key] = (_keys(srv.run(5000)), srv.stats())
        return cache[key]

    return get


def _no_replay_divergence(caplog):
    """The replay re-published exactly what the journal recorded (outside a
    chaos window, a difference would be non-determinism)."""
    assert not [m for m in caplog.messages if "replay gen" in m]


# -- carry digests and snapshot packing ------------------------------------

def _carry_processes():
    pps = [prepare(programs.getpid_loop_param(), Mechanism.ASC,
                   virtualize=True),
           prepare(programs.read_loop_param(), Mechanism.SIGNAL,
                   virtualize=True),
           prepare(programs.file_churn_param(256), Mechanism.ASC,
                   virtualize=True)]
    return pps, [{19: 3}, {19: 2}, {19: 4}]


def _scrambled(n, traced, seed):
    """A scrambled carry of ``n`` lanes (chip_smoke.py's scramblers) as
    numpy leaves, cast to the JAX carry's dtypes: (states, trace or
    None)."""
    pps, regs = _carry_processes()
    pps, regs = pps[:n], regs[:n]
    _, _, s0 = pack_fleet(pps, fuel=FUEL, regs=regs, device="cpu")
    rng = np.random.default_rng(seed)
    SMOKE = _smoke()
    code = SMOKE.code_of(pps)
    leaves = SMOKE.scramble_kern(SMOKE.scramble(
        interop.state_to_numpy(s0), code, rng), code, rng)
    ref_s = JF.make_halted_states(n)
    leaves = {f: np.asarray(leaves[f]).astype(np.asarray(x).dtype)
              for f, x in zip(ref_s._fields, ref_s)}
    if not traced:
        return leaves, None
    tr = SMOKE.scramble_trace(n, 16, rng, SMOKE.random_policies(n, rng))
    ref_t = JF.make_empty_trace(n, 16)
    return leaves, {f: np.asarray(tr[f]).astype(np.asarray(x).dtype)
                    for f, x in zip(ref_t._fields, ref_t)}


def _both(leaves, trace):
    """The same carry as JAX arrays and as the port's CPU tensors."""
    js = JF.MachineState(**{f: jnp.asarray(v) for f, v in leaves.items()})
    ts = interop.state_from_numpy(leaves)
    if trace is None:
        return (js, None), (ts, None)
    jt = JF.TraceState(**{f: jnp.asarray(v) for f, v in trace.items()})
    return (js, jt), (ts, interop.trace_from_numpy(trace))


CARRIES = [(n, traced, seed) for n, traced, seed in
           ((1, False, 0), (2, True, 1), (3, False, 2), (3, True, 3))]


@pytest.mark.parametrize("n,traced,seed", CARRIES)
def test_carry_functions_match_jax(n, traced, seed):
    """carry_digest, lane_digests, pack_carry (keys, dtypes, arrays) and
    the unpack_carry round trip, on the same scrambled carry."""
    (js, jt), (ts, tt) = _both(*_scrambled(n, traced, seed))
    assert fleet.carry_digest(ts, tt) == JF.carry_digest(js, jt)
    assert fleet.lane_digests(ts, tt) == JF.lane_digests(js, jt)
    jp = JF.pack_carry(js, jt, prefix="carry/")
    tp = fleet.pack_carry(ts, tt, prefix="carry/")
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype, k
        assert np.array_equal(tp[k], jp[k]), k
    # the port unpacks its own arrays and the JAX package's to the carry
    for arrays in (tp, jp):
        us, ut = fleet.unpack_carry(arrays, prefix="carry/", device="cpu")
        assert (ut is None) == (tt is None)
        for a, b in zip(list(us) + list(ut or ()), list(ts) + list(tt or ())):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # and JAX unpacks the port's
    ju, _ = JF.unpack_carry(tp, prefix="carry/")
    for a, b in zip(ju, js):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # one lane (a parked checkpoint's layout)
    lane_t = fleet.unstack_state(ts, n - 1)
    lane_j = JF.unstack_state(js, n - 1)
    jl, tl = JF.pack_carry(lane_j, prefix="ckpt/0/"), \
        fleet.pack_carry(lane_t, prefix="ckpt/0/")
    assert list(jl) == list(tl)
    assert all(np.array_equal(jl[k], tl[k]) for k in jl)


@pytest.mark.parametrize("n,traced,seed", CARRIES)
def test_flip_bit_matches_jax_and_moves_one_lane_digest(n, traced, seed):
    (js, jt), (ts, tt) = _both(*_scrambled(n, traced, seed))
    before = fleet.lane_digests(ts, tt)
    mem = ts.mem
    lane, word, bit = n - 1, 12345, 63 if seed % 2 else 5
    got = fleet.flip_bit(ts, lane, word, bit)
    assert got is ts and got.mem is mem             # in place
    want = JF.flip_bit(js, lane, word, bit)
    assert np.array_equal(ts.mem.numpy(), np.asarray(want.mem))
    after = fleet.lane_digests(ts, tt)
    assert [b for b in range(n) if before[b] != after[b]] == [lane]
    assert fleet.carry_digest(ts, tt) == JF.carry_digest(want, jt)


def test_flip_reaches_no_checkpoint_or_published_state():
    """The live carry is flipped in place; a parked checkpoint and a
    published state are copies and stay as they were."""
    srv = FleetServer(1, gen_steps=40, chunk=8, fuel=FUEL, trace=True,
                      scheduler=PolicyScheduler(), device="cpu")
    storm = prepare(programs.syscall_storm_param(), Mechanism.NONE)
    getpid = prepare(programs.getpid_loop_param(), Mechanism.ASC,
                     virtualize=True)
    srv.submit(getpid, regs={19: 1}, tenant="p")
    published = []
    while not published:
        published = srv.step()
    srv.submit(storm, regs={19: 6, 20: 2, 21: 6}, tenant="a")
    srv.step()
    srv.submit(getpid, regs={19: 2}, tenant="b", priority=10,
               deadline_steps=40)
    srv.step()                               # preempts a, admits b
    parked = next(r for r in srv._queue if r.checkpoint is not None)
    kept = [x.clone() for x in list(parked.checkpoint[0])
            + list(parked.checkpoint[1])]
    kept_pub = [x.clone() for x in published[0].state]
    for word in range(0, 32768, 4096):
        for bit in (0, 63):
            fleet.flip_bit(srv._states, 0, word, bit)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, list(parked.checkpoint[0]) + list(parked.checkpoint[1])))
    assert all(torch.equal(a, b) for a, b in zip(kept_pub,
                                                 published[0].state))


# -- the checkpoint manager -------------------------------------------------

NT = collections.namedtuple("NT", "b a")


def _tree(kind):
    x, y = np.arange(4), np.ones((2, 3), np.float32)
    return {"dict": {"z": x, "a": y},
            "list": [x, y, [x]],
            "tuple": (y, (x,)),
            "namedtuple": NT(np.int32(3), x),
            "none": {"a": None, "b": x, "c": [None, y]},
            "mixed": {"z": np.arange(2), "a": [x, (y,)], "n": NT(y, x),
                      "none": None}}[kind]


TREES = ["dict", "list", "tuple", "namedtuple", "none", "mixed"]


@pytest.mark.parametrize("kind", TREES)
def test_checkpoint_keys_and_manifest_match_jax(tmp_path, kind):
    tree = _tree(kind)
    keys = [k for k, _ in TM._flatten_with_paths(tree)]
    assert keys == [k for k, _ in JM._flatten_with_paths(tree)]
    if kind == "mixed":
        assert keys == ["a/0", "a/1/0", "n/.b", "n/.a", "z"]
    JM.CheckpointManager(tmp_path / "j").save(7, tree, extra={"e": [1]})
    TM.CheckpointManager(tmp_path / "t").save(7, tree, extra={"e": [1]})
    mj = json.loads((tmp_path / "j/step_00000007/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_00000007/manifest.json").read_text())
    assert mt == mj
    # the port restores the JAX manager's directory onto a tensor tree
    like = TM._unflatten(tree, iter(torch.zeros(1) for _ in keys))
    step, got, extra = TM.CheckpointManager(tmp_path / "j").restore_latest(
        like=like)
    assert step == 7 and extra == {"e": [1]}
    for (k, a), (_, b) in zip(TM._flatten_with_paths(got),
                              TM._flatten_with_paths(tree)):
        assert np.array_equal(a, b.astype(np.float32)), k


def test_restore_latest_puts_tensors_on_the_like_device(tmp_path):
    mgr = TM.CheckpointManager(tmp_path, keep=2)
    mgr.save(1, {"x": torch.arange(4), "n": NT(torch.ones(2), None)})
    like = {"x": torch.zeros(4, dtype=torch.int32),
            "n": NT(torch.zeros(2, dtype=torch.float64), None)}
    _, got, _ = mgr.restore_latest(like=like)
    assert got["x"].dtype == torch.int32 and got["x"].device == like[
        "x"].device
    assert torch.equal(got["x"], torch.arange(4, dtype=torch.int32))
    assert isinstance(got["n"], NT) and got["n"].a is None
    assert got["n"].b.dtype == torch.float64


def test_restore_latest_falls_back_to_valid_step(tmp_path, caplog):
    mgr = TM.CheckpointManager(tmp_path, keep=5)
    mgr.save(1, {"x": np.arange(4)})
    mgr.save(2, {"x": np.arange(8)})
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"torn")
    with caplog.at_level("WARNING"):
        step, arrays, _ = mgr.restore_latest(None)
    assert step == 1
    assert np.array_equal(arrays["x"], np.arange(4))
    assert any("skipping corrupt checkpoint" in m for m in caplog.messages)
    assert any("fallback" in m for m in caplog.messages)


def test_restore_latest_all_corrupt_raises(tmp_path):
    mgr = TM.CheckpointManager(tmp_path, keep=5)
    mgr.save(1, {"x": np.arange(4)})
    mgr.save(2, {"x": np.arange(8)})
    for d in tmp_path.glob("step_*"):
        (d / "arrays.npz").write_bytes(b"torn")
    with pytest.raises(IOError, match="integrity"):
        mgr.restore_latest(None)


def test_restore_latest_empty_dir_returns_none(tmp_path):
    assert TM.CheckpointManager(tmp_path, keep=5).restore_latest(None) is None


def test_async_writer_round_trip_copies_before_the_thread(tmp_path):
    mgr = TM.CheckpointManager(tmp_path, keep=3)
    w = TM.AsyncWriter(mgr)
    x = torch.arange(6)
    w.save(1, {"x": x, "t": (x[:2],)})
    x.add_(100)                      # the caller goes on changing it
    w.wait()
    step, arrays, _ = mgr.restore_latest(None)
    assert step == 1 and list(arrays) == ["t/0", "x"]
    assert np.array_equal(arrays["x"], np.arange(6))
    assert np.array_equal(arrays["t/0"], np.arange(2))
    assert mgr.all_steps() == [1]


# -- the write-ahead journal ---------------------------------------------------

def test_journal_roundtrip(tmp_path):
    j = D.Journal(tmp_path / "j.jsonl", fsync=False)
    j.append("open", a=1)
    j.append("submit", rid=0, nested={"x": [1, 2]})
    j.append("gen", gen=0, rids=[0], skipped=False)
    j.close()
    recs, good = D.Journal.replay(tmp_path / "j.jsonl")
    assert [r["kind"] for r in recs] == ["open", "submit", "gen"]
    assert [r["seq"] for r in recs] == [0, 1, 2]
    assert good == (tmp_path / "j.jsonl").stat().st_size


def test_journal_torn_tail_dropped(tmp_path):
    p = tmp_path / "j.jsonl"
    j = D.Journal(p, fsync=False)
    j.append("open", a=1)
    j.append("gen", gen=0, rids=[], skipped=False)
    j.close()
    lines = p.read_bytes().splitlines(keepends=True)
    p.write_bytes(lines[0] + lines[1][:len(lines[1]) // 2])
    recs, good = D.Journal.replay(p)
    assert [r["kind"] for r in recs] == ["open"]
    assert good == len(lines[0])
    j2 = D.Journal(p, fsync=False, next_seq=recs[-1]["seq"] + 1,
                   truncate_at=good)
    j2.append("gen", gen=0, rids=[], skipped=True)
    j2.close()
    recs2, _ = D.Journal.replay(p)
    assert [r["kind"] for r in recs2] == ["open", "gen"]
    assert recs2[-1]["skipped"] is True


def test_journal_corrupt_line_hides_suffix(tmp_path):
    p = tmp_path / "j.jsonl"
    j = D.Journal(p, fsync=False)
    for i in range(4):
        j.append("gen", gen=i, rids=[], skipped=False)
    j.close()
    lines = p.read_bytes().splitlines(keepends=True)
    bad = bytearray(lines[1])
    bad[12] ^= 0xFF
    p.write_bytes(lines[0] + bytes(bad) + lines[2] + lines[3])
    recs, _ = D.Journal.replay(p)
    assert [r["gen"] for r in recs] == [0]


@pytest.mark.parametrize("writer,reader", [(JD, D), (D, JD)],
                         ids=["jax_to_port", "port_to_jax"])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    p = tmp_path / "j.jsonl"
    j = writer.Journal(p, fsync=False)
    j.append("open", server={"pool": 4, "cfg": {"x": 1.5}})
    j.append("submit", req={"rid": 0, "regs": {"19": 3}, "policy": None})
    j.append("gen", gen=0, rids=[0], skipped=False, stream_hwm={"0": [0, 2]})
    j.close()
    data = p.read_bytes()
    p.write_bytes(data + data[:20])             # and a torn tail
    want = writer.Journal.replay(p)
    got = reader.Journal.replay(p)
    assert got == want
    assert got[1] == len(data) and len(got[0]) == 3


# -- submit ----------------------------------------------------------------

def test_submit_validates_kwargs_eagerly():
    srv = FleetServer(2, gen_steps=32, fuel=FUEL, device="cpu")
    with pytest.raises(ValueError, match="tenant"):
        srv.submit(programs.getpid_loop, tenant=7)
    with pytest.raises(ValueError, match="priority"):
        srv.submit(programs.getpid_loop, priority="high")
    with pytest.raises(ValueError, match="priority"):
        srv.submit(programs.getpid_loop, priority=True)
    with pytest.raises(ValueError, match="deadline_steps"):
        srv.submit(programs.getpid_loop, deadline_steps=-5)
    with pytest.raises(ValueError, match="deadline_steps"):
        srv.submit(programs.getpid_loop, deadline_steps=2.5)
    with pytest.raises(ValueError, match="fuel"):
        srv.submit(programs.getpid_loop, fuel=0)
    assert not srv._queue
    rid = srv.submit(programs.getpid_loop, tenant="t", priority=np.int64(2),
                     deadline_steps=np.int64(0), fuel=np.int64(FUEL))
    assert rid == 0 and len(srv._queue) == 1


def test_durable_submit_refuses_unserialisable_builder(tmp_path):
    srv = FleetServer(2, gen_steps=32, fuel=FUEL, device="cpu",
                      durability=D.DurabilityManager(tmp_path / "d"))
    with pytest.raises(ValueError, match="builder"):
        srv.submit(lambda: programs.getpid_loop(123))   # a closure
    assert not srv._queue
    assert D.builder_ref(D.BUILDERS["dur-getpid"]) == "reg:dur-getpid"
    assert D.builder_ref(programs.getpid_loop) == \
        "imp:repro_torch.core.programs:getpid_loop"
    srv.submit(D.BUILDERS["dur-getpid"], fuel=FUEL)
    srv.submit(programs.getpid_loop, fuel=FUEL)
    assert len(srv._queue) == 2


# -- the same files ------------------------------------------------------------

CLOCK_FIELDS = {"wait_s", "parked_wait_s", "obs_wm"}


def _scrub(obj):
    """A journal record without its wall-clock fields, ``imp:`` refs
    reduced to their function name (the module differs by design).  A
    snapshot record's ``bytes`` counts its manifest, whose metadata holds
    the wall-clock fields, so it goes too (the arrays' file sizes are
    compared apart)."""
    if isinstance(obj, dict):
        drop = CLOCK_FIELDS | ({"bytes"} if obj.get("kind") == "snapshot"
                               else set())
        return {k: _scrub(v) for k, v in obj.items() if k not in drop}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str) and obj.startswith("imp:"):
        return "imp:" + obj.rsplit(":", 1)[1]
    return obj


def test_same_journal_and_snapshots_as_jax(tmp_path):
    """``_mk_server``'s settings (pool 4, gen_steps 48, interval 3,
    budget 40) and ``_feed_mixed`` with a policy update, 7 generations in
    each package: every journal record and every snapshot's arrays and
    manifest hash are equal."""
    for pkg in (JAX, PORT):
        srv = _mk(pkg, tmp_path / pkg.name, budget=40)
        _feed_mixed(pkg, srv, "ASC")
        srv.update_policy("c", _policy(pkg))
        for _ in range(7):
            srv.step()
        assert srv._dur.snapshots == 2
    jrec, _ = JD.Journal.replay(tmp_path / "jax" / "journal.jsonl")
    trec, _ = D.Journal.replay(tmp_path / "torch" / "journal.jsonl")
    assert [r["kind"] for r in trec] == [r["kind"] for r in jrec]
    assert any(r["req"]["builder"].startswith("imp:repro_torch.")
               for r in trec if r["kind"] == "submit")
    for a, b in zip(jrec, trec):
        assert _scrub(b) == _scrub(a), a["kind"]
    snaps = sorted(p.name for p in (tmp_path / "jax/snapshots").glob(
        "step_*"))
    assert snaps == sorted(p.name for p in (tmp_path / "torch/snapshots")
                           .glob("step_*")) and len(snaps) == 2
    for name in snaps:
        mj, aj = JM.CheckpointManager(tmp_path / "jax/snapshots").load_step(
            tmp_path / "jax/snapshots" / name)
        mt, at = TM.CheckpointManager(tmp_path / "torch/snapshots").load_step(
            tmp_path / "torch/snapshots" / name)
        assert mt["hash"] == mj["hash"] and mt["keys"] == mj["keys"]
        # equal zip bytes: a chaos 'corrupt' injection draws its offset
        # from the file's length
        assert (tmp_path / "torch/snapshots" / name / "arrays.npz").stat(
        ).st_size == (tmp_path / "jax/snapshots" / name / "arrays.npz"
                      ).stat().st_size
        for k in mj["keys"]:
            assert at[k].dtype == aj[k].dtype and np.array_equal(
                at[k], aj[k]), (name, k)
        assert _scrub(mt["extra"]) == _scrub(mj["extra"])
    # the image store holds the same files
    for p in (tmp_path / "jax/images").glob("*.npz"):
        with np.load(p) as a, np.load(tmp_path / "torch/images" / p.name) \
                as b:
            assert all(np.array_equal(a[k], b[k]) for k in a.files)


# -- kill and recover at fixed generations ---------------------------------

# (mechanism, pool, kill generation): a fixed subset of {NONE, ASC, SIGNAL}
# x {2, 4} x {0, 1, 3, 4, 7, 11}: both pools, every mechanism and every
# kill generation once or more (ASC, the longest feed, at pool 4 only).  At interval 3 a kill at 3 lands on a
# snapshot boundary, 0 before any snapshot, the others past one; the
# NONE feed at pool 2 drains in 8 generations, so its kill at 11 recovers
# a finished run.
KILLS = [("NONE", 2, 0), ("NONE", 2, 11), ("NONE", 4, 3), ("ASC", 4, 1),
         ("ASC", 4, 4), ("ASC", 4, 7), ("SIGNAL", 2, 3), ("SIGNAL", 4, 11)]


def _kill(pkg, directory, kill_gen, *, mech="ASC", pool=4, feed=None,
          **mk_kw):
    """A durable server of ``pkg`` fed and stepped ``kill_gen``
    generations, then dropped: returns what it published."""
    vic = _mk(pkg, directory, pool=pool, **mk_kw)
    (feed or (lambda s: _feed_short(pkg, s, mech)))(vic)
    if mk_kw.get("sched", True):
        vic.update_policy("c", _policy(pkg))
    pre = []
    for _ in range(kill_gen):
        if _drained(vic):
            break
        pre.extend(vic.step())
    return pre


@pytest.mark.parametrize("mech,pool,kill_gen", KILLS)
def test_kill_and_recover_matches_jax(tmp_path, caplog, jax_short, mech,
                                      pool, kill_gen):
    ref_keys, ref_stats = jax_short(mech, pool)
    pre = _kill(PORT, tmp_path / "vic", kill_gen, mech=mech, pool=pool)
    with caplog.at_level("WARNING"):
        srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
        post = srv.run(5000)
    assert _keys(_union(pre, replayed, post).values()) == ref_keys
    ss = srv.stats()
    for k in STATS_KEYS:
        assert ss[k] == ref_stats[k], k
    assert (ss["recovery_generations"] > 0 or kill_gen == 0
            or ss["snapshots"] > 0)
    _no_replay_divergence(caplog)


def test_journal_only_recovery(tmp_path, caplog, jax_short):
    """snapshot_interval=0: recovery replays the whole journal from the
    construction record."""
    pre = _kill(PORT, tmp_path / "vic", 7, mech="SIGNAL", interval=0,
                sched=False)
    assert not (tmp_path / "vic" / "snapshots").exists() or not list(
        (tmp_path / "vic" / "snapshots").glob("step_*"))
    with caplog.at_level("WARNING"):
        srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
        post = srv.run(5000)
    ref_keys, _ = jax_short("SIGNAL", 4, sched=False)
    assert _keys(_union(pre, replayed, post).values()) == ref_keys
    assert srv.stats()["recovery_generations"] >= 7
    _no_replay_divergence(caplog)


def test_prepared_process_recovery_via_image_store(tmp_path):
    """Builder-less submissions rehydrate from the content-addressed image
    store; the results equal the JAX package's solo run."""
    pp = prepare(programs.mixed_ops(2, 16), Mechanism.ASC, virtualize=True)
    solo = jrun_prepared(jprepare(jprograms.mixed_ops(2, 16), JMechanism.ASC,
                                  virtualize=True), fuel=FUEL)
    vic = _mk(PORT, tmp_path / "vic", sched=False)
    for _ in range(3):
        vic.submit(pp, fuel=FUEL)
    pre = [r for _ in range(4) for r in vic.step()]
    del vic
    assert len(list((tmp_path / "vic" / "images").glob("*.npz"))) == 1
    srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
    assert all(r.builder is None for r in srv._queue)
    union = _union(pre, replayed, srv.run(5000))
    assert len(union) == 3
    for r in union.values():
        for f, a, b in zip(solo._fields, solo, r.state):
            assert np.array_equal(np.asarray(a), b.numpy()), f


def test_crash_during_snapshot_is_invisible(tmp_path, jax_short):
    """A .tmp snapshot dir (a crash mid-save) is never considered; the
    previous snapshot restores."""
    pre = _kill(PORT, tmp_path / "vic", 5, mech="SIGNAL", sched=False,
                interval=2)
    torn = tmp_path / "vic" / "snapshots" / "step_99999999.tmp"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"half-written")
    srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
    assert srv.generation == 5 and srv.recovery_generations == 1
    ref_keys, _ = jax_short("SIGNAL", 4, sched=False)
    assert _keys(_union(pre, replayed, srv.run(5000)).values()) == ref_keys


def test_recovery_falls_back_past_corrupt_snapshot(tmp_path, jax_short):
    """Corrupting the newest snapshot after the crash forces recovery to
    the older one and a longer journal replay — results unchanged."""
    pre = _kill(PORT, tmp_path / "vic", 7, mech="SIGNAL", sched=False,
                interval=2)
    snaps = sorted((tmp_path / "vic" / "snapshots").glob("step_*"))
    assert len(snaps) >= 2
    (snaps[-1] / "arrays.npz").write_bytes(b"bitrot")
    srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
    assert srv.stats()["recovery_generations"] == 3    # gens 4, 5, 6
    ref_keys, _ = jax_short("SIGNAL", 4, sched=False)
    assert _keys(_union(pre, replayed, srv.run(5000)).values()) == ref_keys


def test_fresh_manager_refuses_existing_journal(tmp_path):
    vic = _mk(PORT, tmp_path / "d", sched=False)
    vic.submit(programs.getpid_loop, fuel=FUEL)
    del vic
    with pytest.raises(Exception, match="recover"):
        _mk(PORT, tmp_path / "d", sched=False)


def test_jax_directory_recovers_in_the_port(tmp_path, caplog, jax_short):
    """A directory the JAX server wrote (``reg:`` builders only), killed at
    generation 4, is recovered by the port's FleetServer.recover and
    drains to the JAX uninterrupted run."""
    pre = _kill(JAX, tmp_path / "jax", 4,
                feed=lambda s: _feed_short(JAX, s, "ASC", registered=True))
    with caplog.at_level("WARNING"):
        srv, replayed = FleetServer.recover(tmp_path / "jax", device="cpu")
        post = srv.run(5000)
    ref_keys, ref_stats = jax_short("ASC", 4, registered=True)
    assert _keys(_union(pre, replayed, post).values()) == ref_keys
    ss = srv.stats()
    for k in STATS_KEYS:
        assert ss[k] == ref_stats[k], k
    _no_replay_divergence(caplog)
    # the port went on journaling in the JAX package's format
    recs, _ = JD.Journal.replay(tmp_path / "jax" / "journal.jsonl")
    assert recs[-1]["kind"] in ("gen", "snapshot")
    assert any(r["kind"] == "recover" for r in recs)


# -- the streamed kill -----------------------------------------------------

def _stream_server(pkg, directory, sink):
    cfg = pkg.HookConfig(trace_enabled=True, trace_stream=True,
                         trace_sink=str(sink), compact_enabled=True,
                         snapshot_interval=3, journal_fsync=False)
    dur = (pkg.D.DurabilityManager(directory) if directory is not None
           else None)
    return pkg.FleetServer(4, cfg=cfg, gen_steps=48, fuel=FUEL,
                           durability=dur, **pkg.kw)


def _stream_feed(pkg, srv):
    """tests/test_durability.py's ``_stream_feed`` with short programs, three
    rounds (two of these finish before generation 13)."""
    M, P = pkg.Mechanism, pkg.programs
    for _ in range(3):
        srv.submit(P.getpid_loop_param, mechanism=M.ASC, virtualize=True,
                   fuel=FUEL, regs={19: 4})
        srv.submit(pkg.D.BUILDERS["tdur-mixed"], mechanism=M.SIGNAL,
                   virtualize=True, fuel=FUEL)
        srv.submit(P.read_loop_param, mechanism=M.PTRACE, virtualize=True,
                   fuel=FUEL, regs={19: 3})


def _rec_tuple(t):
    return (t.step, t.pc, t.nr, t.x0, t.x1, t.x2, t.ret, t.verdict)


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_stream")
    srv = _stream_server(JAX, d / "ref", d / "ref.jsonl")
    _stream_feed(JAX, srv)
    out = {r.rid: r for r in srv.run(5000)}
    return out, _sink_streams(d / "ref.jsonl"), srv.generation


@pytest.mark.parametrize("kill_gen", [1, 5, 13])
def test_stream_kill_replays_the_jax_record_streams(tmp_path, jax_stream,
                                                    kill_gen):
    """A streamed durable server killed at ``kill_gen``: the per-request
    record streams and the JSONL sink dedup to the JAX server's
    uninterrupted run, with 0 dropped."""
    ref_out, ref_sink, ref_gens = jax_stream
    assert ref_gens > 13
    vic = _stream_server(PORT, tmp_path / "vic", tmp_path / "vic.jsonl")
    _stream_feed(PORT, vic)
    pre = []
    for _ in range(kill_gen):
        pre.extend(vic.step())
    del vic
    srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
    union = _union(pre, replayed, srv.run(5000))
    assert set(union) == set(ref_out)
    for rid, r in ref_out.items():
        got = union[rid]
        assert [_rec_tuple(t) for t in got.trace] == \
            [_rec_tuple(t) for t in r.trace], rid
        assert got.trace_dropped == r.trace_dropped == 0
        assert got.histogram == r.histogram
        assert _result_key(got) == _result_key(r)
    assert srv.stats()["stream"]["records_dropped"] == 0
    assert _sink_streams(tmp_path / "vic.jsonl") == ref_sink


# -- guest-kernel state: fd tables survive a kill --------------------------

def _emul_feed(pkg, srv):
    B = pkg.D.BUILDERS
    srv.submit(B["emul-churn"], virtualize=True, regs={19: 3})
    srv.submit(B["emul-proc"], virtualize=True, regs={19: 2})
    srv.submit(B["emul-churn"], virtualize=True, regs={19: 2},
               cfg=pkg.HookConfig(emul_enabled=False, snapshot_interval=2,
                                  journal_fsync=False))


def _emul_server(pkg, directory=None):
    cfg = pkg.HookConfig(snapshot_interval=2, journal_fsync=False)
    dur = (pkg.D.DurabilityManager(directory) if directory is not None
           else None)
    return pkg.FleetServer(2, cfg=cfg, gen_steps=48, fuel=FUEL,
                           durability=dur, **pkg.kw)


def test_kill_recover_preserves_fd_tables(tmp_path):
    """tests/test_emul.py's fd-table case: killed mid-churn, the port
    recovers and drains to the JAX server's uninterrupted states, the
    guest kernel's carry (fd tables, inode data) included."""
    ref = _emul_server(JAX)
    _emul_feed(JAX, ref)
    ref_out = {r.rid: r for r in ref.run(5000)}
    vic = _emul_server(PORT, tmp_path / "vic")
    _emul_feed(PORT, vic)
    pre = [r for _ in range(3) for r in vic.step()]
    del vic
    srv, replayed = FleetServer.recover(tmp_path / "vic", device="cpu")
    union = _union(pre, replayed, srv.run(5000))
    assert set(union) == set(ref_out)
    for rid, r in ref_out.items():
        for f, a, b in zip(r.state._fields, r.state, union[rid].state):
            assert np.array_equal(np.asarray(a), b.numpy()), (rid, f)
    assert srv.stats()["emul_served_total"] > 0


# -- the durable keys of stats() and the journal gauges ------------------------

def test_stats_and_gauges_report_the_durable_counters(tmp_path):
    srv = FleetServer(2, cfg=HookConfig(snapshot_interval=2,
                                        journal_fsync=False,
                                        obs_enabled=True),
                      gen_steps=48, fuel=FUEL, device="cpu",
                      durability=D.DurabilityManager(tmp_path / "d"))
    srv.submit(programs.getpid_loop_param, regs={19: 3}, fuel=FUEL)
    srv.run(5000)
    st_ = srv.stats()
    assert st_["durability_enabled"] and not st_["chaos_enabled"]
    for k in ("retries", "rollbacks", "shed_requests", "snapshot_bytes",
              "recovery_generations", "watchdog_trips", "snapshots",
              "snapshot_rewrites", "journal_records"):
        assert isinstance(st_[k], int), k
    assert st_["snapshots"] >= 1 and st_["snapshot_bytes"] > 0
    assert st_["journal_records"] >= st_["generations"]
    g = srv.metrics()["gauges"]
    assert g["journal_records"]["_"] == st_["journal_records"]
    assert g["journal_bytes"]["_"] > 0
    phases = srv.metrics()["phases"]
    assert phases["journal_append"]["count"] >= srv.generation
    assert phases["snapshot_write"]["count"] >= 1
    plain = FleetServer(2, gen_steps=48, fuel=FUEL, device="cpu").stats()
    assert not plain["durability_enabled"] and plain["snapshots"] == 0


# -- imports ---------------------------------------------------------------

def test_durable_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys; import repro_torch.checkpoint, "
            "repro_torch.checkpoint.manager, repro_torch.serve.durability, "
            "repro_torch.serve.chaos, repro_torch.serve.fleet_server; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
