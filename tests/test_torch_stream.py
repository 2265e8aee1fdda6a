"""The port's streamed trace harvest against the JAX package, on the CPU.

Under test: :mod:`repro_torch.trace.stream` (``TraceStream``, its writers
and ``make_writer``) and the device side in :mod:`repro_torch.core.fleet`
(``flip_trace``, ``stream_interval``, ``run_fleet_stream``).  The same
pushes, carries and prepared processes (made from a seed with numpy) go
through both packages; the tolerance is exact: every ``MachineState`` and
``TraceState`` leaf, every streamed record with its key, epoch and
sequence number, and every counter of the sink.
"""
import hashlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trace as jtrace
from repro.core import Mechanism as JMechanism
from repro.core import fleet as jfleet
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms

from repro_torch import trace as ttrace
from repro_torch.core import (Mechanism, fleet, interop, pack_fleet, prepare,
                              programs, run_fleet)

ROOT = Path(__file__).resolve().parents[1]
FUEL = 150_000


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_stream", ROOT / "chip_smoke.py")


def _rec(r):
    return (r.step, r.pc, r.nr, r.x0, r.x1, r.x2, r.ret, r.verdict)


def _row(step, nr=172, ret=0):
    """One synthetic 8-word ring row."""
    return [step, 0x1000, nr, 0, 0, 0, ret, 0]


def _equal(want, got, what):
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


# -- TraceStream on the host: the behaviours of tests/test_stream.py ---------
# Each scenario drives one package's trace namespace and returns what it
# observed; the port's must equal the JAX package's.

def _lifetime_order(T, tmp):
    s = T.TraceStream()
    half = np.zeros((4, 8), np.int64)
    for i in range(3):
        half[i] = _row(step=i)
    s.push_lane("k", half, count=3, base=0)
    half2 = np.zeros((4, 8), np.int64)
    for i in range(2):
        half2[i] = _row(step=3 + i)
    s.push_lane("k", half2, count=5, base=3)
    recs, dropped = s.pop("k")
    return [_rec(r) for r in recs], dropped, s.keys(), s.stats()


def _wrap_drops(T, tmp):
    half = np.zeros((4, 8), np.int64)
    for step in range(6):  # 6 records through a cap-4 ring
        half[step % 4] = _row(step=step)
    s = T.TraceStream()
    s.push_lane("k", half, count=6, base=0)
    recs, dropped = s.pop("k")
    return [_rec(r) for r in recs], dropped, s.stats()


def _push_block_skips(T, tmp):
    s = T.TraceStream()
    bufs = np.zeros((3, 4, 8), np.int64)
    bufs[0, 0] = _row(step=0)
    bufs[2, 0] = _row(step=9)
    s.push_block(["a", None, None], bufs, counts=np.array([1, 0, 1]),
                 bases=np.array([0, 0, 0]))
    return s.keys(), s.stats()


def _reset_epochs(T, tmp):
    s = T.TraceStream()
    half = np.zeros((4, 8), np.int64)
    half[0] = _row(step=0)
    s.push_lane("k", half, count=1, base=0)
    s.reset("k")
    before = [_rec(r) for r in s.records("k")]
    half[0] = _row(step=7)
    s.push_lane("k", half, count=1, base=0)
    hwm = s.hwm_map()
    recs, dropped = s.pop("k")
    return before, [_rec(r) for r in recs], dropped, hwm


def _writers_exactly_once(T, tmp):
    seen = []
    mem = T.MemoryWriter()
    path = tmp / f"{T.__name__}.jsonl"
    s = T.TraceStream([mem, T.JSONLWriter(path),
                       T.CallbackWriter(lambda *a: seen.append(a))])
    half = np.zeros((4, 8), np.int64)
    half[0] = _row(step=0)
    half[1] = _row(step=1)
    s.push_lane("k", half, count=2, base=0)
    s.reset("k")                       # epoch 0 -> 1
    half[0] = _row(step=5)
    s.push_lane("k", half, count=1, base=0)
    s.flush()
    s.close()
    return ([(k, e, q, _rec(r)) for k, e, q, r in mem.records],
            [(k, e, q, _rec(r)) for k, e, q, r in seen],
            [json.loads(x) for x in path.read_text().splitlines()])


def _make_writer(T, tmp):
    w = T.make_writer(str(tmp / f"{T.__name__}.w.jsonl"))
    kinds = (T.make_writer(""), type(T.make_writer("memory")).__name__,
             type(w).__name__)
    w.close()
    return kinds


def _retain_false(T, tmp):
    mem = T.MemoryWriter()
    s = T.TraceStream([mem], retain=False)
    half = np.zeros((4, 8), np.int64)
    half[0] = _row(step=0)
    s.push_lane("k", half, count=1, base=0)
    stats = s.stats()
    recs, dropped = s.pop("k")
    return stats, len(mem.records), recs, dropped


def _segments_compact(T, tmp):
    s = T.TraceStream(max_segments=3)
    half = np.zeros((4, 8), np.int64)
    for i in range(10):
        half[0] = _row(step=i)
        s.push_lane("k", half, count=i + 1, base=i)
    n_segs = len(s._keys["k"].segs)
    recs, _ = s.pop("k")
    return n_segs, [_rec(r) for r in recs]


def _follow_and_durability(T, tmp):
    s = T.TraceStream([T.MemoryWriter()])
    s.enable_follow()
    half = np.zeros((4, 8), np.int64)
    for i in range(3):
        half[i] = _row(step=i, nr=63 + i)
    s.push_lane("a", half, count=3, base=0)
    follow = [(k, q, _rec(r)) for k, q, r in s.drain_follow()]
    exported = s.export_key("a")
    r = T.TraceStream([T.MemoryWriter()])
    r.prime({"a": [0, 2], "b": [1, 5]})
    r.restore_key("b", rows=exported["rows"], start=0, count=3, dropped=0,
                  hwm=1, epoch=1)
    r.push_lane("a", half, count=3, base=0)  # seq 0, 1 already emitted
    return (follow, {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in exported.items()},
            r.hwm_map(), [(k, e, q) for k, e, q, _ in r.writers[0].records],
            r.export_key("zzz"), r.stats())


SCENARIOS = [_lifetime_order, _wrap_drops, _push_block_skips, _reset_epochs,
             _writers_exactly_once, _make_writer, _retain_false,
             _segments_compact, _follow_and_durability]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_trace_stream_matches_jax(scenario, tmp_path):
    want = scenario(jtrace, tmp_path)
    got = scenario(ttrace, tmp_path)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_stream_random_pushes_match_jax(seed):
    """Seeded random blocks (empty lanes, unkeyed lanes, halves that wrap
    past cap) through push_block, resets and pops in both packages; the
    port also takes the blocks as tensors."""
    rng = np.random.default_rng(seed)
    B, cap = 6, 5
    js = jtrace.TraceStream(max_segments=4)
    ts = ttrace.TraceStream(max_segments=4)
    counts = np.zeros(B, np.int64)
    keys = [f"lane{b}" if b != 3 else None for b in range(B)]
    for it in range(12):
        bases = counts.copy()
        counts = counts + rng.integers(0, 2 * cap, B)
        bufs = rng.integers(-5, 1 << 40, (B, cap, 8))
        js.push_block(keys, bufs, counts, bases)
        ts.push_block(keys, torch.from_numpy(bufs) if it % 2 else bufs,
                      torch.from_numpy(counts), bases)
        if it == 7:
            js.reset("lane1")
            ts.reset("lane1")
    assert ts.stats() == js.stats()
    assert ts.records_dropped > 0
    for k in keys[:3] + keys[4:]:
        assert ts.dropped(k) == js.dropped(k)
        a, b = js.pop(k), ts.pop(k)
        assert ([_rec(r) for r in b[0]], b[1]) == \
            ([_rec(r) for r in a[0]], a[1])


def test_stream_interval_matches_jax():
    for cap in range(1, 70, 3):
        for chunk in range(1, 140, 7):
            assert (ttrace.stream_interval(cap, chunk)
                    == jtrace.stream_interval(cap, chunk)), (cap, chunk)
    assert ttrace.stream_interval(64, 128) == 128  # one chunk past cap


@pytest.mark.parametrize("seed", [0, 1])
def test_flip_trace_matches_jax(seed):
    """A scrambled carry (``count < base`` included): the flipped carry,
    the cold halves and the host counters equal the JAX package's; the
    port flips in place and ``base`` keeps a buffer of its own."""
    rng = np.random.default_rng(seed)
    B, cap = 7, 6
    leaves = SMOKE.scramble_trace(B, cap, rng,
                                  SMOKE.random_policies(B, rng))
    leaves["hot"] = rng.integers(0, 2, B).astype(np.int64)
    jtr = jfleet.TraceState(*(jnp.asarray(leaves[f])
                              for f in jfleet.TraceState._fields))
    want = jfleet.flip_trace(jtr)
    tr = interop.trace_from_numpy(leaves)
    got = fleet.flip_trace(tr)
    _equal(want[0], got[0], "flipped carry")
    assert got[0].hot is tr.hot and got[0].base is tr.base
    assert tr.base.data_ptr() != tr.count.data_ptr()
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    for a, b in zip(want[2:], got[2:]):
        assert np.array_equal(a, b)
    tr.count.add_(1)  # the next span's appends leave base behind
    assert np.array_equal(tr.base.numpy(), np.asarray(want[0].base))


# -- run_fleet_stream: port against JAX --------------------------------------

def _processes(pkg):
    """Five mechanisms x getpid / read loops plus two guest-kernel lanes
    (file churn), with seeded iteration counts."""
    P = programs if pkg == "torch" else jprograms
    M = Mechanism if pkg == "torch" else JMechanism
    prep = prepare if pkg == "torch" else jprepare
    work = [P.getpid_loop_param, lambda: P.read_loop_param(256)]
    pps = [prep(w(), m, virtualize=m is not M.NONE) for m in M for w in work]
    pps += [prep(P.file_churn_param(64), m, virtualize=True)
            for m in (M.ASC, M.LD_PRELOAD)]
    regs = [{19: int(n)} for n in
            np.random.default_rng(11).integers(1, 5, len(pps))]
    return pps, regs


@pytest.fixture(scope="module")
def processes():
    return _processes("jax"), _processes("torch")


def _streamed(processes, *, chunk, cap, keys=None):
    """Both packages' streamed runs from the same packed fleet, with a
    MemoryWriter each."""
    (jpps, regs), (tpps, _) = processes
    ji, jd, js, _ = jpack_fleet(jpps, fuel=FUEL, regs=regs, trace=True)
    jsink = jtrace.TraceStream([jtrace.MemoryWriter()])
    want = jfleet.run_fleet_stream(
        ji, js, jd, chunk=chunk, trace=jtrace.make_trace_state(len(jpps), cap),
        stream=jsink, keys=keys)
    ti, td, ts, _ = pack_fleet(tpps, fuel=FUEL, regs=regs, trace=True,
                               device="cpu")
    tsink = ttrace.TraceStream([ttrace.MemoryWriter()])
    got = fleet.run_fleet_stream(
        ti, ts, td, chunk=chunk,
        trace=ttrace.make_trace_state(len(tpps), cap, device="cpu"),
        stream=tsink, keys=keys, device="cpu")
    return want, jsink, got, tsink, (ti, td, regs, tpps)


def _written(sink):
    return [(k, e, q, _rec(r)) for k, e, q, r in sink.writers[0].records]


def test_run_fleet_stream_matches_jax(processes):
    """cap 8, chunk 4 (flips every 8 steps): the states, the carries, every
    streamed record with its key, epoch and seq, and the sink's counts;
    no drops, and the stream holds exactly what a ring too large to wrap
    records."""
    keys = [f"p{i}" for i in range(len(processes[1][0]))]
    want, jsink, got, tsink, (ti, td, regs, tpps) = _streamed(
        processes, chunk=4, cap=8, keys=keys)
    _equal(want[0], got[0], "streamed states")
    _equal(want[1], got[1], "streamed carry")
    assert _written(tsink) == _written(jsink) and _written(tsink)
    assert tsink.stats() == jsink.stats()
    assert tsink.records_dropped == 0
    assert tsink.flips == jsink.flips > 10
    _, _, s, _ = pack_fleet(tpps, fuel=FUEL, regs=regs, trace=True,
                            device="cpu")
    plain, big = run_fleet(ti, s, td, chunk=4, device="cpu",
                           trace=ttrace.make_trace_state(len(tpps), 512,
                                                         device="cpu"))
    _equal(plain, got[0], "unstreamed states")
    for i, key in enumerate(keys):
        truth, dropped = ttrace.harvest_lane(big.buf[i], int(big.count[i]))
        assert dropped == 0
        assert [_rec(r) for r in tsink.records(key)] == \
            [_rec(r) for r in truth]


def test_stream_drops_when_chunk_exceeds_cap(processes):
    """chunk 32 over cap 2: a flip cannot land inside a chunk, halves
    wrap, and both packages count the same drops, lane by lane."""
    want, jsink, got, tsink, _ = _streamed(processes, chunk=32, cap=2)
    _equal(want[0], got[0], "states")
    _equal(want[1], got[1], "carry")
    assert tsink.stats() == jsink.stats()
    assert tsink.records_dropped > 0
    for k in jsink.keys():
        assert tsink.dropped(k) == jsink.dropped(k)
        assert [_rec(r) for r in tsink.records(k)] == \
            [_rec(r) for r in jsink.records(k)]
    assert _written(tsink) == _written(jsink)


# The JAX package's streamed census (chunk 128, cap 64, a retaining
# TraceStream), from scripts/torch_port_pins.py (minutes on the CPU, so
# tier-1 copies the numbers): records received, dropped, flips, and the
# sha256 of every streamed record (chip_smoke.stream_digest).
STREAMED_JAX = {"records_seen": 263_036, "records_dropped": 0, "flips": 65}
STREAMED_SHA256 = (
    "f9fbf1382a101793696a5e5794353fd6e07aff48318df9b8fc44a2ecea67d5b1")


def test_chip_smoke_stream_pins_match_jax_records():
    """chip_smoke.py holds the streamed census to the JAX package's
    numbers; with zero drops the stream sees every record of the traced
    census."""
    assert SMOKE.STREAMED_EXPECTED == STREAMED_JAX
    assert SMOKE.STREAMED_SHA256 == STREAMED_SHA256
    assert STREAMED_JAX["records_seen"] == \
        SMOKE.TRACED_EXPECTED["records_total"]


def test_stream_digest_orders_keys_then_seq():
    """stream_digest hashes each key's rows in sequence order, keys in
    order, and skips keys the stream never saw."""
    s = ttrace.TraceStream()
    rows = np.arange(3 * 8, dtype=np.int64).reshape(3, 8)
    s.push_lane(2, rows[:2], count=2, base=0)
    s.push_lane(0, rows[2:], count=1, base=0)
    h = hashlib.sha256(
        np.concatenate([rows[2:], rows[:2]]).tobytes()).hexdigest()
    assert SMOKE.stream_digest(s, 3) == h
