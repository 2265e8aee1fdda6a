"""Host-side streaming trace sink: the consumer half of the zero-drop
pipeline (PyTorch port of ``repro.trace.stream``; host code only, the
same as the JAX package's).

The device side (:func:`repro_torch.core.fleet.flip_trace` and
:func:`repro_torch.core.fleet.run_fleet_stream`) flips each lane's
double-buffered ring at span boundaries and ships the cold half to the
host while the hot half keeps filling.  This module owns everything after
that device->host copy:

* **vectorised decode** of a cold-half block — one numpy gather + one bulk
  ``tolist`` per flip, never a per-word ``int()`` loop;
* **per-key reassembly** into lifetime-ordered records (``key`` is a lane
  index for raw fleet runs, a request id under the JAX package's
  ``FleetServer``), with an exact per-key
  dropped count when a half wrapped between flips (only possible when the
  flip interval exceeds the ring capacity — never silent);
* **pluggable writers** fed in emission order: in-memory, JSONL file,
  callback (:func:`make_writer` maps the ``HookConfig.trace_sink`` knob);
* an **emission high-water mark** per key, journaled by the durable server
  so crash recovery re-generates records without re-emitting the ones a
  writer already saw (no duplicate) while the replayed buffers still
  assemble complete result traces (no hole);
* a drain cursor for ``FleetServer.follow()``'s live strace view.

The pending buffer is bounded by construction, not by dropping: each key
holds at most its un-published records (a request's lifetime trace until
harvest publishes and ``pop``s it), segment lists are compacted in place
past ``max_segments``, and with ``retain=False`` raw rows are released the
moment every writer has consumed them — the census-scale configuration.
"""
from __future__ import annotations

import collections
import json
import pathlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.fleet import REC_WORDS
from .recorder import TraceRecord, _host, decode_rows

__all__ = ["TraceStream", "MemoryWriter", "JSONLWriter", "CallbackWriter",
           "make_writer"]


class MemoryWriter:
    """Collects every emitted record as ``(key, epoch, seq, record)``."""

    def __init__(self) -> None:
        self.records: List[Tuple[object, int, int, TraceRecord]] = []

    def write(self, key, epoch: int, seq: int, rec: TraceRecord) -> None:
        self.records.append((key, epoch, seq, rec))

    def close(self) -> None:
        pass


class JSONLWriter:
    """Appends one JSON object per record.  Append-mode on purpose: a
    recovered server keeps writing the same file, and the journaled
    high-water mark keeps replay from re-emitting — the file is
    at-least-once by line, exactly-once by ``(key, epoch, seq)``, the
    dedup key crash-tolerant readers should use."""

    def __init__(self, path) -> None:
        self.path = pathlib.Path(path)
        self._f = open(self.path, "a", encoding="utf-8")

    def write(self, key, epoch: int, seq: int, rec: TraceRecord) -> None:
        self._f.write(json.dumps({
            "key": key, "epoch": epoch, "seq": seq, "step": rec.step,
            "pc": rec.pc, "nr": rec.nr, "x0": rec.x0, "x1": rec.x1,
            "x2": rec.x2, "ret": rec.ret, "verdict": rec.verdict,
        }) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CallbackWriter:
    """Adapts ``fn(key, epoch, seq, record)`` to the writer interface."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn

    def write(self, key, epoch: int, seq: int, rec: TraceRecord) -> None:
        self.fn(key, epoch, seq, rec)

    def close(self) -> None:
        pass


def make_writer(spec: str):
    """Map the ``HookConfig.trace_sink`` knob to a writer: ``""`` -> no
    writer (in-memory reassembly only), ``"memory"`` -> a
    :class:`MemoryWriter`, anything else -> a :class:`JSONLWriter` on that
    path."""
    if not spec:
        return None
    if spec == "memory":
        return MemoryWriter()
    return JSONLWriter(spec)


class _KeyState:
    __slots__ = ("segs", "start", "count", "dropped", "hwm", "epoch")

    def __init__(self) -> None:
        self.segs: List[np.ndarray] = []  # raw [n, REC_WORDS] blocks
        self.start = 0      # lifetime seq of segs[0][0]
        self.count = 0      # lifetime records produced (incl. dropped)
        self.dropped = 0
        self.hwm = 0        # first seq NOT yet emitted to writers
        self.epoch = 0      # bumped by reset() (C3 re-admission)


class TraceStream:
    """Bounded, ordered, write-behind sink for streamed trace halves."""

    def __init__(self, writers: Iterable = (), *, retain: bool = True,
                 max_segments: int = 64) -> None:
        self.writers = [w for w in writers if w is not None]
        self.retain = retain
        self.max_segments = max(1, int(max_segments))
        self._keys: Dict[object, _KeyState] = {}
        self.records_seen = 0
        self.records_emitted = 0
        self.records_dropped = 0
        self.flips = 0
        self._follow_on = False
        self._followq: collections.deque = collections.deque()

    # -- producer side -------------------------------------------------------

    def push_block(self, keys, bufs, counts, bases) -> None:
        """Ingest one flipped cold-half block: ``bufs`` int64[B, CAP,
        REC_WORDS] (a tensor or an ndarray — converted here), ``counts`` /
        ``bases`` the pre-flip lifetime counters.  Lane ``i``'s rows carry
        lifetime sequence numbers ``[bases[i], counts[i])``."""
        bufs = _host(bufs)
        counts = _host(counts)
        bases = _host(bases)
        self.flips += 1
        n = counts - bases
        for i in np.flatnonzero(n > 0):
            i = int(i)
            if keys[i] is None:
                continue
            self.push_lane(keys[i], bufs[i], int(counts[i]), int(bases[i]))

    def push_lane(self, key, half, count: int, base: int) -> None:
        """Ingest one lane's half (int64[CAP, REC_WORDS]) holding records
        ``[base, count)`` — also the final-residual entry point a server
        uses at harvest time."""
        n = int(count) - int(base)
        if n <= 0:
            return
        half = _host(half)
        cap = half.shape[0]
        dropped = max(0, n - cap)
        if dropped:
            start = n % cap
            rows = half[(start + np.arange(cap)) % cap]
        else:
            rows = np.array(half[:n])  # copy: drop the [B,CAP,..] backing
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyState()
        if not st.segs:
            st.start = int(base) + dropped
        st.count = int(count)
        st.dropped += dropped
        self.records_seen += len(rows)
        self.records_dropped += dropped
        self._emit(key, st, int(base) + dropped, rows)
        if self.retain:
            st.segs.append(rows)
            if len(st.segs) > self.max_segments:
                st.segs = [np.concatenate(st.segs)]
        else:
            st.start = st.count  # nothing buffered

    def _emit(self, key, st: _KeyState, start_seq: int,
              rows: np.ndarray) -> None:
        skip = st.hwm - start_seq
        if skip >= len(rows):
            return
        if skip > 0:
            rows = rows[skip:]
            start_seq += skip
        if self.writers or self._follow_on:
            for j, rec in enumerate(decode_rows(rows)):
                for w in self.writers:
                    w.write(key, st.epoch, start_seq + j, rec)
                if self._follow_on:
                    self._followq.append((key, start_seq + j, rec))
        self.records_emitted += len(rows)
        st.hwm = start_seq + len(rows)

    def reset(self, key) -> None:
        """Discard a key's buffered records and restart its sequence space
        under a new epoch — the C3 diagnose->re-admit path, where the
        published trace must hold only the final attempt's records."""
        st = self._keys.get(key)
        if st is None:
            return
        epoch = st.epoch + 1
        self._keys[key] = st = _KeyState()
        st.epoch = epoch

    def pop(self, key) -> Tuple[List[TraceRecord], int]:
        """Publish a key: its lifetime-ordered records plus the exact
        dropped count, releasing the buffered rows."""
        st = self._keys.pop(key, None)
        if st is None:
            return [], 0
        rows = np.concatenate(st.segs) if st.segs else \
            np.empty((0, REC_WORDS), np.int64)
        return decode_rows(rows), st.dropped

    # -- consumer side -------------------------------------------------------

    def records(self, key) -> List[TraceRecord]:
        st = self._keys.get(key)
        if st is None or not st.segs:
            return []
        return decode_rows(np.concatenate(st.segs))

    def dropped(self, key) -> int:
        st = self._keys.get(key)
        return st.dropped if st else 0

    def keys(self) -> List:
        return list(self._keys)

    def stats(self) -> dict:
        return {
            "records_seen": self.records_seen,
            "records_emitted": self.records_emitted,
            "records_dropped": self.records_dropped,
            "flips": self.flips,
            "keys": len(self._keys),
            "buffered_records": sum(
                sum(len(s) for s in st.segs) for st in self._keys.values()),
        }

    def flush(self) -> None:
        for w in self.writers:
            if hasattr(w, "flush"):
                w.flush()

    def close(self) -> None:
        for w in self.writers:
            w.close()

    # -- follow mode ---------------------------------------------------------

    def enable_follow(self) -> None:
        self._follow_on = True

    def drain_follow(self) -> List[Tuple[object, int, TraceRecord]]:
        """Records emitted since the last drain, as ``(key, seq, record)``
        in emission order — the feed behind ``FleetServer.follow()``."""
        out = list(self._followq)
        self._followq.clear()
        return out

    # -- durability ----------------------------------------------------------

    def hwm_map(self) -> Dict[object, List[int]]:
        """``{key: [epoch, hwm]}`` for live keys — what the durable server
        journals after each generation's drain."""
        return {k: [st.epoch, st.hwm] for k, st in self._keys.items()}

    def prime(self, hwm_map: Dict) -> None:
        """Raise emission watermarks before a journal replay so recovered
        writers never see a record twice.  Keys are created on demand (the
        replay will re-buffer their rows for result assembly)."""
        for key, (epoch, hwm) in hwm_map.items():
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
                st.start = st.count = hwm
            if (epoch, hwm) >= (st.epoch, st.hwm):
                st.epoch, st.hwm = int(epoch), int(hwm)

    def export_key(self, key) -> Optional[dict]:
        """Snapshot one key's full state (buffered rows + counters) for
        the durable server's snapshot arrays."""
        st = self._keys.get(key)
        if st is None:
            return None
        rows = np.concatenate(st.segs) if st.segs else \
            np.empty((0, REC_WORDS), np.int64)
        return {"rows": rows, "start": st.start, "count": st.count,
                "dropped": st.dropped, "hwm": st.hwm, "epoch": st.epoch}

    def restore_key(self, key, *, rows, start: int, count: int,
                    dropped: int, hwm: int, epoch: int) -> None:
        st = self._keys[key] = _KeyState()
        rows = np.asarray(rows, np.int64).reshape(-1, REC_WORDS)
        if len(rows):
            st.segs = [rows]
        st.start = int(start)
        st.count = int(count)
        st.dropped = int(dropped)
        st.hwm = int(hwm)
        st.epoch = int(epoch)
