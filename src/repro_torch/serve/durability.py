"""Durable serving: write-ahead journal + fleet snapshots + recovery
(PyTorch port of the JAX package's ``repro.serve.durability``).

The serving-side analogue of the paper's completeness posture: a
:class:`~repro_torch.serve.fleet_server.FleetServer` that can lose its
process, a generation's launches, or a corrupted carry and still drain to
results **bit-identical** to the uninterrupted run.  Three pieces:

* **Write-ahead journal** (``<dir>/journal.jsonl``).  One JSON record per
  line, each prefixed with its own crc32, appended *before* the effect it
  describes becomes observable and fsync'd at the commit points (every
  ``submit`` when ``cfg.journal_fsync``, and once per generation).  A
  torn tail — a crash mid-write — fails its line crc and replay simply
  stops there: the journal is always a consistent prefix.  Record kinds:
  ``open`` (server construction parameters), ``submit`` (full request
  metadata incl. compiled policy rows and the image digest), ``gen``
  (published rids per generation, or ``skipped`` for a load-shed one),
  ``update_policy``, ``shed``, ``snapshot``/``rollback``/``recover``
  (informational).

* **Fleet snapshots** (``<dir>/snapshots/step_*``, every
  ``cfg.snapshot_interval`` generations).  The WHOLE server: live device
  carry via :func:`repro_torch.core.fleet.pack_carry` (sparse memory
  plane, its nonzeros found on the card),
  parked per-request checkpoints, host mirrors, image-table
  refcounts/free-list, scheduler ledger + quarantine, tenant stats and
  every counter — written through :class:`CheckpointManager`'s
  tmp-then-rename atomic core with keep-k GC, plus a full-coverage
  :func:`repro_torch.core.fleet.carry_digest` crc in the manifest.  Images
  themselves live once in a content-addressed store
  (``<dir>/images/<sha1>.npz`` — words + packed decode tables, so
  recovery never pays the 65536-iteration host decode).

* **Recovery** (:func:`recover` / ``FleetServer.recover``).  Restore the
  newest *valid* snapshot (corrupt steps are skipped — the
  ``CheckpointManager.restore_latest`` fallback), rebuild the server and
  its requests (builders resolve via :func:`register_builder` or an
  importable ``module:qualname``; builder-less requests rehydrate from
  the image store), then replay the journal tail: submits re-enter the
  queue, ``gen`` records re-run :meth:`FleetServer.step` — every
  generation is deterministic, so the replayed results are bit-identical
  to what the dead server published — and sheds / policy updates re-apply
  as recorded.  Publication is at-least-once: a crash between a dispatch
  and its ``gen`` record re-executes that generation; clients dedup by
  ``rid``.

The same machinery powers the chaos harness's rollback: with carry
bit-flip injection enabled, every snapshot boundary recovers a *replica*
from disk, compares full-coverage carry digests, and on mismatch adopts
the replica (replayed truth), re-emits the corrected window and escalates
the corrupted lanes' tenants into ``sched.quarantine``.

The files are the JAX package's: for the same requests the journal
records (the wall-clock fields ``wait_s``, ``parked_wait_s`` and
``obs_wm`` aside) and every snapshot's arrays and manifest hash are
equal, and a directory the JAX server wrote recovers here.  Builder refs
of the ``imp:`` kind name this package's modules, so they differ from
the JAX server's by design; ``reg:`` refs and image digests are equal.
The carry lives on the server's device and changes in place: recovery
and rollback put fresh tensors there, and nothing a snapshot keeps on the
host is a view of the carry.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import pathlib
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core import fleet as F
from ..core.completeness import C3Event
from ..core.hookcfg import HookConfig, PolicyRule
from ..core.runtime import (Mechanism, PreparedProcess, _image_digest,
                            prepare)
from ..obs import now as obs_now
from ..obs import phase as obs_phase
from ..sched.budgets import TenantBudget, TenantUsage
from ..sched.quarantine import Quarantine
from ..sched.scheduler import PolicyScheduler

log = logging.getLogger(__name__)


class RecoveryError(RuntimeError):
    """A journal/snapshot inconsistency recovery cannot reconcile."""


# ---------------------------------------------------------------------------
# the write-ahead journal
# ---------------------------------------------------------------------------

class Journal:
    """Append-only crc-framed JSONL journal with a consistent-prefix
    guarantee: every line is ``<crc32 of payload, %08x> <payload json>``,
    so replay can tell a torn tail from a valid record without trusting
    file length or flush ordering."""

    def __init__(self, path: str | pathlib.Path, *, fsync: bool = True,
                 next_seq: int = 0, truncate_at: Optional[int] = None):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if truncate_at is not None and self.path.exists():
            size = self.path.stat().st_size
            if truncate_at < size:  # drop a torn tail before appending
                log.warning("journal %s: truncating torn tail (%d -> %d bytes)",
                            self.path, size, truncate_at)
                with open(self.path, "r+b") as f:
                    f.truncate(truncate_at)
        self._f = open(self.path, "ab")
        self.fsync = bool(fsync)
        self.seq = next_seq          # seq of the NEXT record
        self.last_seq = next_seq - 1
        self.records = 0             # records appended by this handle
        self.bytes_written = self.path.stat().st_size   # incl. prior life
        self._dirty = False

    def append(self, kind: str, **fields) -> int:
        rec = {"seq": self.seq, "kind": kind, **fields}
        payload = json.dumps(rec, separators=(",", ":"))
        line = f"{zlib.crc32(payload.encode()):08x} {payload}\n"
        self._f.write(line.encode())
        self._f.flush()              # into the OS; fsync only at commit
        self.last_seq = self.seq
        self.seq += 1
        self.records += 1
        self.bytes_written += len(line)
        self._dirty = True
        return self.last_seq

    def commit(self) -> None:
        """Make everything appended so far durable (fsync)."""
        if self._dirty and self.fsync:
            import os
            os.fsync(self._f.fileno())
        self._dirty = False

    def close(self) -> None:
        self.commit()
        self._f.close()

    @staticmethod
    def replay(path: str | pathlib.Path) -> Tuple[List[dict], int]:
        """Read back the valid prefix: ``(records, good_bytes)``.  Stops at
        the first line that fails its crc or does not parse (a torn tail);
        ``good_bytes`` is where a re-opened journal must truncate to before
        appending, or later records would hide behind the bad line."""
        p = pathlib.Path(path)
        records: List[dict] = []
        good = 0
        if not p.exists():
            return records, good
        data = p.read_bytes()
        for raw in data.split(b"\n"):
            if not raw:
                good += 1  # the newline after a valid line (or empty tail)
                continue
            try:
                crc_hex, payload = raw.split(b" ", 1)
                if int(crc_hex, 16) != zlib.crc32(payload):
                    break
                rec = json.loads(payload)
            except Exception:
                break
            records.append(rec)
            good += len(raw) + 1
        good = min(good, len(data))
        if good < len(data):
            log.warning("journal %s: dropping torn tail (%d of %d bytes valid,"
                        " %d records)", p, good, len(data), len(records))
        return records, good


# ---------------------------------------------------------------------------
# the content-addressed image store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _StoredImage:
    """The minimal duck-typed ``Image`` a rehydrated request needs: raw
    words for digesting + ``word_at``.  Section/symbol metadata does not
    survive a crash — which is fine, because builder-less requests never
    reach C3 diagnosis (the server guards on ``req.builder is not None``)."""

    words: np.ndarray  # uint32[CODE_WORDS]

    def word_at(self, addr: int) -> int:
        return int(self.words[addr // 4])

    def section_of(self, addr: int):
        return None


class ImageStore:
    """``<dir>/<sha1hex>.npz`` per distinct image: the raw words plus the
    packed decode tables, so recovery rebuilds ``pp.decoded`` with one
    vectorised :func:`repro_torch.core.fleet.unpack_images` instead of the
    per-word host decode.  The files are the JAX package's."""

    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, digest: str) -> pathlib.Path:
        return self.dir / f"{digest}.npz"

    def put(self, pp: PreparedProcess,
            digest: Optional[str] = None) -> str:
        if digest is None:
            digest = _image_digest(pp).hex()
        path = self._path(digest)
        if path.exists():
            return digest
        packed = F.pack_images(F.stack_images([pp.decoded]))
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, words=np.asarray(pp.image.words),
                 packed=packed.packed[0].cpu().numpy(),
                 imm=packed.imm[0].cpu().numpy())
        tmp.replace(path)
        return digest

    def load_pp(self, digest: str, *, entry: int, sig_handler: int,
                mechanism: Mechanism, virtualize: bool,
                cfg: Optional[HookConfig]) -> PreparedProcess:
        path = self._path(digest)
        if not path.exists():
            raise RecoveryError(
                f"image {digest} not in store {self.dir} and no builder to "
                f"re-prepare it")
        with np.load(path) as z:
            words = z["words"]
            fi = F.FleetImages(packed=torch.from_numpy(z["packed"][None]),
                               imm=torch.from_numpy(z["imm"][None]))
        got = __import__("hashlib").sha1(
            np.ascontiguousarray(words).tobytes()).hexdigest()
        if got != digest:
            raise RecoveryError(f"image store entry {digest} is corrupt "
                                f"(content hashes to {got})")
        dec = F.unpack_images(fi)
        decoded = type(dec)(*[leaf[0] for leaf in dec])
        return PreparedProcess(
            image=_StoredImage(words=words), decoded=decoded, entry=entry,
            sig_handler=sig_handler, mechanism=mechanism, report=None,
            virtualize=virtualize, cfg=cfg)


# ---------------------------------------------------------------------------
# builder (de)serialisation
# ---------------------------------------------------------------------------

BUILDERS: Dict[str, Callable] = {}


def register_builder(name: str, fn: Callable) -> Callable:
    """Register a program builder under a stable name so a journaled
    request can resolve it again after a restart (the durable analogue of
    passing a builder to ``submit``).  Returns ``fn`` for decorator use."""
    BUILDERS[name] = fn
    return fn


def builder_ref(fn: Optional[Callable]) -> Optional[str]:
    """A journal-storable reference to ``fn``: ``reg:<name>`` for
    registered builders, ``imp:<module>:<qualname>`` for module-level
    callables that import back to the same object, else None
    (unserialisable — e.g. a closure)."""
    if fn is None:
        return None
    for name, g in BUILDERS.items():
        if g is fn:
            return f"reg:{name}"
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if mod and qual and "<" not in qual and "." not in qual:
        try:
            if getattr(importlib.import_module(mod), qual, None) is fn:
                return f"imp:{mod}:{qual}"
        except Exception:
            return None
    return None


def resolve_builder(ref: Optional[str],
                    builders: Optional[Dict[str, Callable]] = None
                    ) -> Optional[Callable]:
    if ref is None:
        return None
    kind, _, rest = ref.partition(":")
    if kind == "reg":
        fn = (builders or {}).get(rest) or BUILDERS.get(rest)
        if fn is None:
            raise RecoveryError(
                f"builder {ref!r} is not registered; register_builder"
                f"({rest!r}, fn) before recover()")
        return fn
    if kind == "imp":
        mod, _, qual = rest.partition(":")
        fn = getattr(importlib.import_module(mod), qual, None)
        if fn is None:
            raise RecoveryError(f"builder {ref!r} does not import")
        return fn
    raise RecoveryError(f"unknown builder ref {ref!r}")


# ---------------------------------------------------------------------------
# request (de)serialisation
# ---------------------------------------------------------------------------

def request_meta(req, digest_memo: Optional[Dict[int, str]] = None) -> dict:
    """A :class:`FleetRequest` as a JSON-ready dict (both the ``submit``
    journal record and the per-request snapshot metadata — runtime fields
    like ``slot``/``row``/``attempts`` just reflect their current
    values).  ``digest_memo`` (keyed by ``id(pp)``) dedups the sha1 work
    across the many requests of one snapshot that share a prepared
    image; it must not outlive the call batch (images are mutable — C3
    pins patch them in place)."""
    if digest_memo is None:
        digest = _image_digest(req.pp).hex()
    else:
        digest = digest_memo.get(id(req.pp))
        if digest is None:
            digest = digest_memo[id(req.pp)] = _image_digest(req.pp).hex()
    return {
        "rid": req.rid,
        "digest": digest,
        "entry": int(req.pp.entry),
        "sig_handler": int(req.pp.sig_handler),
        "builder": builder_ref(req.builder),
        "cfg": req.cfg.to_dict(),
        "mechanism": req.mechanism.name,
        "virtualize": bool(req.virtualize),
        "fuel": int(req.fuel),
        "regs": ({str(k): int(v) for k, v in req.regs.items()}
                 if req.regs else None),
        "submitted_gen": req.submitted_gen,
        "admitted_gen": req.admitted_gen,
        "wait_s": (req.admitted_s - req.submitted_s
                   if req.admitted_gen >= 0 else 0.0),
        "slot": req.slot, "row": req.row, "attempts": req.attempts,
        "events": [dataclasses.asdict(e) for e in req.events],
        "policy": ([np.asarray(req.policy[0]).tolist(),
                    np.asarray(req.policy[1]).tolist()]
                   if req.policy is not None else None),
        "tenant": req.tenant, "priority": req.priority,
        "deadline_steps": req.deadline_steps,
        "preemptions": req.preemptions,
        "parked_gen": req.parked_gen,
        "parked_wait_s": (obs_now() - req.parked_s
                          if req.parked_gen >= 0 else 0.0),
        "has_checkpoint": req.checkpoint is not None,
        "charged": [req.charged_svc, req.charged_deny, req.charged_emul,
                    req.charged_kill],
    }


def request_from_meta(meta: dict, *, store: ImageStore,
                      builders: Optional[Dict[str, Callable]],
                      cache: Dict[tuple, PreparedProcess],
                      digest_pp: Optional[Dict[str, PreparedProcess]] = None):
    """Rebuild a :class:`FleetRequest` (checkpoint carries are re-attached
    by the snapshot restore, not here).  Builder-backed requests re-run
    :func:`prepare` under the journaled config — pins included, so a
    C3-mutated image reproduces bit-exactly (verified against the recorded
    digest); builder-less ones rehydrate from the image store."""
    from .fleet_server import FleetRequest
    cfg = HookConfig.from_dict(meta["cfg"])
    mech = Mechanism[meta["mechanism"]]
    virt = bool(meta["virtualize"])
    fn = resolve_builder(meta.get("builder"), builders)
    # the config is part of the key: requests sharing one image may still
    # prepare under different configs (e.g. emul_enabled), and pp.cfg
    # feeds the lane's initial state
    key = (meta["digest"], meta["entry"], meta["sig_handler"],
           meta["mechanism"], virt, json.dumps(meta["cfg"], sort_keys=True))
    pp = cache.get(key)
    if pp is None:
        if fn is not None:
            pp = prepare(fn(), mech, virtualize=virt, cfg=cfg)
            got = _image_digest(pp).hex()
            if got != meta["digest"]:
                raise RecoveryError(
                    f"request {meta['rid']}: builder {meta['builder']!r} "
                    f"re-prepared to image {got}, journal recorded "
                    f"{meta['digest']} — builders must be deterministic")
        else:
            pp = store.load_pp(meta["digest"], entry=meta["entry"],
                               sig_handler=meta["sig_handler"],
                               mechanism=mech, virtualize=virt, cfg=cfg)
        cache[key] = pp
    if digest_pp is not None:
        digest_pp[meta["digest"]] = pp
    now = obs_now()
    req = FleetRequest(
        rid=meta["rid"], pp=pp, builder=fn, cfg=cfg, mechanism=mech,
        virtualize=virt, fuel=int(meta["fuel"]),
        regs=({int(k): int(v) for k, v in meta["regs"].items()}
              if meta["regs"] else None),
        submitted_gen=meta["submitted_gen"],
        submitted_s=now - meta.get("wait_s", 0.0),
        admitted_gen=meta["admitted_gen"],
        admitted_s=(now if meta["admitted_gen"] >= 0 else 0.0),
        slot=meta["slot"], row=meta["row"], attempts=meta["attempts"],
        events=[C3Event(**e) for e in meta["events"]],
        policy=(None if meta["policy"] is None else
                (np.asarray(meta["policy"][0], np.int32),
                 np.asarray(meta["policy"][1], np.int64))),
        tenant=meta["tenant"], priority=meta["priority"],
        deadline_steps=meta["deadline_steps"])
    req.preemptions = meta["preemptions"]
    if meta.get("parked_gen", -1) >= 0:   # re-base like submitted_s above
        req.parked_gen = int(meta["parked_gen"])
        req.parked_s = now - meta.get("parked_wait_s", 0.0)
    (req.charged_svc, req.charged_deny,
     req.charged_emul, req.charged_kill) = meta["charged"]
    return req


# ---------------------------------------------------------------------------
# whole-server snapshot / restore
# ---------------------------------------------------------------------------

_COUNTERS = (
    "generation", "dispatches", "completed", "c3_readmissions",
    "scalar_reexecutions", "harvested_steps", "discarded_steps",
    "enosys_total", "trace_records", "trace_dropped", "preemptions",
    "evictions", "policy_updates", "quarantine_blocks", "idle_generations",
    "dispatched_steps", "executed_steps", "pool_grows", "pool_shrinks",
    "min_bucket_seen", "retries", "rollbacks", "shed_requests",
    "recovery_generations", "watchdog_trips")


def _sched_meta(sched: Optional[PolicyScheduler]) -> Optional[dict]:
    if sched is None:
        return None
    q = sched.quarantine
    return {
        "preempt": sched.preempt,
        "budgets": {t: dataclasses.asdict(b)
                    for t, b in sched.ledger.budgets.items()},
        "default": dataclasses.asdict(sched.ledger.default),
        "usage": {t: dataclasses.asdict(u)
                  for t, u in sched.ledger._usage.items()},
        "ledger_events": list(sched.ledger.events),
        "quarantine": {"base": q.base, "cap": q.cap,
                       "until": dict(q._until), "streak": dict(q._streak),
                       "events": list(q.events)},
    }


def _scheduler_from_meta(sm: Optional[dict]) -> Optional[PolicyScheduler]:
    if sm is None:
        return None
    return PolicyScheduler(
        budgets={t: TenantBudget(**b) for t, b in sm["budgets"].items()},
        quarantine=Quarantine(base=sm["quarantine"]["base"],
                              cap=sm["quarantine"]["cap"]),
        preempt=sm["preempt"])


def _restore_sched_state(sched: PolicyScheduler, sm: dict) -> None:
    sched.ledger.default = TenantBudget(**sm["default"])
    sched.ledger._usage = {t: TenantUsage(**u)
                           for t, u in sm["usage"].items()}
    sched.ledger.events = list(sm["ledger_events"])
    q = sched.quarantine
    q._until = dict(sm["quarantine"]["until"])
    q._streak = dict(sm["quarantine"]["streak"])
    q.events = list(sm["quarantine"]["events"])


def _server_meta(srv) -> dict:
    """The construction half of the snapshot metadata (also the journal's
    ``open`` record): everything needed to rebuild an empty, equivalent
    server."""
    return {
        "pool": srv.pool, "cfg": srv.cfg.to_dict(),
        "gen_steps": srv.gen_steps, "chunk": srv.chunk,
        "table_capacity": srv.table.capacity, "default_fuel": srv.default_fuel,
        "shard": srv._shard, "trace_enabled": srv.trace_enabled,
        "stream_enabled": srv.stream_enabled,
        "compact_enabled": srv.compact_enabled,
        "obs_enabled": srv._obs is not None,
        "sched": _sched_meta(srv.sched),
    }


def snapshot_server(srv, *, journal_seq: int) -> Tuple[Dict[str, np.ndarray],
                                                       dict]:
    """Capture the WHOLE server as (arrays, JSON metadata)."""
    arrays = F.pack_carry(srv._states, srv._trace, prefix="carry/")
    arrays["host/order"] = np.asarray(srv._order, np.int64)
    arrays["host/ids"] = np.asarray(srv._ids, np.int32)
    arrays["host/fuel"] = np.asarray(srv._fuel, np.int64)
    arrays["host/prev_icount"] = np.asarray(srv._prev_icount, np.int64)
    parked = [r for r in srv._queue if r.checkpoint is not None]
    for req in parked:
        st, tr = req.checkpoint
        arrays.update(F.pack_carry(st, tr, prefix=f"ckpt/{req.rid}/"))
    arrays["host/hist_total"] = np.asarray(srv._hist_total, np.int64)
    # streaming trace pipeline: buffered (not-yet-published) rows plus the
    # per-key emission watermarks, so a recovered stream neither re-emits
    # nor loses a record (see recover()'s priming pass)
    stream_meta = None
    if srv._stream is not None:
        s = srv._stream
        stream_meta = {
            "counters": {"records_seen": s.records_seen,
                         "records_emitted": s.records_emitted,
                         "records_dropped": s.records_dropped,
                         "flips": s.flips},
            "keys": [],
        }
        for key in s.keys():
            ex = s.export_key(key)
            arrays[f"stream/{key}"] = np.asarray(ex.pop("rows"), np.int64)
            stream_meta["keys"].append([key, ex])
    meta = _server_meta(srv)
    memo: Dict[int, str] = {}    # digest once per distinct image
    meta.update({
        "W": srv._W, "next_rid": srv._next_rid,
        "journal_seq": journal_seq,
        # provenance only when chaos is live (the replay-verify pass) —
        # on-disk corruption is already caught by the npz zip per-entry
        # CRCs that load_step verifies
        "carry_crc": (F.carry_digest(srv._states, srv._trace)
                      if srv._chaos is not None else None),
        "counters": {k: getattr(srv, k) for k in _COUNTERS},
        "slots": [[i, request_meta(r, memo)] for i, r in enumerate(srv._slots)
                  if r is not None],
        "queue": [request_meta(r, memo) for r in srv._queue],
        "readmit": [request_meta(r, memo) for r in srv._readmit],
        "readmit_rids": sorted(srv._readmit_rids),
        "tenants": {t: dict(v) for t, v in srv._tenants.items()},
        "wait_gens": list(srv._wait_gens), "wait_s": list(srv._wait_s),
        "resume_wait_gens": list(srv._resume_wait_gens),
        "resume_wait_s": list(srv._resume_wait_s),
        "shed": list(srv.shed),
        "stream": stream_meta,
        # the obs hub's full state (registry buckets, open spans, phase
        # totals): recovery restores it so counters are monotone and
        # request lifecycles span-complete across the crash
        "obs": (srv._obs.export() if srv._obs is not None else None),
        "table": {
            "capacity": srv.table.capacity,
            "row_digest": [d.hex() if d is not None else None
                           for d in srv.table._digest_of],
            "refs": list(srv.table._refs),
            "free": list(srv.table._free),
            "admissions": srv.table.admissions,
            "dedup_hits": srv.table.dedup_hits,
        },
    })
    return arrays, meta


def _apply_snapshot(srv, arrays: Dict[str, np.ndarray], meta: dict, *,
                    store: ImageStore,
                    builders: Optional[Dict[str, Callable]]) -> None:
    """Overwrite a freshly-constructed server's state with a snapshot: the
    carry and every parked checkpoint become fresh tensors on the
    server's device (``restore_lanes`` scatters the checkpoints into the
    carry, so they must not share storage with anything)."""
    states, trace = F.unpack_carry(arrays, prefix="carry/",
                                   device=srv.device)
    if (trace is not None) != srv.trace_enabled:
        raise RecoveryError("snapshot trace carry does not match the "
                            "server's trace_enabled flag")
    srv._states, srv._trace = states, trace
    srv._order = np.asarray(arrays["host/order"], np.int64).copy()
    srv._ids = np.asarray(arrays["host/ids"], np.int32).copy()
    srv._fuel = np.asarray(arrays["host/fuel"], np.int64).copy()
    srv._prev_icount = np.asarray(arrays["host/prev_icount"],
                                  np.int64).copy()
    srv._W = int(meta["W"])
    srv._next_rid = int(meta["next_rid"])
    for k, v in meta["counters"].items():
        setattr(srv, k, v)
    if "host/hist_total" in arrays:
        srv._hist_total = np.asarray(arrays["host/hist_total"],
                                     np.int64).copy()
    sm = meta.get("stream")
    if sm is not None and srv._stream is not None:
        for k, v in sm["counters"].items():
            setattr(srv._stream, k, v)
        for key, ex in sm["keys"]:
            srv._stream.restore_key(int(key),
                                    rows=arrays[f"stream/{key}"], **ex)
    srv._tenants = {t: dict(v) for t, v in meta["tenants"].items()}
    srv._wait_gens = list(meta["wait_gens"])
    srv._wait_s = list(meta["wait_s"])
    srv._resume_wait_gens = list(meta.get("resume_wait_gens", []))
    srv._resume_wait_s = list(meta.get("resume_wait_s", []))
    srv.shed = list(meta["shed"])
    if meta.get("obs") is not None and srv._obs is not None:
        srv._obs.restore(meta["obs"])
    if srv.sched is not None:
        _restore_sched_state(srv.sched, meta["sched"])

    cache: Dict[tuple, PreparedProcess] = {}
    digest_pp: Dict[str, PreparedProcess] = {}

    def build(m: dict):
        req = request_from_meta(m, store=store, builders=builders,
                                cache=cache, digest_pp=digest_pp)
        if m["has_checkpoint"]:
            st, tr = F.unpack_carry(arrays, prefix=f"ckpt/{req.rid}/",
                                    device=srv.device)
            req.checkpoint = (st, tr)
        return req

    srv._slots = [None] * srv.pool
    for slot_i, m in meta["slots"]:
        srv._slots[slot_i] = build(m)
    srv._queue = deque(build(m) for m in meta["queue"])
    srv._readmit = [build(m) for m in meta["readmit"]]
    srv._readmit_rids = set(meta["readmit_rids"])

    # Image table: rebuild live rows from the rehydrated request images
    # (every live row is referenced by some slot/queue/readmit request —
    # checkpointed requests keep their row across eviction).  Dead cached
    # digests are dropped: their row data died with the process, and a
    # later re-admission of the same binary rewrites the row (one extra
    # ``admissions`` count, never a semantic difference).
    t = srv.table
    tm = meta["table"]
    if t.capacity != tm["capacity"]:
        raise RecoveryError("snapshot table capacity mismatch")
    for row, (dg, refs) in enumerate(zip(tm["row_digest"], tm["refs"])):
        if refs <= 0 or dg is None:
            continue
        pp = digest_pp.get(dg)
        if pp is None:
            raise RecoveryError(
                f"image-table row {row} (digest {dg}, {refs} refs) has no "
                f"referencing request in the snapshot")
        t._images = F.set_image_row(t._images, row, pp.decoded)
        t._row_of[bytes.fromhex(dg)] = row
        t._digest_of[row] = bytes.fromhex(dg)
        t._refs[row] = refs
    t._free = [r for r in tm["free"] if t._refs[r] == 0]
    t.admissions = tm["admissions"]
    t.dedup_hits = tm["dedup_hits"]


# ---------------------------------------------------------------------------
# the manager: journal hooks + snapshot cadence + chaos verify/rollback
# ---------------------------------------------------------------------------

class DurabilityManager:
    """The FleetServer's durability sidecar.

    Construct with a directory and pass as ``FleetServer(durability=...)``;
    knobs default from the server's :class:`HookConfig` at attach time
    (``snapshot_interval`` / ``snapshot_keep`` / ``journal_fsync``).
    """

    def __init__(self, directory: str | pathlib.Path, *,
                 snapshot_interval: Optional[int] = None,
                 keep: Optional[int] = None,
                 fsync: Optional[bool] = None,
                 builders: Optional[Dict[str, Callable]] = None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._interval = snapshot_interval
        self._keep = keep
        self._fsync = fsync
        self._builders = builders
        self.store = ImageStore(self.directory / "images")
        self.snaps: Optional[CheckpointManager] = None
        self.journal: Optional[Journal] = None
        self.snapshots = 0
        self.snapshot_rewrites = 0
        self.snapshot_bytes = 0
        self._last_snapshot_gen = 0

    # -- wiring ---------------------------------------------------------------

    def _fill_defaults(self, cfg: HookConfig) -> None:
        if self._interval is None:
            self._interval = cfg.snapshot_interval
        if self._keep is None:
            self._keep = cfg.snapshot_keep
        if self._fsync is None:
            self._fsync = cfg.journal_fsync
        self.snaps = CheckpointManager(self.directory / "snapshots",
                                       keep=self._keep)

    def attach(self, srv) -> None:
        """Fresh-server attach: open the journal and record construction."""
        self._fill_defaults(srv.cfg)
        records, good = Journal.replay(self.directory / "journal.jsonl")
        if records:
            raise RecoveryError(
                f"{self.directory} already holds a journal with "
                f"{len(records)} records; use FleetServer.recover() to "
                f"resume it (or point durability at a fresh directory)")
        self.journal = Journal(self.directory / "journal.jsonl",
                               fsync=self._fsync)
        self.journal.append("open", server=_server_meta(srv))
        self.journal.commit()
        self._last_snapshot_gen = srv.generation

    def _resume(self, srv, *, next_seq: int, good_bytes: int,
                last_snapshot_gen: int, replayed: int) -> None:
        """Recovered-server attach (called by :func:`recover`)."""
        self._fill_defaults(srv.cfg)
        self.journal = Journal(self.directory / "journal.jsonl",
                               fsync=self._fsync, next_seq=next_seq,
                               truncate_at=good_bytes)
        self._last_snapshot_gen = last_snapshot_gen
        self.journal.append("recover", gen=srv.generation, replayed=replayed)
        self.journal.commit()

    # -- server hooks ---------------------------------------------------------

    def check_builder(self, fn: Callable) -> None:
        if builder_ref(fn) is None:
            raise ValueError(
                "durable serving cannot journal this builder (not a "
                "registered or importable module-level callable): "
                "register_builder(name, fn) first, or submit the "
                "PreparedProcess instead")

    def on_submit(self, srv, req) -> None:
        meta = request_meta(req)
        if req.builder is None:
            # content-addressed, dedup by digest (reuse meta's sha1)
            self.store.put(req.pp, digest=meta["digest"])
        self.journal.append("submit", req=meta)
        # group commit: the record is flushed to the OS here but only
        # fsync'd at the next dispatch barrier (before_dispatch) — a
        # machine crash before then loses a not-yet-executed submit,
        # never a generation a published result depended on

    def on_update_policy(self, srv, tenant: str,
                         rules: List[PolicyRule]) -> None:
        self.journal.append("update_policy", tenant=tenant,
                            rules=[dataclasses.asdict(r) for r in rules])
        self.journal.commit()

    def on_shed(self, srv, req, reason: str) -> None:
        self.journal.append("shed", rid=req.rid, tenant=req.tenant,
                            reason=reason, gen=srv.generation)

    def before_dispatch(self, srv) -> None:
        self.journal.commit()

    def after_generation(self, srv, results: list, *,
                         skipped: bool = False) -> list:
        """Journal the generation, and at the snapshot cadence run the
        (chaos-mode) replay-verify then write a snapshot.  Returns the
        results to publish — possibly extended with a corrected window
        after a rollback."""
        fields = dict(gen=srv.generation - 1,
                      rids=[r.rid for r in results], skipped=skipped)
        if srv._stream is not None:
            # per-key emission watermarks: recover() primes the rebuilt
            # stream with these so replayed pushes re-buffer rows for
            # result assembly without re-emitting them to the sink
            fields["stream_hwm"] = {str(k): v for k, v in
                                    srv._stream.hwm_map().items()}
        with obs_phase(srv._obs, "journal_append"):
            if srv._obs is not None:
                # watermarks ride every gen record so recover() can raise
                # replayed counters/timings to at least their pre-crash
                # values — replay re-counts the tail deterministically,
                # but work done between the last commit and the crash
                # would otherwise vanish.  Taken inside the phase so the
                # in-flight credit counts this very append.
                fields["obs_wm"] = srv._obs.watermark()
            self.journal.append("gen", **fields)
            self.journal.commit()
        if (self._interval and
                srv.generation - self._last_snapshot_gen >= self._interval):
            extra: list = []
            if srv._chaos is not None and srv._chaos.wants_verify():
                with obs_phase(srv._obs, "rollback_verify"):
                    extra = self._verify_and_rollback(srv)
            with obs_phase(srv._obs, "snapshot_write"):
                self.take_snapshot(srv)
            results = results + extra
        return results

    # -- snapshots ------------------------------------------------------------

    def take_snapshot(self, srv) -> None:
        arrays, meta = snapshot_server(srv, journal_seq=self.journal.last_seq)
        path = self.snaps.save(srv.generation, arrays, extra=meta)
        self.snapshots += 1
        written = sum(f.stat().st_size for f in path.iterdir())
        self.snapshot_bytes += written
        self._last_snapshot_gen = srv.generation
        self.journal.append("snapshot", gen=srv.generation, bytes=written)
        self.journal.commit()
        if srv._chaos is not None:
            corrupted = srv._chaos.corrupt_snapshot(srv, path)
            try:
                self.snaps.load_step(path)
            except Exception as e:
                log.warning("snapshot %s corrupt after write (%s): rewriting",
                            path.name, e)
                self.snaps.save(srv.generation, arrays, extra=meta)
                self.snapshot_rewrites += 1
                if corrupted:
                    srv._chaos.resolve(corrupted, "rewritten")
            else:
                if corrupted:
                    # the flipped byte landed outside anything load/verify
                    # reads (e.g. zip padding): the snapshot is still fully
                    # restorable, nothing to rewrite
                    srv._chaos.resolve(corrupted, "harmless")
            srv._chaos.flip_carry(srv)   # arms next boundary's verify

    # -- chaos rollback -------------------------------------------------------

    def _verify_and_rollback(self, srv) -> list:
        """Replay-verify: recover a chaos-free replica from the last
        snapshot + journal, compare full-coverage carry digests, and on
        mismatch adopt the replica (replayed truth), punishing the
        corrupted lanes' tenants into quarantine.  Returns the replica's
        replayed window results (corrected re-publications)."""
        live_crc = F.carry_digest(srv._states, srv._trace)
        # the replica is a second server on the same device; once adopted
        # its carry is ours and the replica object goes with this frame
        replica, replayed = recover(self.directory, builders=self._builders,
                                    attach=False, device=srv.device)
        rep_crc = F.carry_digest(replica._states, replica._trace)
        if live_crc == rep_crc:
            return []
        live_l = F.lane_digests(srv._states, srv._trace)
        rep_l = F.lane_digests(replica._states, replica._trace)
        bad = [p for p in range(min(len(live_l), len(rep_l)))
               if live_l[p] != rep_l[p]]
        tenants = sorted({srv._slots[srv._order[p]].tenant for p in bad
                          if p < srv._W
                          and srv._slots[srv._order[p]] is not None})
        log.warning("carry corruption detected at gen %d (lanes %s, "
                    "tenants %s): rolling back to replayed state",
                    srv.generation, bad, tenants)
        gens = replica.recovery_generations
        self.journal.append("rollback", gen=srv.generation, lanes=bad,
                            tenants=tenants)
        self.journal.commit()
        srv._adopt(replica)
        srv.rollbacks += 1
        srv.recovery_generations += gens
        for t in tenants:
            if srv.sched is not None:
                srv.sched.note_corruption(t, srv.generation)
        if srv._chaos is not None:
            srv._chaos.resolve_kind("bitflip", "rolled_back")
        return replayed


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def recover(directory: str | pathlib.Path, *,
            builders: Optional[Dict[str, Callable]] = None,
            chaos=None, attach: bool = True,
            fsync: Optional[bool] = None, device=None):
    """Rebuild a crashed :class:`FleetServer` from ``directory``.

    Returns ``(server, replayed_results)`` — the results re-published
    while replaying the journal tail (bit-identical to what the dead
    server published after its last snapshot; dedup by ``rid`` against
    anything the client already received).  With ``attach=True`` the
    server gets a live :class:`DurabilityManager` on the same directory
    and keeps journaling/snapshotting where the dead one stopped;
    ``attach=False`` builds a read-only replica (the rollback-verify
    path).  The server runs on ``device`` (``None`` means the card).
    """
    from .fleet_server import FleetServer

    directory = pathlib.Path(directory)
    records, good_bytes = Journal.replay(directory / "journal.jsonl")
    if not records:
        raise RecoveryError(f"no journal at {directory}")
    store = ImageStore(directory / "images")

    snap = None
    snap_dir = directory / "snapshots"
    if snap_dir.exists():
        mgr = CheckpointManager(snap_dir, keep=10**9)  # no GC on a read path
        snap = mgr.restore_latest(None)

    if snap is not None:
        _, arrays, meta = snap
        srv = FleetServer(
            meta["pool"], cfg=HookConfig.from_dict(meta["cfg"]),
            gen_steps=meta["gen_steps"], chunk=meta["chunk"],
            table_capacity=meta["table_capacity"],
            fuel=meta["default_fuel"], shard=meta["shard"],
            trace=meta["trace_enabled"],
            stream=meta.get("stream_enabled", False),
            compact=meta["compact_enabled"],
            obs=meta.get("obs_enabled", False),
            scheduler=_scheduler_from_meta(meta["sched"]), device=device)
        _apply_snapshot(srv, arrays, meta, store=store, builders=builders)
        start_seq = int(meta["journal_seq"])
        last_snapshot_gen = srv.generation
    else:
        if records[0]["kind"] != "open":
            raise RecoveryError("journal does not start with an open record "
                                "and no snapshot exists")
        om = records[0]["server"]
        srv = FleetServer(
            om["pool"], cfg=HookConfig.from_dict(om["cfg"]),
            gen_steps=om["gen_steps"], chunk=om["chunk"],
            table_capacity=om["table_capacity"], fuel=om["default_fuel"],
            shard=om["shard"], trace=om["trace_enabled"],
            stream=om.get("stream_enabled", False),
            compact=om["compact_enabled"],
            obs=om.get("obs_enabled", False),
            scheduler=_scheduler_from_meta(om["sched"]), device=device)
        if om["sched"] is not None:
            _restore_sched_state(srv.sched, om["sched"])
        start_seq = records[0]["seq"]
        last_snapshot_gen = 0

    # prime the stream's emission watermarks with the highest (epoch, hwm)
    # the dead server journaled AFTER the restored snapshot, so the tail
    # replay re-buffers rows for result assembly without re-emitting them
    # to the sink (requests that published inside the tail ARE re-emitted
    # under the same (key, epoch, seq) — the line-level at-least-once,
    # key-level exactly-once contract of repro_torch.trace.stream)
    if getattr(srv, "_stream", None) is not None:
        prime: Dict[int, list] = {}
        for rec in records:
            if rec["seq"] <= start_seq or rec["kind"] != "gen":
                continue
            for k, eh in (rec.get("stream_hwm") or {}).items():
                cur = prime.get(int(k))
                if cur is None or tuple(eh) > tuple(cur):
                    prime[int(k)] = eh
        if prime:
            srv._stream.prime(prime)

    # replay the tail
    cache: Dict[tuple, PreparedProcess] = {}
    replayed_results: list = []
    replayed_gens = 0
    for rec in records:
        if rec["seq"] <= start_seq:
            continue
        kind = rec["kind"]
        if kind == "submit":
            req = request_from_meta(rec["req"], store=store,
                                    builders=builders, cache=cache)
            srv._restore_submit(req)
        elif kind == "update_policy":
            srv.update_policy(rec["tenant"],
                              [PolicyRule(**r) for r in rec["rules"]])
        elif kind == "shed":
            srv._apply_shed(rec["rid"], rec["reason"])
        elif kind == "gen":
            if rec["skipped"]:
                srv._replay_skipped_generation()
            else:
                out = srv.step()
                got = [r.rid for r in out]
                if got != rec["rids"]:
                    # legitimate inside a chaos-corrupted window (the live
                    # results were wrong — the replay IS the fix); anywhere
                    # else it would mean non-determinism
                    log.warning("replay gen %d published rids %s, journal "
                                "recorded %s", rec["gen"], got, rec["rids"])
                replayed_results.extend(out)
            replayed_gens += 1
        # open / snapshot / rollback / recover records carry no replay action

    if srv._obs is not None:
        # counters monotone across the crash: replay re-counted the tail
        # deterministically, but anything the dead server counted between
        # its last committed gen record and the crash is floored back in
        # from the newest journaled watermark (idempotent elementwise max)
        wm = None
        for rec in records:
            if rec["kind"] == "gen" and rec.get("obs_wm") is not None:
                wm = rec["obs_wm"]
        if wm:
            srv._obs.apply_watermark(wm)

    srv.recovery_generations += replayed_gens
    if attach:
        dur = DurabilityManager(directory, fsync=fsync, builders=builders)
        dur._resume(srv, next_seq=records[-1]["seq"] + 1,
                    good_bytes=good_bytes,
                    last_snapshot_gen=last_snapshot_gen,
                    replayed=replayed_gens)
        srv._dur = dur
        if chaos is not None:
            srv._chaos = chaos
            chaos.attach(srv)
    return srv, replayed_results
