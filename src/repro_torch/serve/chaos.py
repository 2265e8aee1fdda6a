"""Chaos fault injection for the durable FleetServer (PyTorch port of the
JAX package's ``repro.serve.chaos``).

A :class:`ChaosMonkey` wraps the serving dispatch path with deterministic,
seeded faults — the test double for every failure the durability layer
claims to survive:

* **dispatch faults** — an exception raised *before* the generation's
  first kernel launch (never after: the megastep kernel writes the carry
  in place, so a retry must start from an untouched carry).
  Answered by bounded exponential-backoff retry; when
  ``cfg.chaos_max_retries`` extra attempts are exhausted the server
  load-sheds its queue with a reason and skips the generation.
* **hangs** — a sleep past the wall-clock generation watchdog
  (``cfg.serve_watchdog_s``), surfacing as a watchdog trip; retried like
  any dispatch fault.
* **snapshot corruption** — a byte flipped in a just-written snapshot's
  ``arrays.npz``.  The durability manager verifies every snapshot after
  the chaos hook runs and rewrites a corrupt one in place.
* **carry bit-flips** — one bit of one live lane's memory plane flipped
  in place where the carry lives, after a snapshot.  Caught at the next
  snapshot boundary by the replay-verify pass (full-coverage carry digest
  vs a replica recovered from disk), answered by lane rollback — the
  server adopts the replayed state, re-emits the corrected window and
  escalates the corrupted lanes' tenants into ``sched.quarantine``.  As
  in the JAX package, a flipped lane that publishes before that boundary
  is not compared, and its flipped state is published.

Every injection gets an id and a ledger entry; the soak test's invariant
is that every entry ends the run **resolved** (``retried`` / ``shed`` /
``rewritten`` / ``rolled_back`` / ``harmless``) — faults may cost work,
never results.

Faults come from two sources: *rates* (per-opportunity probabilities
drawn from a generator seeded by ``chaos_seed`` — reproducible runs) and
an optional *plan* (``{generation: [kind, ...]}`` — exact placement for
targeted tests).  Kinds: ``dispatch``, ``hang`` (consumed at dispatch
attempts), ``corrupt``, ``bitflip`` (consumed at snapshot boundaries).
The seeded generator is numpy's ``PCG64``, drawn at the same points as
the JAX package's, so a fixed seed gives the JAX server's injection
ledger.
"""
from __future__ import annotations

import logging
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np

from ..core import fleet as F
from ..core import layout as L

log = logging.getLogger(__name__)

KINDS = ("dispatch", "hang", "corrupt", "bitflip")


class ChaosFault(RuntimeError):
    """An injected fault.  The server catches these duck-typed on the
    ``chaos_kind`` attribute, so nothing outside this module needs the
    class."""

    def __init__(self, kind: str, injection_id: int, detail: str = ""):
        super().__init__(f"chaos[{injection_id}] {kind}: {detail}")
        self.chaos_kind = kind
        self.injection_id = injection_id


class ChaosMonkey:
    """Deterministic fault injector; pass as ``FleetServer(chaos=...)``.

    Rates default from the server's :class:`HookConfig`
    (``chaos_*_rate`` / ``chaos_seed``) at attach time; pass them
    explicitly to override.  ``plan`` schedules exact faults by
    generation and composes with rates (plan entries fire first).
    """

    def __init__(self, *, seed: Optional[int] = None,
                 dispatch_fault_rate: Optional[float] = None,
                 hang_rate: Optional[float] = None,
                 bitflip_rate: Optional[float] = None,
                 snapshot_corrupt_rate: Optional[float] = None,
                 plan: Optional[Dict[int, List[str]]] = None):
        self._seed = seed
        self.dispatch_fault_rate = dispatch_fault_rate
        self.hang_rate = hang_rate
        self.bitflip_rate = bitflip_rate
        self.snapshot_corrupt_rate = snapshot_corrupt_rate
        self.plan = {int(g): list(ks) for g, ks in (plan or {}).items()}
        for g, ks in self.plan.items():
            for k in ks:
                if k not in KINDS:
                    raise ValueError(f"unknown chaos kind {k!r} at gen {g} "
                                     f"(kinds: {KINDS})")
        self.rng: Optional[np.random.Generator] = None
        self.injections: List[dict] = []
        self._metrics = None   # the attached server's obs registry, if any
        # sticky: plan entries are consumed when they fire, but the verify
        # pass that CATCHES a planned bitflip runs at the next snapshot
        # boundary, after consumption
        self._plan_bitflips = any("bitflip" in ks for ks in self.plan.values())

    # -- wiring ---------------------------------------------------------------

    def attach(self, srv) -> None:
        cfg = srv.cfg
        obs = getattr(srv, "_obs", None)
        self._metrics = obs.registry if obs is not None else None
        if self._seed is None:
            self._seed = cfg.chaos_seed
        if self.dispatch_fault_rate is None:
            self.dispatch_fault_rate = cfg.chaos_dispatch_fault_rate
        if self.hang_rate is None:
            self.hang_rate = cfg.chaos_hang_rate
        if self.bitflip_rate is None:
            self.bitflip_rate = cfg.chaos_bitflip_rate
        if self.snapshot_corrupt_rate is None:
            self.snapshot_corrupt_rate = cfg.chaos_snapshot_corrupt_rate
        self.rng = np.random.Generator(np.random.PCG64(self._seed))
        needs_dur = (self.bitflip_rate > 0 or self.snapshot_corrupt_rate > 0
                     or any(k in ("bitflip", "corrupt")
                            for ks in self.plan.values() for k in ks))
        if needs_dur and srv._dur is None:
            raise ValueError(
                "chaos bitflip/snapshot-corruption injection needs "
                "durability (rollback and rewrite recover from snapshots): "
                "pass FleetServer(durability=...) too")

    def wants_verify(self) -> bool:
        """Should the durability manager replay-verify at each snapshot?"""
        return bool(self.bitflip_rate and self.bitflip_rate > 0) \
            or self._plan_bitflips

    # -- the injection ledger -------------------------------------------------

    def _inject(self, kind: str, gen: int, **detail) -> int:
        iid = len(self.injections)
        self.injections.append({"id": iid, "kind": kind, "gen": gen,
                                "resolution": None, **detail})
        if self._metrics is not None:
            self._metrics.counter(
                "chaos_injections_total",
                "injected faults by kind").inc(1, kind=kind)
        log.info("chaos inject [%d] %s at gen %d %s", iid, kind, gen, detail)
        return iid

    def _count_resolution(self, outcome: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(
                "chaos_resolutions_total",
                "resolved injections by outcome").inc(1, outcome=outcome)

    def resolve(self, ids, outcome: str) -> None:
        if isinstance(ids, int):
            ids = [ids]
        for iid in ids:
            if self.injections[iid]["resolution"] is None:
                self.injections[iid]["resolution"] = outcome
                self._count_resolution(outcome)

    def resolve_kind(self, kind: str, outcome: str) -> None:
        for inj in self.injections:
            if inj["kind"] == kind and inj["resolution"] is None:
                inj["resolution"] = outcome
                self._count_resolution(outcome)

    def unresolved(self) -> List[dict]:
        return [i for i in self.injections if i["resolution"] is None]

    def summary(self) -> dict:
        by_kind: Dict[str, int] = {}
        by_res: Dict[str, int] = {}
        for i in self.injections:
            by_kind[i["kind"]] = by_kind.get(i["kind"], 0) + 1
            res = i["resolution"] or "UNRESOLVED"
            by_res[res] = by_res.get(res, 0) + 1
        return {"injections": len(self.injections), "by_kind": by_kind,
                "by_resolution": by_res,
                "unresolved": len(self.unresolved())}

    def _planned(self, gen: int, kinds: tuple) -> Optional[str]:
        ks = self.plan.get(gen)
        if ks:
            for k in list(ks):
                if k in kinds:
                    ks.remove(k)
                    return k
        return None

    # -- hooks ----------------------------------------------------------------

    def pre_dispatch(self, srv) -> None:
        """Called once per dispatch *attempt*, before the first launch.
        Raises :class:`ChaosFault` to fail the attempt."""
        gen = srv.generation
        k = self._planned(gen, ("dispatch", "hang"))
        if k is None:
            if self.dispatch_fault_rate and (self.rng.random()
                                             < self.dispatch_fault_rate):
                k = "dispatch"
            elif self.hang_rate and self.rng.random() < self.hang_rate:
                k = "hang"
        if k == "dispatch":
            iid = self._inject("dispatch", gen)
            raise ChaosFault("dispatch", iid, "injected dispatch failure")
        if k == "hang":
            budget = srv.cfg.serve_watchdog_s
            stall = budget * 1.25 if budget > 0 else 0.002
            iid = self._inject("hang", gen, stall_s=stall)
            time.sleep(stall)
            raise ChaosFault("watchdog", iid,
                             f"generation stalled {stall:.3f}s "
                             f"(budget {budget:.3f}s)")

    def corrupt_snapshot(self, srv, path: pathlib.Path) -> List[int]:
        """Maybe flip one byte of a just-written snapshot's arrays.npz.
        Returns the injection ids (the manager resolves them after its
        verify-and-rewrite pass)."""
        k = self._planned(srv.generation, ("corrupt",))
        if k is None and not (self.snapshot_corrupt_rate
                              and self.rng.random()
                              < self.snapshot_corrupt_rate):
            return []
        target = path / "arrays.npz"
        data = bytearray(target.read_bytes())
        off = int(self.rng.integers(0, len(data)))
        data[off] ^= 0xFF
        target.write_bytes(bytes(data))
        iid = self._inject("corrupt", srv.generation,
                           file=target.name, offset=off)
        return [iid]

    def flip_carry(self, srv) -> Optional[int]:
        """Maybe flip one bit of one occupied lane's memory plane, in place
        in the live carry (called right after a snapshot, so the flip is
        exactly what the next boundary's replay-verify must catch; parked
        checkpoints and published states are copies and never see it)."""
        k = self._planned(srv.generation, ("bitflip",))
        if k is None and not (self.bitflip_rate
                              and self.rng.random() < self.bitflip_rate):
            return None
        occupied = [p for p in range(srv._W)
                    if srv._slots[srv._order[p]] is not None]
        if not occupied:
            return None
        lane = int(self.rng.choice(occupied))
        word = int(self.rng.integers(0, L.MEM_WORDS))
        bit = int(self.rng.integers(0, 64))
        srv._states = F.flip_bit(srv._states, lane, word, bit)
        return self._inject("bitflip", srv.generation,
                            lane=lane, word=word, bit=bit)
