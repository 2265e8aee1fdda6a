"""The ASC-Hook runtime: the LD_PRELOAD-entry equivalent (PyTorch port).

``prepare()`` plays the role of the constructor that runs before ``main``:
it walks the process image, scans, classifies and rewrites svc sites,
installs the trampolines and the hook library, and registers the signal
handler when any R3 site exists.  It also implements the comparison
mechanisms of the paper's evaluation: pure signal interception, ptrace,
and LD_PRELOAD function interposition.  This host side is the JAX
package's, unchanged; the fleet entry points run on the card (or, when
asked, on the CPU) through :mod:`repro_torch.core.fleet`.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import fleet as F
from . import layout as L
from . import machine as M
from .hookcfg import HookConfig
from .image import Image, build_process
from .isa import Asm
from .rewriter import RewriteReport, rewrite_all_to_signal, rewrite_image
from .trampoline import build_hook_library, build_signal_handler
from ..parallel import sharding as SH


class Mechanism(enum.Enum):
    NONE = "none"
    LD_PRELOAD = "ld_preload"
    SIGNAL = "signal"
    PTRACE = "ptrace"
    ASC = "asc"


@dataclasses.dataclass
class PreparedProcess:
    image: Image
    decoded: M.DecodedImage
    entry: int
    sig_handler: int
    mechanism: Mechanism
    report: Optional[RewriteReport]
    virtualize: bool
    cfg: Optional[HookConfig] = None


AppBuilder = Callable[[], Asm]


def prepare(app: Asm, mechanism: Mechanism, *,
            virtualize: bool = False,
            cfg: Optional[HookConfig] = None,
            extra: Optional[Dict[str, Asm]] = None) -> PreparedProcess:
    cfg = cfg or HookConfig()
    preload = virtualize if mechanism is Mechanism.LD_PRELOAD else None
    image = build_process(app, extra=extra, preload_virt=preload)

    report = None
    sig_handler = 0
    if mechanism in (Mechanism.ASC, Mechanism.SIGNAL):
        # hook library in its own namespace (dlmopen analogue, not rewritten)
        hook = build_hook_library(virtualize_getpid=virtualize)
        image.add_asm("hooklib.so", hook, rewrite=False)
        hook_entry = image.sym("hooklib.so:hook_entry")
        if mechanism is Mechanism.ASC:
            report = rewrite_image(image, hook_entry, cfg)
            needs_handler = report.needs_signal
        else:
            report = rewrite_all_to_signal(image, cfg)
            needs_handler = True
        if needs_handler:
            handler = build_signal_handler()
            image.add_asm("sighandler", handler, rewrite=False,
                          symbols={"hook_entry": hook_entry})
            sig_handler = image.sym("sighandler:sig_handler")

    decoded = M.decode_image(image.words)
    return PreparedProcess(
        image=image, decoded=decoded, entry=image.sym("app:main"),
        sig_handler=sig_handler, mechanism=mechanism, report=report,
        virtualize=virtualize, cfg=cfg)


def initial_state(pp: PreparedProcess, *, fuel: int = 2_000_000,
                  regs: Optional[Dict[int, int]] = None,
                  device="cpu") -> M.MachineState:
    """The machine state ``run_prepared`` starts from (also the per-lane
    initial state of a fleet).  ``regs`` seeds registers at entry
    ({index: value}) — how parameterised workloads receive their
    arguments."""
    st = M.make_state(pp.entry, fuel=fuel, device=device)
    for i, v in (regs or {}).items():
        assert 0 <= i <= 30, i
        st.regs[i] = v
    st.sig_handler.fill_(pp.sig_handler)
    st.ptrace.fill_(1 if pp.mechanism is Mechanism.PTRACE else 0)
    st.virt_getpid.fill_(
        1 if (pp.mechanism is Mechanism.PTRACE and pp.virtualize) else 0)
    st.k_enabled.fill_(1 if (pp.cfg is None or pp.cfg.emul_enabled) else 0)
    return st


def run_prepared(pp: PreparedProcess, *, fuel: int = 2_000_000,
                 regs: Optional[Dict[int, int]] = None,
                 device=None) -> M.MachineState:
    """Run one prepared process to halt: a width-1 fleet run.
    ``device=None`` means the card."""
    return M.run_image(pp.decoded, initial_state(pp, fuel=fuel, regs=regs),
                       device=device)


def fleet_trace(pps: Sequence[PreparedProcess], *,
                cap: Optional[int] = None, device=None) -> F.TraceState:
    """The trace carry for a fleet of prepared processes: one ring per lane
    plus that lane's policy tables compiled from its ``HookConfig.policy``
    (empty policies compile to all-ALLOW).  ``cap`` defaults to the
    largest ``trace_cap`` among the configs; ``device=None`` means the
    card."""
    from ..trace import recorder  # local: repro_torch.trace depends on core
    if cap is None:
        caps = [pp.cfg.trace_cap for pp in pps if pp.cfg is not None]
        cap = max(caps) if caps else F.DEFAULT_TRACE_CAP
    pols = [pp.cfg.policy if pp.cfg is not None and pp.cfg.policy else None
            for pp in pps]
    return recorder.make_trace_state(len(pps), cap, policies=pols,
                                     device=device)


def _image_digest(pp: PreparedProcess) -> bytes:
    return hashlib.sha1(
        np.ascontiguousarray(pp.image.words).tobytes()).digest()


class FleetImageTable:
    """A fixed-capacity, content-deduplicated stack of packed decode tables
    with incremental admission and eviction — the serving-side extension
    of :func:`pack_fleet`'s dedup.

    The stack keeps the shape ``[capacity, CODE_WORDS]`` on ``device``
    (``None`` means the card); a new image joins as one in-place row write
    (:func:`fleet.set_image_row`).  Rows are refcounted; a released row
    keeps its digest cached until the row is reused, so admitting a
    recently seen binary again writes nothing.  Free rows are reused
    oldest first."""

    def __init__(self, capacity: int, *, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        dev = M.resolve_device(device)
        self.capacity = capacity
        self._images = F.FleetImages(
            packed=torch.zeros((capacity, L.CODE_WORDS), dtype=torch.int64,
                               device=dev),
            imm=torch.zeros((capacity, L.CODE_WORDS), dtype=torch.int64,
                            device=dev))
        self._row_of: Dict[bytes, int] = {}
        self._digest_of: List[Optional[bytes]] = [None] * capacity
        self._refs: List[int] = [0] * capacity
        self._free: List[int] = list(range(capacity))  # FIFO: oldest first
        self.admissions = 0      # row writes actually performed
        self.dedup_hits = 0      # admissions served from a live/cached row

    @property
    def images(self) -> F.FleetImages:
        return self._images

    def live_rows(self) -> int:
        return sum(1 for r in self._refs if r > 0)

    def admit(self, pp: PreparedProcess) -> int:
        """Return the row holding ``pp``'s decode table, admitting it (one
        in-place row write) if no live or cached row matches."""
        d = _image_digest(pp)
        row = self._row_of.get(d)
        if row is not None:
            if self._refs[row] == 0:     # cache hit on a released row
                self._free.remove(row)
            self._refs[row] += 1
            self.dedup_hits += 1
            return row
        if not self._free:
            raise RuntimeError(
                f"FleetImageTable full ({self.capacity} rows all live); "
                f"size the table to pool width + expected binary diversity")
        row = self._free.pop(0)
        old = self._digest_of[row]
        if old is not None:              # evict the cached (dead) digest
            del self._row_of[old]
        F.set_image_row(self._images, row, pp.decoded)
        self._row_of[d] = row
        self._digest_of[row] = d
        self._refs[row] = 1
        self.admissions += 1
        return row

    def refs(self, row: int) -> int:
        return self._refs[row]

    def release(self, row: int) -> None:
        if self._refs[row] <= 0:
            raise ValueError(f"row {row} double-released")
        self._refs[row] -= 1
        if self._refs[row] == 0:
            self._free.append(row)       # digest stays cached until reuse


def pack_fleet(pps: Sequence[PreparedProcess], *,
               fuel: int = 2_000_000,
               regs: Optional[Sequence[Optional[Dict[int, int]]]] = None,
               table: Optional[FleetImageTable] = None,
               trace: Optional[bool] = None,
               device=None):
    """Stack prepared processes into ``(images, img_ids, states)`` on
    ``device`` (``None`` means the card) for :func:`fleet.run_fleet`.

    Decode tables are deduplicated by image content, so a census sweeping
    iteration counts or mechanisms over shared binaries ships each
    distinct image to the device once.  With ``table`` (a
    :class:`FleetImageTable` on the same device) the images are admitted
    into that fixed-capacity stack instead — the continuous-batching entry
    path, where later admissions keep the stack's shape.  ``trace=True``
    appends a fourth element: the :class:`fleet.TraceState` carry from
    :func:`fleet_trace`.  The return arity depends only on this
    argument."""
    dev = M.resolve_device(device)
    if table is not None:
        if table.images.packed.device != dev:
            raise ValueError(f"the image table is on "
                             f"{table.images.packed.device}, the fleet on "
                             f"{dev}")
        ids = np.asarray([table.admit(pp) for pp in pps], np.int32)
        imgs = table.images
    else:
        ids = np.zeros(len(pps), np.int32)
        digests: Dict[bytes, int] = {}
        uniq: List[M.DecodedImage] = []
        for i, pp in enumerate(pps):
            d = _image_digest(pp)
            if d not in digests:
                digests[d] = len(uniq)
                uniq.append(pp.decoded)
            ids[i] = digests[d]
        imgs = F.images_to(F.pack_images(F.stack_images(uniq)), dev)
    if regs is None:
        regs = [None] * len(pps)
    states = F.states_to(F.stack_states(
        [initial_state(pp, fuel=fuel, regs=rg) for pp, rg in zip(pps, regs)]),
        dev)
    ids = torch.from_numpy(ids).to(dev)
    if not trace:
        return imgs, ids, states
    return imgs, ids, states, fleet_trace(pps, device=dev)


def run_fleet_prepared(pps: Sequence[PreparedProcess], *,
                       fuel: int = 2_000_000,
                       chunk: Optional[int] = None,
                       regs: Optional[Sequence[Optional[Dict[int, int]]]] = None,
                       shard: bool = False,
                       trace: Optional[bool] = None,
                       compact: Optional[bool] = None,
                       compact_stats: Optional[dict] = None,
                       policy_overrides: Optional[Dict[int, Sequence]] = None,
                       engine: Optional[str] = None,
                       device=None):
    """Run every prepared process to completion as one fleet.

    ``chunk`` defaults to the first process's ``HookConfig.fleet_chunk``
    and ``engine`` to its ``fleet_engine`` (both names run the megastep
    wrapper).  Lane i of the result is bit-identical to
    ``run_prepared(pps[i], fuel=fuel, regs=regs[i])``.  ``device=None``
    means the card.

    With ``trace=True`` returns ``(states, trace_state)``: the syscall
    rings and policy verdicts of the whole fleet.  ``policy_overrides``
    (lane -> ``PolicyRule`` list; requires ``trace=True``) replaces those
    lanes' policy rows in the trace carry before the run
    (:func:`update_fleet_policy`); every other lane is untouched.

    ``compact`` switches to :func:`fleet.run_fleet_compact` (live lanes
    gathered into narrower widths as the fleet drains), with
    ``compact_min_bucket`` / ``compact_hysteresis`` from the first
    process's ``HookConfig``; ``None`` defers to its ``compact_enabled``.
    Results and the return arity are unchanged.  ``compact_stats`` (a
    dict, filled in place) receives a compacted run's occupancy ledger.
    ``shard=True`` splits the lanes over the devices
    (:func:`repro_torch.parallel.sharding.fleet_devices`) when their count
    divides the lane count (:func:`fleet.run_fleet`); the result is the
    same.
    """
    cfg = next((pp.cfg for pp in pps if pp.cfg is not None), None)
    if compact is None:
        compact = cfg.compact_enabled if cfg is not None else False
    if engine is None:
        engine = cfg.fleet_engine if cfg is not None else "xla"
    F._check_engine(engine, shard=shard)
    if policy_overrides and not trace:
        raise ValueError("policy_overrides require trace=True")
    if chunk is None:
        chunk = cfg.fleet_chunk if cfg is not None else F.DEFAULT_CHUNK
    packed = pack_fleet(pps, fuel=fuel, regs=regs, trace=trace,
                        device=device)
    imgs, ids, states = packed[:3]
    ts = packed[3] if trace else None
    if policy_overrides:
        lanes = sorted(policy_overrides)
        bad = [ln for ln in lanes if not 0 <= ln < len(pps)]
        if bad:
            # the scatter drops stray lanes (a padding convention); here
            # one would silently leave the fleet unenforced
            raise ValueError(
                f"policy_overrides lanes {bad} out of range for "
                f"{len(pps)} lanes")
        update_fleet_policy(ts, lanes, [policy_overrides[ln] for ln in lanes])
    if compact:
        ccfg = cfg or HookConfig()
        return F.run_fleet_compact(
            imgs, states, ids, chunk=chunk, shard=shard, trace=ts,
            min_bucket=ccfg.compact_min_bucket,
            hysteresis=ccfg.compact_hysteresis, stats=compact_stats,
            engine=engine, device=device)
    return F.run_fleet(imgs, states, ids, chunk=chunk, shard=shard,
                       engine=engine, trace=ts, device=device)


def update_fleet_policy(trace: F.TraceState, lanes: Sequence[int],
                        rules: Sequence) -> F.TraceState:
    """Compile per-lane rule lists and swap them into the trace carry's
    policy rows in place (:func:`fleet.update_policy_rows`).  ``rules`` is
    one ``PolicyRule`` list per lane (``None`` = all-ALLOW); rules are
    validated up front."""
    from ..trace import policy as TP  # local: repro_torch.trace uses core
    rows = [TP.compile_policy(r) if r is not None else None for r in rules]
    return F.update_policy_rows(trace, lanes, rows)


def precompile_compact(pps: Sequence[PreparedProcess], *,
                       chunk: Optional[int] = None,
                       min_bucket: Optional[int] = None,
                       interval: Optional[int] = None,
                       trace: Optional[bool] = None,
                       shard: bool = False, device=None) -> List[int]:
    """Make ready every rung of the compaction ladder that
    ``run_fleet_prepared(compact=True)`` over ``pps`` visits
    (:func:`fleet.precompile_ladder`: on the card, the kernel library is
    built or loaded once), so a timed run pays no build.  ``chunk`` and
    ``min_bucket`` default to the first process's config; with ``shard``
    the ladder keeps the rungs the device count divides.  Returns the
    ladder."""
    cfg = next((pp.cfg for pp in pps if pp.cfg is not None), None) \
        or HookConfig()
    chunk = cfg.fleet_chunk if chunk is None else chunk
    min_bucket = cfg.compact_min_bucket if min_bucket is None else min_bucket
    divisor = SH.fleet_divisor(len(pps), F._mesh(True, device)) if shard \
        else 1
    ladder = F.compact_ladder(len(pps), min_bucket, divisor=divisor)
    cap = None
    if trace:
        caps = [pp.cfg.trace_cap for pp in pps if pp.cfg is not None]
        cap = max(caps) if caps else F.DEFAULT_TRACE_CAP
    F.precompile_ladder([pp.decoded for pp in pps], ladder, chunk=chunk,
                        interval=interval, trace_cap=cap, shard=shard,
                        device=device)
    return ladder


def hook_invocations(state: M.MachineState) -> int:
    """Total hook executions across mechanisms (COUNTER word + ptrace
    count), for one process or summed over a fleet."""
    if state.mem.dim() == 2:  # batched fleet state: sum over lanes
        return int(F.fleet_counters(state).sum())
    counter = int(state.mem[(L.COUNTER - L.DATA_BASE) // 8])
    return counter + int(state.hook_count)
