"""Completeness check: the hook's census against the backend's own record
(the JAX package's ``repro.hooks.completeness``).

The hook sees every collective dispatched while it is active; the JAX
package's lower census is the compiled HLO, where the SPMD partitioner
inserts collectives the trace-time hook never saw.  An eager program has
no compiled form: here the lower census is what the process-group backend
ran, from the profiler's events (``gloo:all_reduce``, ``nccl:all_reduce``,
...).  What the hook cannot see — a collective issued before the hook was
entered, of a kind the hook has no entry for (a barrier, a broadcast), on
a thread the hook was not entered on (which the profiler records only if
it follows that thread: autograd's and the backend's own, not a plain
Python thread) — is this world's indirect jump.  Both sides count *executions* (a site weighted by its trip count
against the backend's events): an eager run has no static program to
count sites in.  Only an excess marks collectives the hook did not see,
as in JAX.

``hlo_collective_census`` has no input here; ``backend_collective_census``
takes its place and maps the backend's names to HLO's kinds, so the report
keeps the JAX package's keys.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable

# a backend's record of one collective: "gloo:all_reduce",
# "nccl:_all_gather_base", "nccl:all_to_all", ...
_EVENT_RE = re.compile(r"^(gloo|nccl):(\w+)$")

_PRIM_TO_HLO = {
    "psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
    "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all", "ppermute": "collective-permute",
}


def _kind(op: str) -> str:
    """HLO's kind for a backend operation (its own name if HLO has none:
    a barrier, a rooted reduce or gather)."""
    word = op.replace("_", "").lower()
    for part, kind in (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                       ("reducescatter", "reduce-scatter"),
                       ("alltoall", "all-to-all"),
                       ("broadcast", "collective-broadcast")):
        if part in word:
            return kind
    if word in ("send", "recv", "recvanysource"):
        return "collective-permute"
    return op


def backend_collective_census(prof) -> Dict[str, int]:
    """Count the collectives a process-group backend ran, by HLO kind, from
    a ``torch.profiler.profile`` (or an iterable of event names)."""
    names: Iterable = prof.events() if hasattr(prof, "events") else prof
    counts: Dict[str, int] = {}
    for e in names:
        m = _EVENT_RE.match(getattr(e, "name", e))
        if m:
            k = _kind(m.group(2))
            counts[k] = counts.get(k, 0) + 1
    return counts


@dataclasses.dataclass
class CompletenessReport:
    census_counts: Dict[str, int]         # HLO kind -> hooked executions
    backend_counts: Dict[str, int]        # HLO kind -> backend executions
    partitioner_inserted: Dict[str, int]  # HLO kind -> excess count

    @property
    def fully_hooked(self) -> bool:
        return not any(v > 0 for v in self.partitioner_inserted.values())


def completeness_report(census: Dict, backend_counts: Dict[str, int]
                        ) -> CompletenessReport:
    """Diff the hooked executions (``census_fn``'s sites, each weighted by
    its trip count) against the backend's.

    The backend's counts can legitimately be *lower* (a backend that
    records no event for a kind: gloo's reduce-scatter) — only an excess
    marks collectives the hook did not see.
    """
    hooked: Dict[str, int] = {}
    for s in census.get("sites", ()):
        kind = _PRIM_TO_HLO.get(s.primitive)
        if kind:
            hooked[kind] = hooked.get(kind, 0) + s.loop_trip
    excess = {k: max(0, backend_counts.get(k, 0) - hooked.get(k, 0))
              for k in set(backend_counts) | set(hooked)}
    return CompletenessReport(census_counts=hooked,
                              backend_counts=dict(backend_counts),
                              partitioner_inserted=excess)
