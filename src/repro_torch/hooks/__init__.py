"""ASC-Hook adapted to per-rank distributed programs: transparent
collective interception on ``torch.distributed``."""
from .completeness import (CompletenessReport, backend_collective_census,
                           completeness_report)
from .handlers import (CastCompressHandler, RSAGHandler, TraceHandler,
                       virtualize)
from .interceptor import COLLECTIVE_PRIMS, hook_collectives, hooking
from .scanner import CollectiveSite, census_fn

__all__ = [
    "COLLECTIVE_PRIMS", "CastCompressHandler", "CollectiveSite",
    "CompletenessReport", "RSAGHandler", "TraceHandler",
    "backend_collective_census", "census_fn", "completeness_report",
    "hook_collectives", "hooking", "virtualize",
]
