"""What every cell shares: finding a cell's files by name, the metrics
``BENCHMARK.json`` asks of it, and the result line.

A cell is ``workloads/<name>.json``; it names its configuration,
``configs/<config>.json``, and its traffic: the driver that runs it,
``drivers/<driver>.py``, and the parameters that driver reads.  A driver
runs configurations of the ``kind``s it lists and reads exactly the
``params`` keys it declares; a cell that gives another key, or leaves
one out, is refused when it is loaded.  A per-layer metric is
``metrics/<metric>.py`` with a ``read(ctx)`` that returns a number, or
None where the traced run holds nothing for it.  Adding a cell, a
configuration or a metric adds files; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"

# whole top-level module names no run may load (the JAX package, JAX, and
# the repo's scripts outside the benchmark)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "scripts",
             "benchmarks")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def workload_names(root: Path = HERE) -> List[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


# the keys of a cell's file
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why", "driver",
                 "params"}


def load_workload(name: str, root: Path = HERE) -> Dict[str, Any]:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} is missing (cells: "
                         f"{', '.join(workload_names(root))})")
    wl = load_json(path)
    if wl.get("name") != name:
        raise SystemExit(f"{path} names {wl.get('name')!r}, not {name!r}")
    if set(wl) != WORKLOAD_KEYS:
        raise SystemExit(f"{path}: keys {sorted(set(wl))}, want "
                         f"{sorted(WORKLOAD_KEYS)}")
    return wl


def load_config(name: str, root: Path = HERE) -> Dict[str, Any]:
    return load_json(root / "configs" / f"{name}.json")


def driver_for(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def load_cell(name: str, root: Path = HERE):
    """(workload, configuration, driver module) of a cell, its driver
    able to run the configuration and its ``params`` what the driver
    reads."""
    wl = load_workload(name, root)
    cfg = load_config(wl["config"], root)
    drv = driver_for(wl["driver"])
    if cfg["kind"] not in drv.KINDS:
        raise SystemExit(f"cell {name!r}: driver {wl['driver']!r} runs "
                         f"{drv.KINDS}, not a {cfg['kind']!r} configuration")
    given, want = set(wl["params"]), set(drv.PARAMS)
    if given != want:
        raise SystemExit(
            f"cell {name!r}: driver {wl['driver']!r} reads the params "
            f"{sorted(want)}; unread {sorted(given - want)}, missing "
            f"{sorted(want - given)}")
    for k, ok in drv.PARAMS.items():
        if not ok(wl["params"][k]):
            raise SystemExit(f"cell {name!r}: params.{k} = "
                             f"{wl['params'][k]!r} is not one the driver "
                             f"{wl['driver']!r} takes")
    return wl, cfg, drv


def positive_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: Dict[str, Any], cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``spec`` asks of ``cell``: an
    entry with ``workloads`` only in those cells; a per-layer one without
    it in every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    mods = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in mods}
    return sorted(tops.intersection(FORBIDDEN))


def metric_entry(value: float, unit: str) -> Dict[str, Any]:
    if not (isinstance(value, (int, float)) and math.isfinite(value)):
        raise ValueError(f"metric value {value!r} is not a finite number")
    return {"value": float(value), "unit": unit}


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: List[dict],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The last line of standard output; ``checks`` (each number compared
    beside its limit) comes last."""
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted,
                           "failed": failed, "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check(name: str, value: float, limit: float) -> Dict[str, Any]:
    """A number compared with its limit: it passes at or under it."""
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit)}
