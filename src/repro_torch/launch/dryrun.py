"""Multi-pod dry run: trace every (arch x shape x mesh) cell's real step on
a fake world and read a per-rank roofline from the operators it ran.

The JAX package's ``launch/dryrun.py``.  Run as a script
(``python -m repro_torch.launch.dryrun``): it brings up a fake process
group of 256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``:
no communication) as rank 0, which must not share a process with a real
world.  Per cell this:

  * builds the production mesh (16x16, or 2x16x16 with ``--multi-pod``)
    as a ``DeviceMesh`` on the device type;
  * makes the state and inputs as DTensors over fake local shards
    (:mod:`repro_torch.launch.specs`: shapes, no memory);
  * runs the real step once — ``make_train_step`` for train shapes,
    ``make_serve_steps``' prefill or decode for the others — under
    ``FakeTensorMode``, the mesh, ``implicit_replication()`` and
    :func:`repro_torch.models.layers.xla_route`, inside
    :func:`repro_torch.launch.opanalysis.analyze`: sharding mismatches and
    propagation failures surface here;
  * records the rank's live bytes at their peak (``fits_hbm`` against the
    H100's memory), the dot FLOPs, the unfused HBM bytes and the
    collectives' wire bytes, and the roofline terms with H100 datasheet
    figures (:data:`opanalysis.HW`): predictions, not measurements;
  * appends the cell to a JSON results file (default under the git-ignored
    ``build/``).

With ``--all`` each (arch x shape) cell traces in a child process of its
own, ``--workers`` at a time: a fake world per process, and a cell still
tracing after ``--timeout`` seconds is stopped and recorded as ``FAIL``
with its time.  Every cell of every arch traces on both meshes.
``scripts/torch_dryrun_table.py`` renders the results as a table.

A loop over time (:func:`repro_torch.loops.time_loop`: the sLSTM's
4,096 steps at ``train_4k`` and 32,768 at ``prefill_32k``, the chunked
mLSTM's chunks) is counted as the JAX package's ``hloanalysis`` counts a
``while`` loop: one traced step's operators times its trip count,
forward and backward (:func:`opanalysis.analyze`); ``while_trips``
lists the loops' trip counts.

Every cell, serve cells included, traces the model's plain (XLA) forms:
the port's kernels take raw pointers and can take neither fake tensors nor
DTensors, and the JAX dry run lowers the same XLA forms (its model never
reaches a Pallas kernel).  On the CPU (``--device cpu``) the trace also
runs under :func:`repro_torch.numerics.card_forms`, so it counts the
card's arithmetic, not the CPU's exact forms.  A step's JSON keys and
printed line are the JAX dry run's, except ``trace_s`` for
``compile_s`` and no ``cost_analysis_*``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .. import numerics
from ..configs import (ARCHS, applicable_shapes, get_config, get_smoke,
                       shape_by_name)
from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..core.machine import resolve_device
from ..models import layers
from ..obs.metrics import now as obs_now
from ..parallel.sharding import set_sharding_mode
from ..train.step import make_serve_steps, make_train_step
from . import specs as sp
from .mesh import make_production_mesh, mesh_context
from .opanalysis import HW, analyze, roofline_terms

# torch.cuda.get_device_properties(0).total_memory of "NVIDIA H100 80GB
# HBM3" (700 W)
HBM_PER_CHIP = 85_017_493_504


def dryrun_runconfig(**overrides) -> RunConfig:
    base = dict(remat_policy="nothing", attn_chunk=1024, mlstm_chunk=256,
                decode_budget=0, grad_compression="none", z_loss=1e-4,
                loss_chunk=512)
    base.update(overrides)
    return RunConfig(**base)


def model_flops_per_step(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D forward-only."""
    n = cfg.n_active_params()
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * shape.tokens_per_step)


def fake_world(n_ranks: int) -> None:
    """The default process group as rank 0 of a fake world of
    ``n_ranks`` (brought up anew if it has another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _shardwise_rule(op, touched) -> None:
    """Register DTensor's rule for ``op``: each rank applies it to its own
    shard of a dimension it leaves whole (sharded there, or replicated);
    ``touched(x, *args)`` names the dimensions it changes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    def strategy(op_schema):
        x, *args = op_schema.args_schema
        changed = touched(x, *args)
        single = [[Replicate(), Replicate()]] + [
            [Shard(d), Shard(d)] for d in range(x.ndim) if d not in changed]
        return expand_to_full_mesh_op_strategy(
            op_schema.get_mesh_from_args(), op_schema, single)

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo(1))  # its other arguments are static


def dtensor_rules() -> None:
    """The rules the card's torch (2.11) lacks on a mesh of two or more
    dimensions: a constant pad (it suggests one placement a tensor where
    the mesh needs one a dimension) and a flip (none; a cumulative sum's
    backward flips its gradient)."""
    _shardwise_rule(torch.ops.aten.constant_pad_nd.default,
                    lambda x, pad, *_: {x.ndim - 1 - i // 2
                                        for i, w in enumerate(pad) if w})
    _shardwise_rule(torch.ops.aten.flip.default,
                    lambda x, dims: {d % x.ndim for d in dims})


def trace_cell(arch: str, shape_name: str, *, multi_pod: bool,
               run: Optional[RunConfig] = None, smoke: bool = False,
               device=None):
    """(cfg, shape, stats): one step of the cell traced on the fake world
    under :func:`opanalysis.analyze`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    shape = shape_by_name(shape_name)
    if smoke:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 512),
                                    global_batch=min(shape.global_batch, 32))
    run = run or dryrun_runconfig()
    set_sharding_mode(run.sharding_mode)
    fake_world(512 if multi_pod else 256)
    dtensor_rules()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)

    with FakeTensorMode(), mesh_context(mesh), implicit_replication(), \
            layers.xla_route(), (numerics.card_forms() if dev.type == "cpu"
                                 else contextlib.nullcontext()):
        if shape.kind == "train":
            state, batch, _ = sp.train_inputs(cfg, run, shape, mesh, dev)
            stats = analyze(make_train_step(cfg, run), state, batch)
        elif shape.kind == "prefill":
            params, batch, _ = sp.prefill_inputs(cfg, run, shape, mesh, dev)
            prefill_step, _ = make_serve_steps(cfg, run)
            stats = analyze(prefill_step, params, batch)
        else:  # decode
            params, cache, tokens, pos, _, _ = sp.decode_inputs(
                cfg, run, shape, mesh, dev)
            _, decode_step = make_serve_steps(cfg, run)
            stats = analyze(decode_step, params, cache, tokens, pos)
    return cfg, shape, stats


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             run: Optional[RunConfig] = None, smoke: bool = False,
             label: str = "", device=None) -> Dict[str, Any]:
    t0 = obs_now()
    chips = 512 if multi_pod else 256
    cell: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "label": label,
    }
    try:
        cfg, shape, stats = trace_cell(arch, shape_name, multi_pod=multi_pod,
                                       run=run, smoke=smoke, device=device)
    except Exception as e:  # a failure here is a bug in the system
        cell.update(status="FAIL", error=f"{type(e).__name__}: {e}"[:2000],
                    traceback=traceback.format_exc()[-2000:])
        return cell

    terms = roofline_terms(stats)
    model_fl = model_flops_per_step(cfg, shape) / chips  # per device
    cell.update(
        status="OK",
        trace_s=round(obs_now() - t0, 1),
        bytes_per_device=int(stats.peak_bytes),
        peak_bytes_per_device=int(stats.peak_bytes),
        fits_hbm=bool(stats.peak_bytes <= HBM_PER_CHIP),
        argument_bytes=int(stats.argument_bytes),
        temp_bytes=int(stats.peak_bytes - stats.argument_bytes),
        hlo_dot_flops_per_device=int(stats.dot_flops),
        hlo_mem_bytes_per_device=int(stats.mem_bytes),
        collective_wire_bytes_per_device=int(stats.collective_wire_bytes),
        collectives={k: dataclasses.asdict(v)
                     for k, v in stats.collectives.items()},
        wire_bytes_by_group_size={str(k): v
                                  for k, v in stats.by_group_size.items()},
        mem_by_kind={k: v for k, v in sorted(stats.mem_by_kind.items(),
                                             key=lambda kv: -kv[1])[:12]},
        while_trips=stats.while_trips,
        roofline=terms.to_dict(),
        model_flops_per_device=model_fl,
        useful_flops_ratio=(model_fl / stats.dot_flops
                            if stats.dot_flops else 0.0),
        roofline_fraction=((model_fl / HW.peak_flops) / terms.bound_s
                           if terms.bound_s > 0 else 0.0),
    )
    return cell


def _parse_overrides(pairs) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
            continue
        for conv in (int, float):
            try:
                overrides[k] = conv(v)
                break
            except ValueError:
                pass
        else:
            overrides[k] = v
    return overrides


def _child(args, arch: str, shape: str, meshes, tmp) -> list:
    """The cell ``(arch, shape)`` traced on ``meshes`` by a child process
    (``args``' options); its results, with a ``FAIL`` cell for each mesh
    it did not finish (stopped at ``args.timeout`` or exited)."""
    out = pathlib.Path(tmp) / f"{arch}_{shape}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out), "--label", args.label]
    cmd += ["--both-meshes"] if len(meshes) == 2 else (
        ["--multi-pod"] if meshes[0] else [])
    if args.smoke:
        cmd.append("--smoke")
    if args.device:
        cmd += ["--device", args.device]
    for kv in args.set:
        cmd += ["--set", kv]
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = obs_now()
    try:
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=args.timeout)
        why = f"exit {res.returncode}: {res.stderr[-1500:]}"
        print(res.stdout, end="", flush=True)
    except subprocess.TimeoutExpired:
        why = f"TimeoutExpired: not traced within {args.timeout:g} s"
    cells = json.loads(out.read_text()) if out.exists() else []
    done = {c["mesh"] for c in cells}
    for mp in meshes:
        mesh = "2x16x16" if mp else "16x16"
        if mesh not in done:
            cells.append({"arch": arch, "shape": shape, "mesh": mesh,
                          "label": args.label, "status": "FAIL",
                          "error": why, "trace_s": round(obs_now() - t0, 1)})
            print(f"=== {arch} × {shape} × {mesh}\n  FAIL: {why}",
                  flush=True)
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every applicable (arch x shape) cell, each in a "
                         "child process")
    ap.add_argument("--workers", type=int, default=1,
                    help="with --all: cells traced at a time")
    ap.add_argument("--timeout", type=float, default=600,
                    help="with --all: seconds before a cell is stopped")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI-speed sanity pass)")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--label", default="baseline")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="RunConfig override, e.g. --set attn_chunk_remat=1")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the "
                         "card; 'cpu' to trace on the CPU)")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.set)
    run = dryrun_runconfig(**overrides) if overrides else None
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    def record(cell):
        # replace any previous entry for the same cell+label
        nonlocal results
        key = (cell["arch"], cell["shape"], cell["mesh"], cell.get("label"))
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"], r.get("label"))
                   != key]
        results.append(cell)
        out_path.write_text(json.dumps(results, indent=1))

    if args.all:
        cells = [(arch, shape.name) for arch in ARCHS
                 for shape in applicable_shapes(get_config(arch))]
        with tempfile.TemporaryDirectory() as tmp, \
                ThreadPoolExecutor(args.workers) as ex:
            for done in ex.map(lambda c: _child(args, *c, meshes, tmp),
                               cells):
                for cell in done:
                    record(cell)
        return
    assert args.arch and args.shape, "--arch/--shape or --all"
    for mp in meshes:  # a fake world of the mesh's size (fake_world)
        print(f"=== {args.arch} × {args.shape} × "
              f"{'2x16x16' if mp else '16x16'}", flush=True)
        cell = run_cell(args.arch, args.shape, multi_pod=mp,
                        smoke=args.smoke, run=run, label=args.label,
                        device=args.device)
        record(cell)
        if cell["status"] == "OK":
            r = cell["roofline"]
            print(f"  OK trace={cell['trace_s']}s "
                  f"mem={cell['bytes_per_device']/2**30:.2f}GiB "
                  f"fits={cell['fits_hbm']} dominant={r['dominant']} "
                  f"terms(c/m/n)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
                  f"{r['collective_s']:.2e}s "
                  f"roofline_frac={cell['roofline_fraction']:.3f}",
                  flush=True)
        else:
            print(f"  FAIL: {cell['error']}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
