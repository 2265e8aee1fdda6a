"""The port's public surface against the JAX package's, and the pieces of
it that closed the last gaps.

* The surface, read with ``ast`` from both source trees (neither package
  is imported for it): every public top-level function and class of
  ``src/repro/``, each class's public methods and fields, every name a
  package's ``__init__`` exports and every parameter of a public
  function or method has a counterpart of the same name in the same
  module of ``src/repro_torch/`` (``launch/hloanalysis.py``'s is
  ``launch/opanalysis.py``).  The JAX-IR-only names are the exceptions
  (``EXCEPTIONS``): each names its counterpart in the port, which must
  exist, or says why none is needed, and each must still be a gap.
* ``RunConfig.attn_act_constraints``: on the 16x16 fake world (a child
  process) q, k and v reach a SMOKE ``train_4k`` cell's attention in the
  layouts the JAX model constrains them to (``head_axes`` as the JAX
  package names them for the same config and mesh sizes), also at
  qwen3-1.7b's 16 query to 8 K/V heads (q by heads, K/V by head_dim), and
  the cell traces ``OK``; with the lever off they are as before, and so
  are the cell's counts, and those of a ``decode_32k`` cell.
* The rope on the CPU equals the JAX package's bit for bit at 512
  positions (the C library's powf, cosf and sinf, XLA's contraction).
* ``core.fleet_step`` and ``fleet_step_traced`` against the JAX package's,
  step by step for ~100 steps on three lanes of mixed programs, every
  ``MachineState`` and ``TraceState`` leaf bit for bit; the untraced
  state equal to the traced one under all-ALLOW policies.
* ``repro_torch.emul`` exports the JAX package's ten names, imported
  first in a fresh process (the engine and ``core`` import each other).
* ``CheckpointManager.restore_latest(sharding_tree=)`` on a two-rank gloo
  world (child processes on a ``FileStore``): every leaf a ``DTensor``
  with the placements asked for, each rank's local tensor its slice of
  the saved array bit for bit, and the restored tree saved again gives
  the same manifest.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Mechanism as JMechanism
from repro.core import fleet as jfleet
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core.machine import MachineState as JMachineState
from repro.parallel import sharding as jsharding
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import (Mechanism, fleet_step, fleet_step_traced,
                              interop, pack_fleet, prepare, programs)
from repro_torch.core.fleet import TraceState
from repro_torch.core.machine import MachineState
from repro_torch.train.step import init_train_state

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
RENAMED = {"launch/hloanalysis.py": "launch/opanalysis.py"}

_NO_TILES = ("Pallas tile sizes and interpret mode: the CUDA kernel "
             "chooses its own tiling, and CPU tensors take the plain "
             "version by their device")
_HLO = ("HLO-text parsing: the port counts operators as they dispatch "
        "(opanalysis.analyze)")
_KEY = ("a jax.random key: the port draws from a torch.Generator")
# JAX name (module:name, module:Class.member or module:func(param)) ->
# (its counterpart in the port, in the same notation, or None; why)
EXCEPTIONS = {
    "hooks/__init__.py:scan_jaxpr": (
        "hooks/scanner.py:census_fn",
        "no jaxpr: census_fn runs the function once on clones under the "
        "hook"),
    "hooks/scanner.py:scan_jaxpr": (
        "hooks/scanner.py:census_fn",
        "no jaxpr: census_fn runs the function once on clones under the "
        "hook"),
    "hooks/__init__.py:hlo_collective_census": (
        "hooks/completeness.py:backend_collective_census",
        "no HLO: the backend's own record of the collectives it ran"),
    "hooks/completeness.py:hlo_collective_census": (
        "hooks/completeness.py:backend_collective_census",
        "no HLO: the backend's own record of the collectives it ran"),
    "hooks/completeness.py:CompletenessReport.jaxpr_counts": (
        "hooks/completeness.py:CompletenessReport.census_counts",
        "hooked executions from census_fn, not jaxpr sites"),
    "hooks/completeness.py:CompletenessReport.hlo_counts": (
        "hooks/completeness.py:CompletenessReport.backend_counts",
        "the backend's executions, not compiled HLO"),
    "hooks/completeness.py:completeness_report(jaxpr_census)": (
        "hooks/completeness.py:completeness_report(census)",
        "census_fn's census in place of the jaxpr census"),
    "hooks/completeness.py:completeness_report(hlo_text)": (
        "hooks/completeness.py:completeness_report(backend_counts)",
        "backend_collective_census's counts in place of HLO text"),
    "launch/mesh.py:shard_map_fn": (
        "train/step.py:make_ddp_train_step",
        "the port's collective programs are written per rank, which is "
        "what a shard_map body is"),
    "launch/dryrun.py:lower_cell": (
        "launch/dryrun.py:trace_cell",
        "no lowering: the step is traced on fake tensors"),
    "launch/hloanalysis.py:shape_bytes": ("launch/opanalysis.py:analyze",
                                          _HLO),
    "launch/hloanalysis.py:Op": ("launch/opanalysis.py:analyze", _HLO),
    "launch/hloanalysis.py:Computation": ("launch/opanalysis.py:analyze",
                                          _HLO),
    "launch/hloanalysis.py:parse_module": ("launch/opanalysis.py:analyze",
                                           _HLO),
    "launch/hloanalysis.py:HloStats": ("launch/opanalysis.py:OpStats",
                                       "the counted statistics, by operator"),
    "launch/hloanalysis.py:analyze(text)": (
        "launch/opanalysis.py:analyze(fn)",
        "the step itself, run under the counter, in place of HLO text"),
    "kernels/megastep/kernel.py:default_interpret": (
        None, "no interpret mode: CPU tensors take the plain version"),
    "kernels/megastep/kernel.py:megastep_chunk": (
        "kernels/megastep/ops.py:megastep_chunk",
        "the launch and its count live in the wrapper"),
    "kernels/megastep/ops.py:megastep": (
        "kernels/megastep/ops.py:megastep_chunk",
        "one chunk of steps; impl= is the tensors' device"),
    "kernels/megastep/ops.py:jitted_run": (
        "kernels/megastep/ops.py:run",
        "no jit cache: run is eager, traced when given a trace carry"),
    "kernels/megastep/ops.py:jitted_run_traced": (
        "kernels/megastep/ops.py:run",
        "no jit cache: run is eager, traced when given a trace carry"),
    "kernels/megastep/ops.py:jitted_span": (
        "kernels/megastep/ops.py:span",
        "no jit cache: span is eager, traced when given a trace carry"),
    "kernels/megastep/ops.py:jitted_span_traced": (
        "kernels/megastep/ops.py:span",
        "no jit cache: span is eager, traced when given a trace carry"),
    "kernels/flash_attention/kernel.py:flash_attention_3d": (
        "kernels/flash_attention/kernel.py:flash_attention_cuda",
        "the CUDA kernel's launch"),
    "kernels/flash_attention/ops.py:flash_attention(bq)": (None, _NO_TILES),
    "kernels/flash_attention/ops.py:flash_attention(bk)": (None, _NO_TILES),
    "kernels/flash_attention/ops.py:flash_attention(interpret)": (
        None, _NO_TILES),
    "kernels/flash_attention/ops.py:flash_attention(impl)": (
        None, _NO_TILES),
    "kernels/decode_attention/kernel.py:decode_attention_3d": (
        "kernels/decode_attention/kernel.py:decode_attention_cuda",
        "the CUDA kernel's launch"),
    "kernels/decode_attention/ops.py:decode_attention(bk)": (
        "kernels/decode_attention/ops.py:split_count", _NO_TILES),
    "kernels/decode_attention/ops.py:decode_attention(interpret)": (
        None, _NO_TILES),
    "kernels/decode_attention/ops.py:decode_attention(impl)": (
        None, _NO_TILES),
    "kernels/rglru_scan/kernel.py:rglru_scan": (
        "kernels/rglru_scan/kernel.py:rglru_scan_cuda",
        "the CUDA kernel's launch"),
    "kernels/rglru_scan/ops.py:rglru": (
        "kernels/rglru_scan/ops.py:rglru_scan",
        "the wrapper, named after the kernel"),
    "kernels/mlstm_chunk/kernel.py:mlstm_chunk": (
        "kernels/mlstm_chunk/kernel.py:mlstm_prefill_cuda",
        "the CUDA kernels' launch (mlstm_decode_cuda for one token)"),
    "kernels/mlstm_chunk/ops.py:mlstm": (
        "kernels/mlstm_chunk/ops.py:mlstm_chunk",
        "the wrapper, named after the kernel; the state carried in and "
        "out"),
    "models/layers.py:dense_init(key)": (
        "models/layers.py:dense_init(gen)", _KEY),
    "models/layers.py:init_attn(key)": (
        "models/layers.py:init_attn(gen)", _KEY),
    "models/layers.py:init_mlp(key)": ("models/layers.py:init_mlp(gen)",
                                       _KEY),
    "models/lm.py:init_params(key)": ("models/lm.py:init_params(gen)", _KEY),
    "models/moe.py:init_moe(key)": ("models/moe.py:init_moe(gen)", _KEY),
    "models/recurrent.py:init_rglru(key)": (
        "models/recurrent.py:init_rglru(gen)", _KEY),
    "models/recurrent.py:init_mlstm(key)": (
        "models/recurrent.py:init_mlstm(gen)", _KEY),
    "models/recurrent.py:init_slstm(key)": (
        "models/recurrent.py:init_slstm(gen)", _KEY),
    "train/step.py:init_train_state(key)": (
        "train/step.py:init_train_state(gen)", _KEY),
    "core/fleet.py:exec_lanes(tbl)": (
        "core/fleet.py:tables_for",
        "Pallas passes the op-spec tables as kernel refs; the eager step "
        "takes tables_for(device), and the CUDA kernel has its own"),
    "train/loop.py:run_training(donate)": (
        None, "buffer donation is XLA's: the port's step updates its state "
              "in place"),
}


# -- the surface, read with ast ----------------------------------------------

def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _targets(node) -> list:
    ts = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in ts for n in ast.walk(t) if isinstance(n, ast.Name)]


def _bound(nodes) -> set:
    """Names a module body binds: definitions, assignments, imports (also
    under ``if``/``try``)."""
    out = set()
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            out |= _bound([n for b in ("body", "orelse", "finalbody")
                           for n in getattr(node, b, [])]
                          + [n for h in getattr(node, "handlers", [])
                             for n in h.body])
    return out


def surface(path: pathlib.Path) -> dict:
    """{"bound": names, "funcs": {name: params}, "classes": {name:
    {member: params or None}}, "exports": names or None}."""
    body = ast.parse(path.read_text()).body
    out = {"bound": _bound(body), "funcs": {}, "classes": {},
           "exports": None}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out["funcs"][node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            members = {}
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members[b.name] = _params(b)
                elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                    members.update(dict.fromkeys(_targets(b)))
            out["classes"][node.name] = members
        elif (isinstance(node, ast.Assign)
              and "__all__" in _targets(node)):
            out["exports"] = [ast.literal_eval(e) for e in node.value.elts]
    if path.name == "__init__.py" and out["exports"] is None:
        out["exports"] = sorted(n for n in out["bound"]
                                if not n.startswith("_"))
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface() -> dict:
    """{(module, item): port module} for every public item of the JAX
    package: ``name``, ``Class.member`` or ``func(param)``."""
    items = {}
    for jp in sorted((SRC / "repro").rglob("*.py")):
        rel = jp.relative_to(SRC / "repro").as_posix()
        mod, port = surface(jp), RENAMED.get(rel, rel)
        for e in mod["exports"] if rel.endswith("__init__.py") else []:
            items[(rel, e)] = port
        for f, ps in mod["funcs"].items():
            if _public(f):
                items[(rel, f)] = port
                items.update({(rel, f"{f}({p})"): port for p in ps})
        for c, members in mod["classes"].items():
            if not _public(c):
                continue
            items[(rel, c)] = port
            for m, ps in members.items():
                if _public(m) or m == "__init__":
                    if m != "__init__":
                        items[(rel, f"{c}.{m}")] = port
                    items.update({(rel, f"{c}.{m}({p})"): port
                                  for p in ps or ()})
    return items


_PORT = {}


def has(port_module: str, item: str) -> bool:
    """Whether ``item`` (``name``, ``Class.member``, ``func(param)``,
    ``Class.method(param)``) exists in the port's module."""
    path = SRC / "repro_torch" / port_module
    if not path.exists():
        return False
    if port_module not in _PORT:
        _PORT[port_module] = surface(path)
    mod = _PORT[port_module]
    name, _, param = item.partition("(")
    param = param.rstrip(")")
    owner, _, member = name.partition(".")
    if owner not in mod["bound"] and owner not in (mod["exports"] or ()):
        return False
    if member:
        members = mod["classes"].get(owner)
        if members is None or member not in members:
            return False
        return not param or param in (members[member] or ())
    if param:
        return param in mod["funcs"].get(owner, ())
    return True


def gaps() -> list:
    """The JAX items without a counterpart; a missing function's
    parameters and a missing class's members are the owner's gap."""
    items = jax_surface()
    missing = {(rel, item) for (rel, item), port in items.items()
               if not has(port, item)}

    def owner_missing(rel, item):
        owner = item.split("(")[0]
        owners = {owner.split(".")[0], owner} - {item}
        return any((rel, o) in missing for o in owners)

    return sorted(f"{rel}:{item}" for rel, item in missing
                  if not owner_missing(rel, item))


def test_every_public_name_has_a_counterpart():
    """The JAX package's public surface is the port's, but for the
    exceptions; the surface walked is the whole package."""
    items = jax_surface()
    assert len(items) > 900 and len({rel for rel, _ in items}) > 70
    missing = [g for g in gaps() if g not in EXCEPTIONS]
    assert not missing, f"no counterpart in src/repro_torch/: {missing}"


def test_every_exception_is_a_gap_with_a_counterpart_or_a_reason():
    got = set(gaps())
    stale = sorted(set(EXCEPTIONS) - got)
    assert not stale, f"exceptions that are no longer gaps: {stale}"
    for name, (counterpart, why) in EXCEPTIONS.items():
        assert why and len(why) > 20, name
        if counterpart is not None:
            mod, _, item = counterpart.partition(":")
            assert has(mod, item), (name, counterpart)


def test_the_walk_sees_the_items_it_checks():
    """The reader finds a function's parameters, a class's members and a
    package's exports, in both trees."""
    items = jax_surface()
    for item in [("core/fleet.py", "fleet_step(img)"),
                 ("core/__init__.py", "fleet_step_traced"),
                 ("emul/__init__.py", "KernelState"),
                 ("checkpoint/manager.py",
                  "CheckpointManager.restore_latest(sharding_tree)"),
                 ("hooks/completeness.py", "CompletenessReport.hlo_counts"),
                 ("launch/hloanalysis.py", "analyze(text)"),
                 ("core/fleet.py", "exec_lanes(tbl)")]:
        assert item in items, item
    assert has("checkpoint/manager.py",
               "CheckpointManager.restore_latest(sharding_tree)")
    assert has("core/fleet.py", "exec_lanes(act)")
    assert not has("core/fleet.py", "exec_lanes(tbl)")
    assert not has("core/fleet.py", "fleet_step(nothing)")
    assert not has("emul/__init__.py", "NotAName")


# -- attn_act_constraints on the fake world ----------------------------------

ATTN_ARCH = "qwen3-1.7b"
# SMOKE's 4 heads of 16 (2 K/V heads), and qwen3-1.7b's own 16 query heads
# to 8 K/V heads at SMOKE's head_dim: q laid out by heads, K/V by head_dim
GQA = {"n_heads": 16, "n_kv_heads": 8, "head_dim": 16}
ATTN_CHILD = r"""
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.parallel import sharding
arch, cases = sys.argv[1], json.loads(sys.argv[2])
seen, orig, out = [], lm.attention, {}

def spy(q, k, v, **kw):
    seen.append([[repr(p) for p in t.placements] for t in (q, k, v)])
    out["want"] = [[repr(p) for p in sharding.placements(q.device_mesh, a)]
                   for a in want_axes]
    return orig(q, k, v, **kw)

lm.attention = spy
smoke = configs.get_smoke
for name, shape, over, on, want_axes in cases:
    seen.clear()
    dryrun.get_smoke = lambda a: dataclasses.replace(smoke(a), **over)
    cell = dryrun.run_cell(arch, shape, multi_pod=False, smoke=True,
                           device="cpu", run=dryrun.dryrun_runconfig(
                               attn_act_constraints=on))
    out[name] = {"status": cell["status"], "error": cell.get("error"),
                 "seen": list(seen), "want": out.pop("want"),
                 "dot": cell.get("hlo_dot_flops_per_device"),
                 "wire": cell.get("collective_wire_bytes_per_device"),
                 "peak": cell.get("peak_bytes_per_device")}
print(json.dumps(out))
"""
# the cells with the lever off, as the port traced them before the lever
# was read: in train_4k q and k laid out by their flat projections, v by
# head_dim; in decode_32k (no lever there) q by its projection, the
# cache's K/V by head_dim; their counts
LEVER_OFF = {"seen": [["Shard(dim=0)", "Replicate()"],
                      ["Shard(dim=0)", "Replicate()"],
                      ["Shard(dim=0)", "Shard(dim=3)"]],
             "dot": 628_084_736, "wire": 41_802_959}
DECODE_OFF = {"seen": [["Shard(dim=0)", "Replicate()"],
                       ["Shard(dim=0)", "Shard(dim=3)"],
                       ["Shard(dim=0)", "Shard(dim=3)"]],
              "dot": 116_736, "wire": 106_620, "peak": 79_264}


def jax_head_layouts(cfg, sizes) -> list:
    """The specs JAX's ``_self_attention`` constrains q, k and v to under
    the lever (src/repro/models/lm.py:196-198), named by the JAX package's
    own ``head_axes`` for a mesh of ``sizes``."""
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 axis_sizes=tuple(sizes.values()))
    real = jsharding.abstract_mesh
    jsharding.abstract_mesh = lambda: mesh
    try:
        h_ax, hd_ax = jsharding.head_axes(cfg.n_heads, cfg.hd)
        kvh_ax, kvhd_ax = jsharding.head_axes(cfg.n_kv_heads, cfg.hd)
        data = list(jsharding.data_axes())
    finally:
        jsharding.abstract_mesh = real
    return [[data, None, h_ax, hd_ax], [data, None, kvh_ax, kvhd_ax],
            [data, None, kvh_ax, kvhd_ax]]


def test_attn_act_constraints_lay_out_q_k_v_as_the_jax_model():
    import dataclasses
    from repro import configs as jconfigs
    sizes = {"data": 16, "model": 16}
    base = jconfigs.get_smoke(ATTN_ARCH)
    want = jax_head_layouts(base, sizes)
    want_gqa = jax_head_layouts(dataclasses.replace(base, **GQA), sizes)
    # SMOKE's 4 heads do not divide the 16-way model axis: head_dim does;
    # at 16 heads q is laid out by heads, the 8 K/V heads by head_dim
    assert want[0][2:] == [None, "model"]
    assert [a[2:] for a in want_gqa] == [["model", None], [None, "model"],
                                         [None, "model"]]
    cases = [("off", "train_4k", {}, False, want),
             ("on", "train_4k", {}, True, want),
             ("gqa_on", "train_4k", GQA, True, want_gqa),
             ("decode_off", "decode_32k", {}, False, want)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", ATTN_CHILD, ATTN_ARCH, json.dumps(cases)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("off", "on", "gqa_on", "decode_off"):
        c = out[name]
        assert c["status"] == "OK", (name, c["error"])
        # forward and the checkpoint's recompute, two layers each; decode
        # has no backward
        assert len(c["seen"]) == (2 if name == "decode_off" else 4), name
        assert c["dot"] > 0 and c["wire"] > 0 and c["peak"] > 0, name
    for name in ("on", "gqa_on"):
        assert all(s == out[name]["want"] for s in out[name]["seen"]), name
    assert out["on"]["want"] == [["Shard(dim=0)", "Shard(dim=3)"]] * 3
    assert out["gqa_on"]["want"] == [["Shard(dim=0)", "Shard(dim=2)"],
                                     ["Shard(dim=0)", "Shard(dim=3)"],
                                     ["Shard(dim=0)", "Shard(dim=3)"]]
    off = out["off"]
    assert all(s == LEVER_OFF["seen"] for s in off["seen"])
    assert (off["dot"], off["wire"]) == (LEVER_OFF["dot"], LEVER_OFF["wire"])
    # the lever's re-layout of q stays inside the lever: the decode cache's
    # K/V on head_dim leave q and the counts as they were
    dec = out["decode_off"]
    assert all(s == DECODE_OFF["seen"] for s in dec["seen"])
    assert {k: dec[k] for k in ("dot", "wire", "peak")} == {
        k: DECODE_OFF[k] for k in ("dot", "wire", "peak")}


def test_attn_act_constraints_change_no_plain_tensor():
    """On plain tensors the constraints are the tensors themselves: the
    train forward with the lever on equals the forward with it off."""
    from repro_torch.models import lm
    cfg = configs.get_smoke(ATTN_ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int64))}
    outs = [lm.forward(cfg, configs.RunConfig(
        attn_chunk=8, remat_policy="none", attn_act_constraints=on), params,
        toks)[0] for on in (False, True)]
    assert torch.equal(outs[0], outs[1])


# -- fleet_step / fleet_step_traced -------------------------------------------

STEPS = 100


def _lanes(pkg):
    """Three lanes of mixed programs, emulation on (the default)."""
    P, M, prep = ((programs, Mechanism, prepare) if pkg == "torch"
                  else (jprograms, JMechanism, jprepare))
    return [prep(P.getpid_loop(5), M.NONE),  # halts at step 45
            prep(P.read_loop(4, 256), M.SIGNAL, virtualize=True),
            prep(P.mixed_ops(3, 128), M.PTRACE, virtualize=False)]


def _equal(want, got, fields, what):
    for f in fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def test_fleet_step_and_traced_equal_jax_every_step():
    jimgs, jids, js, jtr = jpack_fleet(_lanes("jax"), trace=True)
    timgs, tids, ts, ttr = pack_fleet(_lanes("torch"), trace=True,
                                      device="cpu")
    step, step_tr = jax.jit(jfleet.fleet_step), jax.jit(
        jfleet.fleet_step_traced)
    js_t = js
    tr_fields = jfleet.TraceState._fields
    assert TraceState._fields == tr_fields
    st = interop.state_from_numpy(interop.state_to_numpy(ts), "cpu")
    for i in range(STEPS):
        js = step(jimgs, jids, js)
        js_t, jtr = step_tr(jimgs, jids, js_t, jtr)
        ts = fleet_step(timgs, tids, ts)
        st, ttr = fleet_step_traced(timgs, tids, st, ttr)
        _equal(js, ts, JMachineState._fields, f"fleet_step, step {i}")
        _equal(js_t, st, JMachineState._fields, f"traced, step {i}")
        _equal(jtr, ttr, tr_fields, f"trace, step {i}")
        # all-ALLOW: the traced machine state is the untraced one
        for f in MachineState._fields:
            assert torch.equal(getattr(ts, f), getattr(st, f)), (i, f)
    # several svcs on every lane, and a lane that halted on the way
    assert (ttr.count.numpy() >= 4).all(), ttr.count
    assert ts.halted.tolist()[0] != 0 and ts.icount.tolist() == [45, 100,
                                                                  100]
    assert int(ttr.deny_count.sum() + ttr.kill_count.sum()) == 0


def test_fleet_step_leaves_halted_lanes_as_they_are():
    imgs, ids, s = pack_fleet(_lanes("torch"), device="cpu")
    s.halted[1] = 1
    before = interop.state_to_numpy(s)
    a = fleet_step(imgs, ids, interop.state_from_numpy(before, "cpu"))
    for f in MachineState._fields:
        assert np.array_equal(getattr(a, f)[1].numpy(), before[f][1]), f
    assert a.icount.tolist() == [1, 0, 1]


# -- repro_torch.emul's exports -----------------------------------------------

def test_emul_exports_the_jax_names_from_a_fresh_process():
    want = surface(SRC / "repro" / "emul" / "__init__.py")["exports"]
    assert len(want) == 10
    code = ("import repro_torch.emul as e; import repro_torch.core as c; "
            "from repro_torch.emul import *; "
            "print(sorted(e.__all__)); "
            "assert all(hasattr(e, n) for n in e.__all__); "
            "assert e.kern_of is e.state.kern_of; "
            "assert c.fleet.emul_engine is e.engine")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == str(sorted(want))
    from repro_torch import emul
    from repro_torch.emul import KernelState, fresh_kern
    k = fresh_kern(2)
    assert set(KernelState._fields) == {f[2:] for f in emul.KERN_FIELDS}
    assert set(k) == set(emul.KERN_FIELDS)


# -- restore_latest(sharding_tree=) on two ranks -------------------------------

RESTORE_CHILD = r"""
import json, pathlib, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.train.step import init_train_state

rank, tmp = int(sys.argv[1]), pathlib.Path(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), 2),
                        rank=rank, world_size=2)
try:
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    cfg = configs.get_smoke("qwen3-1.7b")
    like = init_train_state(cfg, configs.RunConfig(),
                            torch.Generator().manual_seed(1))

    def spec(t):   # rows split where they halve, else whole; opt.v plain
        return [Shard(0)] if t.ndim and t.shape[0] % 2 == 0 else [Replicate()]

    def tree(node, path=""):
        if isinstance(node, dict):
            return {k: tree(v, f"{path}/{k}") for k, v in node.items()}
        return None if path.startswith("/opt/v") else (mesh, spec(node))

    shardings = tree(like)
    step, got, _ = CheckpointManager(tmp / "ckpt").restore_latest(
        like, sharding_tree=shardings)
    with np.load(next((tmp / "ckpt").glob("step_*")) / "arrays.npz") as z:
        saved = dict(z)
    out = {"step": step, "leaves": 0, "sharded": 0, "plain": 0}

    def check(node, sh, path):
        if isinstance(node, dict):
            for k in node:
                check(node[k], sh[k], f"{path}/{k}" if path else k)
            return
        full = torch.from_numpy(saved[path])
        out["leaves"] += 1
        if sh is None:
            assert not isinstance(node, DTensor), path
            assert node.dtype == full.dtype and torch.equal(node, full), path
            out["plain"] += 1
            return
        assert isinstance(node, DTensor), path
        assert list(node.placements) == sh[1], (path, node.placements)
        assert node.shape == full.shape and node.dtype == full.dtype, path
        want = (full.chunk(2, 0)[rank] if sh[1] == [Shard(0)] else full)
        local = node.to_local()
        assert local.shape == want.shape, path
        assert torch.equal(local.view(-1).view(torch.uint8)
                           if local.numel() else local,
                           want.reshape(-1).view(torch.uint8)
                           if want.numel() else want), path
        out["sharded"] += sh[1] == [Shard(0)]

    check(got, shardings, "")
    # the DTensor tree saved again: the same manifest
    again = CheckpointManager(tmp / f"again{rank}").save(step, got)
    a = json.loads((again / "manifest.json").read_text())
    b = json.loads(next((tmp / "ckpt").glob("step_*")).joinpath(
        "manifest.json").read_text())
    out["same_manifest"] = (a["hash"], a["keys"]) == (b["hash"], b["keys"])
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def test_restore_latest_onto_placements_on_two_ranks(tmp_path):
    cfg = configs.get_smoke("qwen3-1.7b")
    state = init_train_state(cfg, configs.RunConfig(),
                             torch.Generator().manual_seed(1))
    CheckpointManager(tmp_path / "ckpt").save(7, state)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", RESTORE_CHILD, str(r),
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got[0] == got[1]
    g = got[0]
    n_leaves = sum(1 for _ in _leaves(state))
    assert g["step"] == 7 and g["leaves"] == n_leaves
    assert g["sharded"] > 0 and g["plain"] > 0 and g["same_manifest"]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_restore_latest_without_sharding_tree_is_unchanged(tmp_path):
    """No sharding tree, or one of Nones: plain tensors on the like
    leaves' devices, as before."""
    cfg = configs.get_smoke("qwen3-1.7b")
    state = init_train_state(cfg, configs.RunConfig(),
                             torch.Generator().manual_seed(2))
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state)
    nones = {k: None for k in state}
    for kw in ({}, {"sharding_tree": nones}):
        step, got, _ = mgr.restore_latest(state, **kw)
        assert step == 3
        for a, b in zip(_leaves(got), _leaves(state)):
            assert type(a) is torch.Tensor and torch.equal(a, b)


# -- the rope's arithmetic ---------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6, 5e6])
def test_rope_equals_jax_bit_for_bit_past_16_positions(theta):
    """XLA's CPU rope calls the C library's powf, cosf and sinf, folds
    ``1 / theta ** e`` into ``theta ** -e`` and fuses each rotation's
    first product; the port's CPU rope does the same (it used PyTorch's
    pow, cos and sin, a bf16 bit off at some positions past 16)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(int(theta) % 1000)
    for hd in (16, 128):
        x = rng.standard_normal((2, 512, 3, hd)).astype(np.float32)
        pos = np.broadcast_to(np.arange(512)[None], (2, 512))
        want = jax.jit(lambda x, p: jl.apply_rope(x, p, theta))(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos))
        got = tl.apply_rope(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(pos.copy()), theta)
        np.testing.assert_array_equal(
            np.asarray(want.astype(jnp.float32)), got.float().numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.jit(lambda: jl.rope_freqs(hd, theta))()),
            tl.rope_freqs(hd, theta).numpy())
