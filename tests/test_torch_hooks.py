"""The port's collective interception layer (``repro_torch.hooks``) against
the JAX package's (``repro.hooks``), as ``tests/test_hooks.py`` runs it.

Both packages run the same DDP-style step on the same input (the JAX
test's ``X``, made with numpy): local compute, a gradient all-reduce,
then three more all-reduces in a loop (``lax.scan`` in JAX, a Python loop in the port).  JAX runs it in
a shard_map over its one CPU device, the port on a one-rank gloo world.

* the census: 2 sites, the same primitives (JAX's ``psum_invariant``, the
  name a psum takes inside a shard_map that checks replication, is the
  port's ``psum``), the same payload bytes a step, trips {1, 3};
* the hooked outputs (trace, RSAG, compression) equal to the unhooked run
  and to JAX's bit for bit; the compressed one also within the bf16 wire
  bound 2e-2;
* a pass-through hook dispatches the same operators on the same shapes as
  the unhooked run (the counterpart of "identical HLO");
* a gradient through a hooked all-reduce, no recursive interception, the
  transparency check, the innermost hook winning, ``virtualize``;
* completeness: a one-rank all-reduce in the backend's census, the
  census's executions equal to the backend's, and collectives made
  outside the hook's view reported (``partitioner_inserted`` > 0);
* two ranks (spawned, a ``FileStore``): RSAG really scatters and equals
  the plain all-reduce bit for bit; ``make_ddp_train_step`` on
  qwen3-1.7b SMOKE, each rank two of the batch's four rows, leaves both
  ranks the same state, its loss within 1e-6 relative, its parameters
  within the microbatch bounds (2e-2 / 2e-3), and the reduced gradient
  (``grad_norm``, and each leaf's ``m / ((1 - b1) c)`` after the step)
  within 2e-2 relative (L2 a leaf) of one rank's ``make_train_step`` on
  the whole batch.

The JAX hook runs at trace time, once a site; the port's runs at every
execution, so its counters count executions (a site times its trip).

Under a profiler the hook records the span ``hook.mode`` with its
``dispatched`` and its own host time (``self_ns``): a hooked DDP step
sees the same operators and gives the same loss with recording on and
off, and counts its own time only when on.
"""
import multiprocessing as mp
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from jax.sharding import PartitionSpec as JP
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro import hooks as jhooks
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.mesh import shard_map_fn
from repro_torch.hooks import (COLLECTIVE_PRIMS, CastCompressHandler,
                               RSAGHandler, TraceHandler,
                               backend_collective_census, census_fn,
                               completeness_report, hook_collectives, hooking,
                               virtualize)
from repro_torch import obs
from repro_torch.launch.mesh import init_world, make_test_mesh
from repro_torch.models import lm
from repro_torch.train.step import make_ddp_train_step, make_train_step

import _two_ranks

# JAX's names for a psum inside a shard_map, as the port names them
CANONICAL = {"psum_invariant": "psum", "psum2": "psum",
             "all_gather_invariant": "all_gather"}
WIRE_RTOL = 2e-2   # bf16, tests/test_kernels.py:26-27
X_NP = np.arange(16.0 * 256, dtype=np.float32).reshape(16, 256)  # the JAX test's


@pytest.fixture(scope="module", autouse=True)
def world():
    """A one-rank gloo world for this file, destroyed at its end."""
    own = not dist.is_initialized()
    w = init_world("cpu")
    yield w
    if own:
        dist.destroy_process_group()


def X():
    return torch.from_numpy(X_NP.copy())


def dp_step(x):
    """A DDP-style step: local compute + gradient all-reduce + a loop of
    all-reduces (the JAX test's scan)."""
    g = x * 2.0
    dist.all_reduce(g)
    c = g
    for t in torch.ones((3,) + tuple(g.shape), dtype=g.dtype):
        t = t.clone()
        dist.all_reduce(t)
        c = c + t
    return c


def jax_dp_step(x):
    g = x * 2.0
    g = jax.lax.psum(g, "data")

    def body(c, t):
        return c + jax.lax.psum(t, "data"), ()

    c, _ = jax.lax.scan(body, g, jnp.ones((3,) + g.shape, g.dtype))
    return c


def jax_sm(**kw):
    mesh = jmake_mesh((jax.device_count(),), ("data",))
    return shard_map_fn()(jax_dp_step, mesh=mesh, in_specs=JP(None, None),
                          out_specs=JP(None, None), **kw)


def jax_run(handlers=None):
    sm = jax_sm()
    if handlers is not None:
        sm = jhooks.hook_collectives(sm, handlers)
    return np.asarray(sm(jnp.asarray(X_NP)))


def canonical(by_prim):
    out = {}
    for k, v in by_prim.items():
        out[CANONICAL.get(k, k)] = out.get(CANONICAL.get(k, k), 0) + v
    return out


# -- census (Table 1/2 analogue) ---------------------------------------------

def test_census_equals_jax():
    c = census_fn(dp_step, X())
    jc = jhooks.census_fn(jax_sm(), jnp.asarray(X_NP))
    assert c["total_sites"] == jc["total_sites"] == 2
    assert c["by_primitive"] == canonical(jc["by_primitive"]) == {"psum": 2}
    assert (c["payload_bytes_per_step"] == jc["payload_bytes_per_step"]
            == X_NP.size * 4 * (1 + 3))
    assert c["payload_bytes_static"] == jc["payload_bytes_static"]
    assert sorted(s.in_shapes for s in c["sites"]) == sorted(
        s.in_shapes for s in jc["sites"])


def test_census_loop_trip_counts():
    c = census_fn(dp_step, X())
    jc = jhooks.census_fn(jax_sm(), jnp.asarray(X_NP))
    assert ({s.loop_trip for s in c["sites"]}
            == {s.loop_trip for s in jc["sites"]} == {1, 3})
    assert all("dp_step" not in s.path and "test_torch_hooks.py:" in s.path
               for s in c["sites"]), [s.path for s in c["sites"]]


def test_census_leaves_its_arguments():
    x = X()
    census_fn(dp_step, x)
    assert torch.equal(x, X())


def test_collective_table_names_what_this_torch_has():
    assert {"psum", "pmax", "pmin", "all_gather", "reduce_scatter",
            "all_to_all"} <= set(COLLECTIVE_PRIMS)
    assert "c10d::allreduce_" in COLLECTIVE_PRIMS["psum"]


# -- interception (the trampoline) -------------------------------------------

def test_trace_handler_is_transparent():
    th = TraceHandler()
    y0 = dp_step(X())
    y1 = hook_collectives(dp_step, {"psum": th})(X())
    assert th.count == 4  # both sites, the loop's three times
    assert th.total_bytes == X_NP.size * 4 * 4
    assert torch.equal(y0, y1)
    jth = jhooks.TraceHandler()
    np.testing.assert_array_equal(y1.numpy(), jax_run({"psum": jth}))
    assert jth.count == 2  # JAX's hook runs once a site, at trace time


class Recorder(TorchDispatchMode):
    """Every operator dispatched, with its tensors' shapes and dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = [a for a in args if isinstance(a, torch.Tensor)] + [
            t for a in args if isinstance(a, (list, tuple))
            for t in a if isinstance(t, torch.Tensor)]
        self.ops.append((str(func), [(tuple(t.shape), t.dtype)
                                     for t in flat]))
        return func(*args, **(kwargs or {}))


def test_transparent_hook_dispatches_identical_operators():
    """The paper's transparency property at the artifact level: a pure
    pass-through hook runs the same operators on the same shapes."""
    def step(x):
        g = x * 2.0
        dist.all_reduce(g)
        out = torch.empty_like(g)
        dist.all_gather_into_tensor(out, g)
        return funcol.all_reduce(out, "max", dist.group.WORLD) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with Recorder() as base:
            y0 = step(X())
        th = TraceHandler()
        with Recorder() as hooked:
            with hooking({"psum": th, "pmax": th, "all_gather": th}):
                y1 = step(X())
    assert th.count == 3
    assert [r.primitive for r in th.records] == ["psum", "all_gather", "pmax"]
    assert hooked.ops == base.ops
    assert torch.equal(y0, y1)


def test_hook_works_under_grad():
    th = TraceHandler()

    def loss(x):
        return funcol.all_reduce(x * 2.0, "sum", dist.group.WORLD).sum()

    x0 = X().requires_grad_(True)
    loss(x0).backward()
    x1 = X().requires_grad_(True)
    hook_collectives(lambda x: loss(x).backward(), {"psum": th})(x1)
    assert th.count >= 2  # the forward's all-reduce and the backward's
    assert torch.equal(x0.grad, x1.grad)
    assert bool(torch.isfinite(x1.grad).all())
    jth = jhooks.TraceHandler()
    jg = jax.jit(jax.grad(lambda x: jnp.sum(jhooks.hook_collectives(
        jax_sm(), {"psum": jth})(x))))(jnp.asarray(X_NP))
    np.testing.assert_array_equal(np.asarray(jg), np.full_like(X_NP, 2.0))
    np.testing.assert_array_equal(x1.grad.numpy(), np.full_like(X_NP, 2.0))


def test_no_recursive_interception():
    """Handlers may themselves use collectives (dlmopen-namespace
    analogue)."""
    calls = []

    def handler(name, args, params, do_original):
        calls.append(name)
        extra = args[0] * 0.0
        dist.all_reduce(extra)  # must NOT re-enter the handler
        return do_original(args[0] + extra)

    y0 = dp_step(X())
    y1 = hook_collectives(dp_step, {"psum": handler})(X())
    assert torch.equal(y0, y1)
    assert len(calls) == 4


def test_transparency_check_rejects_bad_handler():
    def bad(name, args, params, do_original):
        return args[0][:4]  # wrong shape

    with pytest.raises(TypeError, match="transparency"):
        hook_collectives(dp_step, {"psum": bad})(X())

    def cast(name, args, params, do_original):
        return do_original().to(torch.bfloat16)  # wrong dtype

    with pytest.raises(TypeError, match="transparency"):
        hook_collectives(dp_step, {"psum": cast})(X())


def test_hooks_compose_with_stack():
    th_outer, th_inner = TraceHandler(), TraceHandler()
    with hooking({"psum": th_outer}):
        with hooking({"psum": th_inner}):  # innermost wins
            dp_step(X())
    assert th_inner.count == 4 and th_outer.count == 0
    # an innermost hook without a handler for the primitive decides too
    with hooking({"psum": th_outer}):
        with hooking({"all_gather": th_inner}):
            dp_step(X())
    assert th_outer.count == 0


def test_virtualize_skips_collective():
    vh = virtualize(lambda args: args[0] * 0.0)
    y = hook_collectives(dp_step, {"psum": vh})(X())
    assert bool(torch.all(y == 0))
    kwargs = dict(mesh=jmake_mesh((1,), ("data",)), in_specs=JP(None, None),
                  out_specs=JP(None, None))
    try:
        sm = shard_map_fn()(jax_dp_step, check_vma=False, **kwargs)
    except TypeError:  # older jax spells it check_rep
        sm = shard_map_fn()(jax_dp_step, check_rep=False, **kwargs)
    jy = jhooks.hook_collectives(sm, {"psum": jhooks.virtualize(
        lambda args: args[0] * 0.0)})(jnp.asarray(X_NP))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# -- shipped feature handlers -------------------------------------------------

def test_cast_compress_halves_wire_bytes():
    ch = CastCompressHandler(min_bytes=1024)
    y0 = dp_step(X())
    y1 = hook_collectives(dp_step, {"psum": ch})(X())
    assert ch.compressed_sites == 4
    err = torch.max(torch.abs(y1 - y0) / (torch.abs(y0) + 1e-9))
    assert float(err) < WIRE_RTOL
    assert not torch.equal(y0, y1)  # the wire really was bf16
    # one device: f32 -> bf16 -> f32 in both, the same rounding
    jch = jhooks.CastCompressHandler(min_bytes=1024)
    np.testing.assert_array_equal(y1.numpy(), jax_run({"psum": jch}))


def test_rsag_schedule_rewrite_is_exact():
    rh = RSAGHandler(axis_size=1)
    y0 = dp_step(X())
    y1 = hook_collectives(dp_step, {"psum": rh})(X())
    assert rh.rewritten == 4
    assert torch.equal(y0, y1)
    np.testing.assert_array_equal(y1.numpy(), jax_run(
        {"psum": jhooks.RSAGHandler(axis_size=1)}))


def test_rsag_passes_scalars_through():
    rh = RSAGHandler(axis_size=1)
    s = torch.tensor(3.0)
    with hooking({"psum": rh}):
        dist.all_reduce(s)
    assert rh.rewritten == 0 and float(s) == 3.0


# -- completeness (C1/C2/C3 analogue) ----------------------------------------

def test_backend_census_counts_one_rank_all_reduce():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dist.all_reduce(torch.ones(8))
    assert backend_collective_census(prof).get("all-reduce", 0) >= 1


def test_completeness_report_structure():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c = census_fn(dp_step, X())
    rep = completeness_report(c, backend_collective_census(prof))
    assert rep.census_counts == {"all-reduce": 4}
    assert rep.backend_counts.get("all-reduce") == 4
    assert rep.fully_hooked
    jc = jhooks.census_fn(jax_sm(), jnp.asarray(X_NP))
    txt = jax.jit(jax_sm()).lower(jnp.asarray(X_NP)).compile().as_text()
    jrep = jhooks.completeness_report(jc, txt)
    assert jrep.jaxpr_counts == {"all-reduce": 2}  # JAX counts sites
    assert jrep.fully_hooked


def test_collectives_outside_the_hook_are_reported():
    """A DDP model built before the hook is entered broadcasts its
    parameters, and a barrier is no hooked kind: the backend ran both,
    the census saw neither."""
    torch.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model = torch.nn.parallel.DistributedDataParallel(
            torch.nn.Linear(8, 4))
        c = census_fn(lambda x: model(x).sum().backward(), torch.ones(2, 8))
        dist.barrier()
    rep = completeness_report(c, backend_collective_census(prof))
    assert not rep.fully_hooked
    assert sum(rep.partitioner_inserted.values()) > 0, rep


def test_collective_on_another_thread_is_not_intercepted():
    th = TraceHandler()
    with hooking({"psum": th}):
        t = threading.Thread(target=lambda: dist.all_reduce(torch.ones(4)))
        t.start()
        t.join()
        dist.all_reduce(torch.ones(4))
    assert th.count == 1


# -- two ranks ---------------------------------------------------------------

SPLIT_LOSS_RTOL = 1e-6         # tests/test_torch_train.py
# a step on two halves of the batch against one on the whole: the bounds of
# tests/test_opt_variants.py::test_microbatch_matches_full_batch
SPLIT_PARAM_RTOL, SPLIT_PARAM_ATOL = 2e-2, 2e-3
# the mean of two halves' gradients against the whole batch's: relative
# (L2 a leaf), tests/test_kernels.py's bf16 bound as tests/test_torch_ddp.py
SPLIT_GRAD_RTOL = 2e-2


def test_two_ranks_rsag_scatters_and_ddp_step_matches_whole_batch(tmp_path):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_two_ranks.rank_main,
                         args=(r, str(tmp_path / "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    # the whole batch on this rank while the two ranks run
    cfg, run, state, batch = _two_ranks.ddp_inputs()
    state, m = make_train_step(cfg, run)(state, batch)
    got = sorted((out.get(timeout=120) for _ in procs), key=lambda g: g[0])
    for p in procs:
        p.join(timeout=30)
    assert all(p.exitcode == 0 for p in procs)
    for rank, rewritten, traced, equal, unchanged, *_ in got:
        assert (rewritten, traced, equal, unchanged) == (1, 0, True, False)
    # both ranks hold the same state; one rank's step on the whole batch
    assert got[0][5] == got[1][5] and got[0][7] == got[1][7]
    for a, b in zip(got[0][6] + got[0][8], got[1][6] + got[1][8]):
        np.testing.assert_array_equal(a, b)
    assert got[0][5] == pytest.approx(float(m["loss"]), rel=SPLIT_LOSS_RTOL)
    for a, b in zip(got[0][6], lm.tree_leaves(state["params"])):
        np.testing.assert_allclose(a, b.numpy(), rtol=SPLIT_PARAM_RTOL,
                                   atol=SPLIT_PARAM_ATOL)
    # the update at step 0's learning rate is far below that bound, and
    # Adam's is blind to the gradient's scale: the reduced gradient itself
    # is held.  After one step from zero moments m = (1 - b1) c g, with c =
    # min(1, clip / grad_norm), on each side
    want_norm = float(m["grad_norm"])
    assert got[0][7] == pytest.approx(want_norm, rel=SPLIT_GRAD_RTOL)
    c_got = min(1.0, run.grad_clip / got[0][7])
    c_want = min(1.0, run.grad_clip / want_norm)
    for a, b in zip(got[0][8], lm.tree_leaves(state["opt"]["m"])):
        g = a / ((1 - run.b1) * c_got)
        w = b.numpy() / ((1 - run.b1) * c_want)
        assert np.linalg.norm(g - w) <= SPLIT_GRAD_RTOL * np.linalg.norm(w)


def test_hooked_step_records_its_spans_and_the_same_operators():
    """A hooked DDP step on the one-rank world, with recording off and
    on (a CPU profiler): the same operators dispatched, the same loss;
    the mode's own time counted only when on, where the spans hold the
    step's passes inside ``hook.mode``."""
    got = {}
    for on in (False, True):
        cfg, run, state, batch = _two_ranks.ddp_inputs()
        step = make_ddp_train_step(cfg, run, make_test_mesh(1, 1))
        obs.RECORDER.clear()
        prof = profile(activities=[ProfilerActivity.CPU]) if on else None
        if on:
            prof.start()
        with hooking({"psum": TraceHandler()}) as mode:
            _, m = step(state, batch)
        if on:
            prof.stop()
        got[on] = (mode.dispatched, float(m["loss"]), mode.self_ns,
                   obs.recorded())
    (n_off, loss_off, ns_off, spans_off), (n_on, loss_on, ns_on,
                                           spans_on) = got[False], got[True]
    assert n_on == n_off > 100 and loss_on == loss_off
    assert ns_off == 0 and ns_on > 0 and spans_off == []
    names = [s.name for s in spans_on]
    assert names == ["hook.mode", "train.step", "train.forward",
                     "train.backward", "train.optimizer"]
    assert [s.parent for s in spans_on] == [None, 0, 1, 1, 1]
    assert spans_on[0].counts == {"dispatched": n_on, "self_ns": ns_on}
    obs.RECORDER.clear()


def test_hook_time_counts_its_handler_not_the_native_collective(
        monkeypatch):
    """Under a profiler the mode's ``self_ns`` holds a collective's whole
    trampoline, its handler's own work included, and leaves out the
    native operator the handler runs: with a handler that works 10 ms
    and a native all-reduce made to take 30 ms, four all-reduces count
    40 ms and not 160."""
    from repro_torch.hooks import interceptor
    run = interceptor._Call._run

    def slow_run(self, bound):
        time.sleep(0.030)
        return run(self, bound)

    def handler(name, args, params, do_original):
        time.sleep(0.010)
        return do_original()

    monkeypatch.setattr(interceptor._Call, "_run", slow_run)
    obs.RECORDER.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with hooking({"psum": handler}) as mode:
        dp_step(X())
    prof.stop()
    assert mode.timed
    assert 40e6 <= mode.self_ns < 100e6
    obs.RECORDER.clear()
