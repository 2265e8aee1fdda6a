"""The port's data pipeline, optimizer and gradient compression against the
JAX package's, on the CPU.

* ``TokenStream``: every arch's ``SMOKE`` batches bit for bit (tokens,
  prefix and encoder frames), state and host sharding; the
  ``Prefetcher`` yields the stream in order, a slow consumer included.
* ``compress_grads`` (int8, bf16; error-feedback state over several
  steps) and ``wire_bytes``: bit for bit.
* ``lr_at``: within 2 ulp over a whole schedule (XLA's cosine is its
  own polynomial; the port's is correctly rounded); the decay mask equal.
* ``adamw_update`` given identical gradients, the clip inactive: the
  parameters, both moments and the step bit for bit, over several steps.
  With the clip active the global norm is within 1 ulp of JAX's (XLA sums
  a multi-dimensional leaf in 32 x 32 windows the port does not
  reproduce), so the moments are within 8 ulp and the parameters within
  1e-6 relative.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRun
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import TokenStream as JaxStream
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro_torch import configs
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher, TokenStream
from repro_torch.optim import adamw, compress

SCHEDULE = dict(learning_rate=1e-2, warmup_steps=5, total_steps=50)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its tests are many small
    CPU operations, and the suite runs several processes side by side,
    whose thread pools would oversubscribe the cores (6 processes of 8
    threads ran test_training_loss_decreases 15x slower than of one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def tree(seed: int, scale: float = 1.0) -> dict:
    """A parameter-shaped tree: stacked tiles, vectors, a norm leaf."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"embed": {"tok": r(512, 64)}, "final_norm": r(64),
            "tiles": {"b0": {"ln1": r(2, 64),
                             "attn": {"wq": r(2, 64, 128), "bq": r(2, 128)},
                             "rglru": {"lam": r(2, 96), "w_x": r(2, 64, 96)}}}}


def on_jax(t):
    return jax.tree.map(jnp.asarray, t)


def on_port(t):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), t)


def leaves_ulps(want, got) -> int:
    return max(ulps(w, g.numpy()) for w, g in
               zip(jax.tree.leaves(want), adamw.tree_leaves(got)))


# -- data pipeline -------------------------------------------------------------

@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_token_stream_batches_equal_jax(arch):
    shape = (32, 4)
    js = JaxStream(jax_configs.get_smoke(arch), JaxShape("t", *shape,
                                                         "train"), seed=5)
    ts = TokenStream(configs.get_smoke(arch), ShapeConfig("t", *shape,
                                                          "train"), seed=5)
    for step in (0, 1, 7):
        want, got = js.batch_at(step), ts.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_token_stream_state_and_sharding_equal_jax():
    cfg, tcfg = jax_configs.get_smoke("qwen3-4b"), configs.get_smoke(
        "qwen3-4b")
    js = JaxStream(cfg, JaxShape("t", 32, 4, "train"), seed=0, host_id=1,
                   n_hosts=2)
    ts = TokenStream(tcfg, ShapeConfig("t", 32, 4, "train"), seed=0,
                     host_id=1, n_hosts=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(ts)["tokens"], next(js)["tokens"])
    assert ts.state_dict() == js.state_dict()
    resumed = TokenStream(tcfg, ShapeConfig("t", 32, 4, "train"), seed=0,
                          host_id=1, n_hosts=2)
    resumed.load_state_dict(js.state_dict())
    np.testing.assert_array_equal(next(resumed)["tokens"],
                                  next(js)["tokens"])


@pytest.mark.parametrize("delay", [0.0, 0.35])
def test_prefetcher_yields_in_order(delay):
    """In stream order, also when the consumer waits past the producer's
    0.1 s put timeout (the JAX package's prefetcher drops the batch it
    could not put then; the port keeps it and puts it again)."""
    cfg = configs.get_smoke("qwen3-4b")
    shape = ShapeConfig("t", 32, 4, "train")
    s = TokenStream(cfg, shape, seed=0)
    want = [s.batch_at(i)["tokens"] for i in range(5)]
    pf = Prefetcher(TokenStream(cfg, shape, seed=0), depth=2)
    try:
        for i in range(5):
            time.sleep(delay)
            np.testing.assert_array_equal(next(pf)["tokens"], want[i])
    finally:
        pf.close()


# -- compression ----------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_compress_grads_equal_jax(codec):
    """Three steps of error feedback on the same gradients: what the wire
    carried and the residuals, bit for bit."""
    g = tree(0, 0.05)
    g["tiles"]["b0"]["attn"]["bq"][:] = 0.0   # an all-zero leaf (scale floor)
    jg, tg = on_jax(g), on_port(g)
    je, te = jax_compress.init_ef_state(jg), compress.init_ef_state(tg)
    step = jax.jit(lambda a, e: jax_compress.compress_grads(a, e, codec))
    for _ in range(3):
        jsent, je = step(jg, je)
        tsent, te = compress.compress_grads(tg, te, codec)
        assert leaves_ulps(jsent, tsent) == 0
        assert leaves_ulps(je, te) == 0


def test_wire_bytes_equal_jax():
    g = tree(1)
    for codec in ("none", "bf16", "int8"):
        assert compress.wire_bytes(on_port(g), codec) == \
            jax_compress.wire_bytes(on_jax(g), codec)


# -- optimizer -----------------------------------------------------------------

def test_lr_schedule_within_two_ulp_of_jax():
    jr, tr = JaxRun(**SCHEDULE), RunConfig(**SCHEDULE)
    f = jax.jit(lambda s: jax_adamw.lr_at(jr, s))
    worst = max(ulps(f(jnp.int32(s)), adamw.lr_at(
        tr, torch.tensor(s, dtype=torch.int32)).numpy()) for s in range(60))
    assert worst <= 2
    # the warmup's and the plateau's folded constants are exact
    for s in (0, 1, 4, 5, 50, 59):
        assert ulps(f(jnp.int32(s)), adamw.lr_at(
            tr, torch.tensor(s, dtype=torch.int32)).numpy()) == 0, s


def test_decay_mask_equals_jax():
    g = tree(2)
    assert adamw._decay_mask(on_port(g)) == jax_adamw._decay_mask(on_jax(g))


def test_global_norm_and_clip_close_to_jax():
    g = tree(3, 0.05)
    jg, tg = on_jax(g), on_port(g)
    for max_norm in (1.0, 100.0):
        jc, jn = jax.jit(lambda a: jax_adamw.clip_by_global_norm(
            a, max_norm))(jg)
        tc, tn = adamw.clip_by_global_norm(tg, max_norm)
        assert ulps(jn, tn.numpy()) <= 1
        assert leaves_ulps(jc, tc) <= (0 if max_norm > float(jn) else 2)
    vec = {"w": np.random.default_rng(4).standard_normal(1000).astype(
        np.float32)}  # a vector leaf: XLA's row order, bit for bit
    assert ulps(jax.jit(jax_adamw.global_norm)(on_jax(vec)),
                adamw.global_norm(on_port(vec)).numpy()) == 0


@pytest.mark.parametrize("clip", [1e6, 1.0])
def test_adamw_update_given_identical_grads(clip):
    jr = JaxRun(**SCHEDULE, grad_clip=clip)
    tr = RunConfig(**SCHEDULE, grad_clip=clip)
    p, g = tree(5), tree(6, 0.05)
    jp, tp = on_jax(p), on_port(p)
    jo, to = jax_adamw.init_opt_state(jp), adamw.init_opt_state(tp)
    step = jax.jit(lambda a, b, o: jax_adamw.adamw_update(a, b, o, jr))
    for _ in range(4):
        jp, jo, jm = step(jp, on_jax(g), jo)
        tp, to, tm = adamw.adamw_update(tp, on_port(g), to, tr)
        assert int(to["step"]) == int(jo["step"])
        assert ulps(jm["lr"], tm["lr"].numpy()) == 0
        if clip > 1.0:   # the clip is inactive: every bit
            assert ulps(jm["grad_norm"], tm["grad_norm"].numpy()) <= 1
            assert leaves_ulps(jp, tp) == 0
            assert leaves_ulps(jo["m"], to["m"]) == 0
            assert leaves_ulps(jo["v"], to["v"]) == 0
        else:
            assert leaves_ulps(jo["m"], to["m"]) <= 8
            assert leaves_ulps(jo["v"], to["v"]) <= 8
            for w, t in zip(jax.tree.leaves(jp), adamw.tree_leaves(tp)):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=0)


def test_adamw_moves_toward_minimum():
    """tests/test_substrate.py's quadratic, on the port."""
    params = {"w": torch.tensor([4.0, -3.0])}
    opt = adamw.init_opt_state(params)
    run = RunConfig(learning_rate=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0)
    for _ in range(150):
        params, opt, _ = adamw.adamw_update(params, {"w": 2 * params["w"]},
                                            opt, run)
    assert float(params["w"].abs().max()) < 0.3
