"""Helpers shared by the LM parity tests of the port's model families
(``tests/test_torch_moe.py``, ``tests/test_torch_encdec.py``): one model
built in both packages from the JAX package's ``init_params(PRNGKey(0))``,
the same batches and teacher-forced feeds through both, and the
comparisons.

``STRICT`` is JAX compiled with ``xla_allow_excess_precision`` off, which
the port equals bit for bit; JAX's default build keeps some bf16
intermediates in f32 and is held to the bf16 bound (2e-2, relative L2 a
step), its served tokens equal outside near-ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.models import lm as jax_lm
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.interop import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import Request, ServeEngine

STRICT = {"xla_allow_excess_precision": False}
ATOL = RTOL = 2e-2  # tests/test_kernels.py:27, bf16
PROMPTS = [np.arange(8, dtype=np.int32),  # tests/test_substrate.py:147
           np.arange(5, dtype=np.int32) + 3]


class Strict:
    """A JAX function compiled with excess precision off, once per input
    shapes."""

    def __init__(self, fn):
        self.fn, self.done = jax.jit(fn), {}

    def __call__(self, *args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)),
                               args))
        if key not in self.done:
            self.done[key] = self.fn.lower(*args).compile(STRICT)
        return self.done[key](*args)


@dataclasses.dataclass
class Model:
    """One configuration in both packages, the JAX weights carried across."""

    cfg: object
    run: object
    jp: dict
    tcfg: object
    trun: object
    tp: dict

    @classmethod
    def build(cls, arch: str, *, moe=None, **run_kw):
        """``arch``'s SMOKE config (its MoE fields replaced by ``moe``),
        ``RunConfig(attn_chunk=8, remat_policy="none", decode_budget=8,
        **run_kw)`` in both packages."""
        cfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, **moe))
        kw = dict(attn_chunk=8, remat_policy="none", decode_budget=8,
                  **run_kw)
        jp = jax_lm.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        return cls(cfg, jax_configs.RunConfig(**kw), jp, tcfg,
                   configs.RunConfig(**kw), tp)

    def batches(self, seed: int, batch: int, plen: int, extra: int = 4):
        """(JAX batch, port batch) of seeded tokens, with a seeded
        ``enc_emb`` (enc-dec) or ``prefix_emb`` (frontend) of ``extra``
        positions."""
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab, (batch, plen)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks).long()}
        key = ("enc_emb" if self.cfg.kind == "encdec" else "prefix_emb"
               if self.cfg.frontend is not None else None)
        if key:
            e = rng.standard_normal((batch, extra, self.cfg.d_model)).astype(
                np.float32)
            jb[key], tb[key] = jnp.asarray(e), torch.from_numpy(e)
        return jb, tb

    def jax_fns(self, strict: bool = True):
        cfg, run = self.cfg, self.run
        wrap = Strict if strict else jax.jit
        return (wrap(lambda p, b: jax_lm.prefill(cfg, run, p, b)),
                wrap(lambda p, c, t, pos: jax_lm.decode_step(cfg, run, p, c,
                                                             t, pos)))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def npfx(batch) -> int:
    p = batch.get("prefix_emb")
    return 0 if p is None else int(p.shape[1])


def run_jax(m: Model, jb, feed, strict: bool = True):
    """Prefill, then one decode step per column of ``feed``: ([logits],
    [cache]) after each."""
    prefill, decode = m.jax_fns(strict)
    logits, cache = prefill(m.jp, jb)
    out, caches = [logits], [cache]
    start = jb["tokens"].shape[1] + npfx(jb)
    for t in range(feed.shape[1]):
        logits, cache = decode(m.jp, cache, jnp.asarray(feed[:, t:t + 1]),
                               jnp.int32(start + t))
        out.append(logits)
        caches.append(cache)
    return out, caches


def run_port(m: Model, tb, feed):
    logits, cache = lm.prefill(m.tcfg, m.trun, m.tp, tb)
    out, caches = [logits], [lm.tree_map(torch.clone, cache)]
    start = tb["tokens"].shape[1] + npfx(tb)
    for t in range(feed.shape[1]):
        logits, cache = lm.decode_step(
            m.tcfg, m.trun, m.tp, cache,
            torch.from_numpy(feed[:, t:t + 1]).long(), start + t)
        out.append(logits)
        caches.append(lm.tree_map(torch.clone, cache))
    return out, caches


def leaves_with_paths(tree):
    """[(path string, numpy leaf)] of a nested dict, in JAX's leaf order."""
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, tree))]


def assert_trees_equal(got, want, what: str):
    """Same paths, every leaf equal (compared as f32: bf16 widens
    exactly)."""
    g = dict(leaves_with_paths(lm.tree_map(
        lambda t: t.float() if t.is_floating_point() else t, got)))
    w = leaves_with_paths(want)
    assert sorted(g) == sorted(p for p, _ in w), what
    for path, x in w:
        np.testing.assert_array_equal(g[path], np.asarray(x, g[path].dtype),
                                      err_msg=f"{what} {path}")


def assert_prefill_and_decode_equal(m: Model, seed=0, batch=2, plen=16,
                                    steps=4):
    """Prefill and ``steps`` teacher-forced decode steps through strict
    JAX and the port: every logit and every cache leaf after each step
    bit for bit."""
    jb, tb = m.batches(seed, batch, plen)
    feed = tokens(seed + 10, (batch, steps), m.cfg.vocab)
    want, wcaches = run_jax(m, jb, feed)
    got, gcaches = run_port(m, tb, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(np32(g), np32(w),
                                      err_msg=f"logits, step {step}")
    for step, (g, w) in enumerate(zip(gcaches, wcaches)):
        assert_trees_equal(g, w, f"cache after step {step}")


def near_tie(lo, hi) -> bool:
    """Two values each within the elementwise bf16 bound of the truth can
    swap: their gap is at most twice the bound."""
    return hi - lo <= 2 * (ATOL + RTOL * abs(hi))


def assert_within_bf16_bound_of_default_jax(m: Model, seed=2, steps=4,
                                            excused=None):
    """Relative L2 of every step's logits within the bf16 bound, but at a
    step that ``excused(step)`` accounts for (a discrete choice made at a
    near-tie, such as a MoE routing)."""
    jb, tb = m.batches(seed, 2, 16)
    feed = tokens(seed + 10, (2, steps), m.cfg.vocab)
    want, _ = run_jax(m, jb, feed, strict=False)
    got, _ = run_port(m, tb, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        g, w = np32(g), np32(w)
        assert np.isfinite(g).all()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= RTOL or (excused and excused(step)), \
            f"step {step}: relative L2 {rel}"


def serve_jax(m: Model, strict: bool):
    eng = JaxEngine(m.cfg, m.run, m.jp, max_batch=2)
    if strict:
        eng._prefill, eng._decode = m.jax_fns(True)
    outs = eng.generate([JaxRequest(p, max_new_tokens=4) for p in PROMPTS])
    return np.stack([o.tokens for o in outs])


def serve_port(m: Model):
    eng = ServeEngine(m.tcfg, m.trun, m.tp, max_batch=2, device="cpu")
    outs = eng.generate([Request(p, max_new_tokens=4) for p in PROMPTS])
    assert all(o.tokens.dtype == np.int32 for o in outs)
    return np.stack([o.tokens for o in outs])


def assert_serve_matches_default_jax_outside_near_ties(m: Model,
                                                      excused=None):
    """The port's served tokens against the default JAX engine's: where
    they differ, the JAX logits' top-2 margin along the JAX engine's own
    tokens is a near-tie, or ``excused(step, row)`` accounts for it, and
    the histories part there."""
    got = serve_port(m)
    want = serve_jax(m, strict=False)
    plen = max(len(p) for p in PROMPTS)
    toks = np.zeros((2, plen), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, plen - len(p):] = p
    jb = {"tokens": jnp.asarray(toks)}
    n = max(plen // m.cfg.frontend_len_div, 1)
    if m.cfg.kind == "encdec":
        jb["enc_emb"] = jnp.zeros((2, n, m.cfg.d_model), jnp.float32)
    elif m.cfg.frontend is not None:
        jb["prefix_emb"] = jnp.zeros((2, n, m.cfg.d_model), jnp.float32)
    logits, _ = run_jax(m, jb, want, strict=False)
    for i in range(2):
        for t in range(4):
            lg = np32(logits[t])[i, :m.cfg.vocab]
            top2 = np.sort(lg)[-2:]
            if got[i, t] != want[i, t]:
                assert near_tie(*top2) or (excused and excused(t, i)), (i, t)
                break  # the histories differ from here on


def assert_init_layout_equals_jax(m: Model):
    """The port's own ``init_params`` has the JAX tree, shapes and dtypes;
    the JAX weights carry across and back unchanged."""
    want = leaves_with_paths(m.jp)
    got = dict(leaves_with_paths(params_to_numpy(
        lm.init_params(m.tcfg, torch.Generator().manual_seed(0)))))
    assert sorted(got) == sorted(p for p, _ in want)
    for path, x in want:
        assert got[path].shape == x.shape and got[path].dtype == x.dtype, \
            path
    back = dict(leaves_with_paths(params_to_numpy(m.tp)))
    for path, x in want:
        np.testing.assert_array_equal(back[path], x, err_msg=path)
