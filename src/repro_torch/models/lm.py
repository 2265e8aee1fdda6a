"""The LM of the PyTorch port, every family the JAX package defines:
decoders of ``attn``, ``local_attn``, ``rglru``, ``mlstm`` and ``slstm``
blocks with tail blocks, with a dense MLP or a mixture of experts
(qwen2-moe-a2.7b, dbrx-132b), with a modality-frontend prefix
(llava-next-34b), and the encoder-decoder (seamless-m4t-medium); their
decode caches.

The JAX package's ``models/lm.py``.  The parameter tree is the JAX
package's, leaf for leaf: ``{"embed": {"tok"}, "final_norm", "tiles":
{"b<i>": <block stacked over n_tiles>}[, "tail": {"b<i>": <block>}][,
"lm_head"][, "frontend_proj"][, "enc_tiles": {"b0": <encoder block stacked
over enc_layers>}, "enc_norm"]}``, where the tail holds the
``n_layers % len(block_pattern)`` blocks after the last whole tile and a
block holds ``moe`` (``router``, ``w1``-``w3`` stacked over experts[,
``shared``]) in place of ``mlp``, and ``ln_x`` and ``xattn`` (the
cross-attention) in an encoder-decoder's decoder, so weights carry
across with :mod:`repro_torch.models.interop`.  The ``lax.scan`` over
tiles is a Python loop over the stacked leading axis.

Inputs are dicts: ``{"tokens": (B, S)[, "prefix_emb": (B, P, D)]}`` for
a decoder (``prefix_emb``, the frontend's stand-in, is projected by
``frontend_proj`` and put before the tokens; the positions after the
prefix are the ones returned), ``{"tokens", "enc_emb": (B, S_enc, D)}``
for the encoder-decoder (the encoder: ``frontend_proj``, then
``enc_layers`` non-causal attention blocks and ``enc_norm``).

Modes:
  * ``train``   — full-sequence forward, no cache.
  * ``prefill`` — full-sequence forward, returns the decode cache: K/V of
    the prompt padded with ``run.decode_budget`` zero slots (``attn``), a
    ring of the last ``min(window, S)`` positions with their positions in
    ``slot_pos`` (``local_attn``), the last h and conv taps (``rglru``),
    the matrix memory C and normaliser n (``mlstm``), the c, n, m, h
    carry (``slstm``); beside them the cross-attention's K/V of the
    encoder output (``xk``, ``xv``), which decode reads unchanged.
  * ``decode``  — one token against the cache.  Every block's new state
    is written into the cache in place (the JAX function returns a new
    cache; here the returned cache is the one passed in, updated), which
    saves a copy of the whole cache per token.

Attention on CUDA tensors runs through the hand-written kernels (prefill,
windowed or not, the encoder and the cross-attention prefill through
flash attention; ``attn`` decode and the cross-attention decode through
flash-decode); CPU tensors take the JAX model's plain attention
(:func:`layers.attention`).  The ring decode of ``local_attn`` is the JAX
model's masked attention (:func:`_masked_decode_attn`) on both devices.
The RG-LRU scan and the mLSTM run through their kernels on the card;
the sLSTM is plain PyTorch, a loop over time, on both devices
(:mod:`repro_torch.models.recurrent`); so is the MoE's routing and
combine (:mod:`repro_torch.models.moe`).  The xLSTM blocks have no MLP
(``ln2``/``mlp``), as in the JAX model.  ``forward`` returns the MoE's
auxiliary loss, summed over the blocks.

Training: :func:`loss_fn` (next-token CE, z-loss and the MoE aux, the
head and xent chunked under ``run.loss_chunk``) runs the plain forms on
every device (:func:`layers.xla_route`), and ``_run_stack`` in mode
``"train"`` checkpoints each tile as ``run.remat_policy`` says
(``torch.utils.checkpoint``; the policies change memory, never a bit).

Layout points (``parallel.sharding.constrain``): on a mesh's DTensors
(the dry run, ``launch.dryrun``) each redistributes to its spec; on any
other tensor it is the tensor itself, so nothing here changes a plain
tensor's arithmetic.  Where the JAX model has them: the embedding's
output (data, None, None); q/k/v in their ``head_axes`` layouts before
prefill and train attention under ``run.attn_act_constraints`` (off by
default, as there); the decode cache's K/V after the write; the
head's logits (data, None, model) in ``forward``, ``prefill`` and
``_ce_sums``; the sequence-sharded carry under ``run.seq_shard``
(Megatron-SP), and — since DTensor, unlike GSPMD, lays out a gradient
where the forward left it — each branch's output before its residual
add.  Where DTensor's propagation fails without one (GSPMD pads or
chooses; DTensor refuses): q/k/v's flat projections to the K/V heads'
``sharding.head_axes`` layout before they split into heads (q too, so
that its heads split into groups evenly), and the heads merged whole
before the output projection (``layers``; the cross-attention's heads
too); every product's gradient brought back to its output's layout
(``layers.dot``, ``sharding.pin``); a block's normed input, and the
encoder's output, gathered along the sequence (``_gathered``); the
target's logit reduced before its index (``_ce_sums``); a tied
embedding's two uses pinned to its layout, so that their gradients add
(``_embed``, ``_head_weight``); a gradient laid out as its parameter
(``train.step``); a pending partial sum reduced before a bit operation
(``numerics.fma``, ``numerics.cumsum``).  Where DTensor has no rule
for a layout, a row-wise function runs on each rank's own shards
(``sharding.local_map``, GSPMD's sharded ``vmap``): the MoE's routing,
dispatch, combine and aux by batch row (``moe.py``), attention's
products by batch row and head where whole heads are sharded
(``layers.per_head``: DTensor would flatten batch and heads, both
sharded); every ``numerics.einsum`` of DTensors is each rank's product
of its shards (``sharding.einsum``: the xLSTM's).  The ring's prefill is
a rotation (:func:`_ring`; an index write has no rule), and a dimension
its axes do not divide (a batch of one) stays whole in ``constrain``.
``launch.dryrun`` registers DTensor's rules for a constant pad and a
flip.
"""
from __future__ import annotations

import functools
import math
import operator
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .. import numerics
from ..configs.base import ModelConfig, RunConfig
from ..core.machine import resolve_device
from ..parallel.sharding import (constrain, data_axes, head_axes,
                                 mesh_axis_size, pin, tp_axis)
from . import moe as moe_lib
from . import recurrent as rec
from .layers import (COMPUTE_DTYPE, NEG_INF, PARAM_DTYPE, apply_mlp,
                     attention, attn_out, attn_qkv, checkpoint, dense_init,
                     dot, head_layouts, init_attn, init_mlp, per_head,
                     rms_norm, split_heads, xla_route)

Params = Dict[str, Any]


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _tile_split(cfg: ModelConfig):
    """(number of whole tiles, the kinds of the tail blocks)."""
    pat = cfg.block_pattern
    return cfg.n_layers // len(pat), tuple(pat[: cfg.n_layers % len(pat)])


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, *,
                lead=(), cross: bool = False) -> Params:
    lead = tuple(lead)

    def ones():
        return torch.ones(lead + (cfg.d_model,), dtype=PARAM_DTYPE,
                          device=gen.device)

    p: Params = {"ln1": ones()}
    if kind in ("attn", "local_attn"):
        p["attn"] = init_attn(cfg, gen, lead=lead)
    elif kind == "rglru":
        p["rglru"] = rec.init_rglru(cfg, gen, lead=lead)
    elif kind == "mlstm":
        p["mlstm"] = rec.init_mlstm(cfg, gen, lead=lead)
    elif kind == "slstm":
        p["slstm"] = rec.init_slstm(cfg, gen, lead=lead)
    else:
        raise ValueError(kind)
    if cross:
        p["ln_x"] = ones()
        p["xattn"] = init_attn(cfg, gen, lead=lead, cross=True)
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        p["ln2"] = ones()
        if cfg.moe is not None:
            p["moe"] = moe_lib.init_moe(cfg, gen, lead=lead)
        else:
            p["mlp"] = init_mlp(cfg, gen, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on its device (a CUDA
    generator puts them on the card).  Same tree and scales as the JAX
    package's ``init_params``; the values differ (another generator)."""
    n_tiles, tail = _tile_split(cfg)
    cross = cfg.kind == "encdec"
    params: Params = {
        # 1/sqrt(d) so tied-head logits are O(1) at init
        "embed": {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                    scale=1.0 / math.sqrt(cfg.d_model))},
        "final_norm": torch.ones((cfg.d_model,), dtype=PARAM_DTYPE,
                                 device=gen.device),
    }
    params["tiles"] = {f"b{bi}": _init_block(cfg, kind, gen,
                                             lead=(n_tiles,), cross=cross)
                       for bi, kind in enumerate(cfg.block_pattern)}
    if tail:
        params["tail"] = {f"b{bi}": _init_block(cfg, kind, gen, cross=cross)
                          for bi, kind in enumerate(tail)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab))
    if cfg.frontend is not None:
        params["frontend_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model))
    if cross:
        params["enc_tiles"] = {"b0": _init_block(cfg, "attn", gen,
                                                 lead=(cfg.enc_layers,))}
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=PARAM_DTYPE,
                                        device=gen.device)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      *, lead=(), cross_len: int = 0, device) -> Params:
    lead = tuple(lead)
    hkv, hd = cfg.n_kv_heads, cfg.hd

    def zeros(n):
        return torch.zeros(lead + (batch, n, hkv, hd), dtype=COMPUTE_DTYPE,
                           device=device)

    if kind in ("rglru", "mlstm", "slstm"):
        init = getattr(rec, f"init_{kind}_cache")
        c = init(cfg, batch, lead=lead, device=device)
    elif kind in ("attn", "local_attn"):
        if kind == "local_attn":
            seq_len = min(cfg.window, seq_len)
        c = {"k": zeros(seq_len), "v": zeros(seq_len)}
        if kind == "local_attn":
            c["slot_pos"] = torch.full(lead + (seq_len,), -1,
                                       dtype=torch.int32, device=device)
    else:
        raise ValueError(kind)
    if cross_len:
        c["xk"], c["xv"] = zeros(cross_len), zeros(cross_len)
    return c


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Params:
    """An all-zero decode cache of ``seq_len`` positions (the
    encoder-decoder's cross-attention K/V of ``seq_len //
    frontend_len_div``); ``device=None`` is the card."""
    dev = resolve_device(device)
    n_tiles, tail = _tile_split(cfg)
    cross_len = (seq_len // cfg.frontend_len_div if cfg.kind == "encdec"
                 else 0)
    cache: Params = {"tiles": {
        f"b{bi}": _init_block_cache(cfg, kind, batch, seq_len,
                                    lead=(n_tiles,), cross_len=cross_len,
                                    device=dev)
        for bi, kind in enumerate(cfg.block_pattern)}}
    if tail:
        cache["tail"] = {f"b{bi}": _init_block_cache(
            cfg, kind, batch, seq_len, cross_len=cross_len, device=dev)
            for bi, kind in enumerate(tail)}
    return cache


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _self_attention(cfg: ModelConfig, run: RunConfig, p: Params, h, *,
                    kind: str, mode: str, cache, pos, causal: bool):
    B, S, _ = h.shape
    window = cfg.window if kind == "local_attn" else 0
    if mode == "decode":
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=h.device)
        q, k, v = attn_qkv(cfg, p, h, positions)
        ck, cv = cache["k"], cache["v"]
        if kind == "local_attn":
            slot = pos % ck.shape[1]
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            spos = cache["slot_pos"]
            spos[slot] = pos
            live = (spos >= 0) & (spos > pos - cfg.window)
            o = _masked_decode_attn(q, ck, cv, live[None, None, :].expand(
                B, 1, -1))
            return attn_out(cfg, p, o), dict(cache, k=ck, v=cv,
                                             slot_pos=spos)
        # dynamic_update_slice clamps the start into the cache
        slot = min(max(pos, 0), ck.shape[1] - 1)
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        kvh_ax, kvhd_ax = head_axes(cfg.n_kv_heads, cfg.hd)
        ck = constrain(ck, data_axes(), None, kvh_ax, kvhd_ax)
        cv = constrain(cv, data_axes(), None, kvh_ax, kvhd_ax)
        o = attention(q, ck, cv, causal=False, kv_len=pos + 1)
        return attn_out(cfg, p, o), dict(cache, k=ck, v=cv)

    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    q, k, v = attn_qkv(cfg, p, h, positions[None].expand(B, S))
    if run.attn_act_constraints:
        # the JAX model's explicit head layouts (default off there too:
        # propagation from the flat projections picks better GQA layouts)
        h_ax, hd_ax = head_axes(cfg.n_heads, cfg.hd)
        kvh_ax, kvhd_ax = head_axes(cfg.n_kv_heads, cfg.hd)
        q = constrain(q, data_axes(), None, h_ax, hd_ax)
        k = constrain(k, data_axes(), None, kvh_ax, kvhd_ax)
        v = constrain(v, data_axes(), None, kvh_ax, kvhd_ax)
    with head_layouts(run.attn_act_constraints):
        o = attention(q, k, v, causal=causal, window=window,
                      chunk=run.attn_chunk, chunk_remat=run.attn_chunk_remat)
    out = attn_out(cfg, p, o)

    new_cache = None
    if mode == "prefill":
        if kind == "local_attn":
            # the ring: the last w positions, position t in slot t % w
            w = min(cfg.window, S)
            last_pos = torch.arange(S - w, S, dtype=torch.int32,
                                    device=h.device)
            new_cache = {"k": _ring(k[:, -w:], 1, S),
                         "v": _ring(v[:, -w:], 1, S),
                         "slot_pos": _ring(last_pos, 0, S)}
        else:
            pad = run.decode_budget
            if pad:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            new_cache = {"k": k, "v": v}
    return out, new_cache


def _ring(x, dim: int, end: int):
    """The w positions ``end - w .. end - 1`` that ``x`` holds along
    ``dim``, as a new ring of w slots, position t in slot t % w: ``x``
    rotated by ``end % w``, two slices and a concatenation (exact; an
    index write has no DTensor rule)."""
    cut = x.shape[dim] - end % x.shape[dim]
    if cut == x.shape[dim]:
        return x.clone()
    return torch.cat([x.narrow(dim, cut, x.shape[dim] - cut),
                      x.narrow(dim, 0, cut)], dim)


def _masked_decode_attn(q, k, v, mask):
    """q: (B,1,Hq,hd); k/v: (B,W,Hkv,hd); mask: (B,1,W).  The JAX model's
    plain masked attention (no Pallas kernel computes it there either):
    f32 logits, softmax, probabilities in v's dtype for P V; each rank's
    own heads on a mesh (:func:`layers.per_head`)."""
    return per_head(_masked_decode_rows, q, k, v, mask)


def _masked_decode_rows(q, k, v, mask):
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, 1, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return o.to(v.dtype).reshape(B, 1, Hq, hd)


def _cross_attention(cfg: ModelConfig, p: Params, h, enc_out=None,
                     cache=None):
    """Cross-attention: K/V from the encoder output (train, prefill) or
    from the cache (decode); q from ``wq`` alone (no bias, qk-norm or
    rope).  Returns (out, {"xk", "xv"})."""
    if cache is not None and enc_out is None:
        k, v = cache["xk"], cache["xv"]
    else:
        k = split_heads(dot(enc_out, p["wk"].to(enc_out.dtype)),
                        cfg.n_kv_heads, cfg.hd)
        v = split_heads(dot(enc_out, p["wv"].to(enc_out.dtype)),
                        cfg.n_kv_heads, cfg.hd)
    q = split_heads(dot(h, p["wq"].to(h.dtype)), cfg.n_heads, cfg.hd,
                    layout_heads=cfg.n_kv_heads)
    o = attention(q, k, v, causal=False)
    return attn_out(cfg, p, o), {"xk": k, "xv": v}


def _gathered(h):
    """A block's normed input (or the encoder's output), whole along the
    sequence (a mesh's DTensor only): the carry is sequence-sharded
    between blocks (Megatron-SP), and a product cannot take a batch and
    sequence sharded over two mesh axes flattened into one dimension.
    XLA gathers it inside the block at the same place."""
    return constrain(h, data_axes(), None, None)


def apply_block(cfg: ModelConfig, run: RunConfig, kind: str, p: Params, x, *,
                mode: str, cache=None, pos=None, enc_out=None, causal=True):
    """Returns (x, new_cache, aux): aux is the MoE's auxiliary loss, an f32
    zero without experts."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seq_shard = (mode == "train" and run.seq_shard and tp_axis() is not None
                 and x.shape[1] % max(1, mesh_axis_size(tp_axis())) == 0)

    def carry(t):
        # Megatron-SP: the inter-block activation lives sequence-sharded
        # over the TP axis, and so does each branch's output before its
        # residual add (a reduce-scatter forward, a gather backward)
        return constrain(t, data_axes(), tp_axis(), None) if seq_shard else t

    h = _gathered(rms_norm(x, p["ln1"], cfg.norm_eps))
    if kind in ("attn", "local_attn"):
        y, new_cache = _self_attention(cfg, run, p["attn"], h, kind=kind,
                                       mode=mode, cache=cache, pos=pos,
                                       causal=causal)
        new_cache = new_cache or {}
    elif kind == "rglru":
        y, st = rec.apply_rglru(cfg, p["rglru"], h,
                                cache if mode == "decode" else None)
        new_cache = st if mode in ("prefill", "decode") else {}
    elif kind == "mlstm":
        y, st = rec.apply_mlstm(cfg, p["mlstm"], h,
                                cache if mode == "decode" else None,
                                chunk=run.mlstm_chunk)
        new_cache = st if mode in ("prefill", "decode") else {}
    elif kind == "slstm":
        y, st = rec.apply_slstm(cfg, p["slstm"], h,
                                cache if mode == "decode" else None)
        new_cache = st if mode in ("prefill", "decode") else {}
    else:
        raise ValueError(kind)
    x = x + carry(y)
    if "xattn" in p:
        hx = _gathered(rms_norm(x, p["ln_x"], cfg.norm_eps))
        y, xkv = _cross_attention(cfg, p["xattn"], hx, enc_out=enc_out,
                                  cache=cache)
        x = x + carry(y)
        if mode in ("prefill", "decode"):
            new_cache = dict(new_cache, **xkv)
    if "ln2" in p:
        h2 = _gathered(rms_norm(x, p["ln2"], cfg.norm_eps))
        if "moe" in p:
            y, aux = moe_lib.apply_moe(cfg, p["moe"], h2,
                                       expert_scan=run.moe_expert_scan)
        else:
            y = apply_mlp(cfg, p["mlp"], h2)
        x = x + carry(y)
    return carry(x), new_cache, aux


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def _write_back(cache: Params, new: Params) -> None:
    """Decode: copy every leaf of a block's new state that is not already
    the cache's own tensor into the cache (the RG-LRU and sLSTM states,
    and the mLSTM's on the CPU, are new tensors; attention rows, and on
    the card the mLSTM's C and n, were written in place; the
    cross-attention's ``xk``/``xv`` are the cache's own, read only)."""
    for leaf, t in new.items():
        if t is not cache[leaf]:
            cache[leaf].copy_(t)


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the products without batch dimensions (``dot``'s projections, 2-D
    ``mm`` here), recompute the rest (the attention's batched products
    among them)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(run: RunConfig, mode: str, body, params: Params):
    """The tile body under ``run.remat_policy`` in a train-mode pass that
    records gradients of ``params``: ``"nothing"`` checkpoints it (only its
    inputs are kept), ``"dots"`` keeps the products without batch
    dimensions, ``"full"`` and ``"none"`` keep everything (the body
    itself, as every pass that records nothing — serving's encoder)."""
    policy = run.remat_policy
    if (mode != "train" or policy in ("none", "full")
            or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in tree_leaves(params))):
        return body
    if policy == "nothing":
        return functools.partial(checkpoint, body)
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, body, context_fn=ctx)
    raise ValueError(f"remat_policy {policy!r}")


def _run_stack(cfg: ModelConfig, run: RunConfig, params: Params, x, *,
               mode: str, cache=None, pos=None, enc_out=None, causal=True,
               tiles_key: str = "tiles", tail_key: str = "tail"):
    """Loop the pattern-tiled stack (``tiles_key``: the decoder's or the
    encoder's), then the tail blocks; returns (x, new_cache, aux), aux
    summed over the blocks in stack order.  In mode ``"train"`` each tile
    runs under ``run.remat_policy`` (:func:`_remat`; the tail blocks
    without, as the JAX package's scan checkpoints its body only)."""
    pat = cfg.block_pattern if tiles_key == "tiles" else ("attn",)
    tiles = params[tiles_key]
    tile_caches = cache[tiles_key] if cache else None
    n_tiles = tree_leaves(tiles)[0].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(mode=mode, pos=pos, enc_out=enc_out, causal=causal)

    def tile(x, aux, tp, tc):
        new_tc = {}
        for bi, kind in enumerate(pat):
            bc = tc[f"b{bi}"] if tc else None
            x, new_tc[f"b{bi}"], a = apply_block(cfg, run, kind, tp[f"b{bi}"],
                                                 x, cache=bc, **kw)
            aux = aux + a
            if mode == "decode":
                _write_back(bc, new_tc[f"b{bi}"])
        return x, aux, new_tc

    body = _remat(run, mode, tile, tiles)
    # the stacked leaves split once: the backward of unbind writes every
    # tile's gradient into one stacked tensor, where indexing each tile
    # would build and sum a zero-padded full-size gradient per tile
    parts = tree_map(lambda a: a.unbind(0), tiles)
    per_tile = []
    for i in range(n_tiles):
        tp = tree_map(lambda a: a[i], parts)
        tc = tree_map(lambda a: a[i], tile_caches) if tile_caches else None
        x, aux, new_tc = body(x, aux, tp, tc)
        per_tile.append(new_tc)
    new_tail = {}
    if tail_key in params:
        _, tail_kinds = _tile_split(cfg)
        for bi, kind in enumerate(tail_kinds):
            bc = cache[tail_key][f"b{bi}"] if cache else None
            x, new_tail[f"b{bi}"], a = apply_block(
                cfg, run, kind, params[tail_key][f"b{bi}"], x, cache=bc,
                **kw)
            aux = aux + a
            if mode == "decode":
                _write_back(bc, new_tail[f"b{bi}"])
    if mode == "decode":
        return x, cache, aux  # every block's state written in place
    if mode != "prefill":
        return x, {}, aux
    new_cache: Params = {tiles_key: {
        f"b{bi}": {leaf: torch.stack([t[f"b{bi}"][leaf] for t in per_tile])
                   for leaf in per_tile[0][f"b{bi}"]}
        for bi in range(len(pat))}}
    if new_tail:
        new_cache[tail_key] = new_tail
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params, tokens, prefix_emb=None):
    # a gather whose backward sums each row's gradients in a fixed order
    # on the card too (PyTorch's embedding backward sorts the ids)
    x = F.embedding(tokens, pin(params["embed"]["tok"])).to(COMPUTE_DTYPE)
    if cfg.emb_scale:
        x = x * float(math.sqrt(cfg.d_model))  # stays bf16
    if prefix_emb is not None:
        pe = dot(prefix_emb.to(COMPUTE_DTYPE),
                 params["frontend_proj"].to(COMPUTE_DTYPE))
        x = torch.cat([pe, x], dim=1)
    return constrain(x, data_axes(), None, None)


def _encode(cfg: ModelConfig, run: RunConfig, params: Params, enc_emb):
    x = dot(enc_emb.to(COMPUTE_DTYPE),
            params["frontend_proj"].to(COMPUTE_DTYPE))
    x, _, _ = _run_stack(cfg, run, params, x, mode="train", causal=False,
                         tiles_key="enc_tiles", tail_key="enc_tail")
    return _gathered(rms_norm(x, params["enc_norm"], cfg.norm_eps))


def _backbone(cfg: ModelConfig, run: RunConfig, params: Params,
              batch: Dict[str, Any], mode: str):
    """Embed + stacks + final norm. Returns (x_normed, aux, cache); the
    prefix's positions are cut before the norm."""
    prefix = batch.get("prefix_emb")
    enc_out = (_encode(cfg, run, params, batch["enc_emb"])
               if cfg.kind == "encdec" else None)
    x = _embed(cfg, params, batch["tokens"], prefix)
    x, cache, aux = _run_stack(cfg, run, params, x, mode=mode,
                               enc_out=enc_out, causal=True)
    if prefix is not None and prefix.shape[1]:
        x = x[:, prefix.shape[1]:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, cache


def _head_weight(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        # a tied table's two gradients each come back in its layout (pin)
        return pin(params["embed"]["tok"]).to(COMPUTE_DTYPE).T
    return params["lm_head"].to(COMPUTE_DTYPE)


def forward(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any], mode: str = "train"):
    """Full-sequence forward. Returns (logits, aux, cache|None); aux, the
    MoE auxiliary loss summed over the blocks, is zero without experts."""
    x, aux, cache = _backbone(cfg, run, params, batch, mode)
    logits = dot(x, _head_weight(cfg, params))
    logits = constrain(logits, data_axes(), None, tp_axis())
    return logits, aux, (cache if mode == "prefill" else None)


def _ce_sums(cfg: ModelConfig, w, x, targets):
    """The CE and z-loss sums of one chunk of positions: the head's bf16
    logits cast to f32, the padded vocabulary's columns at -1e30, the
    log-sum-exp of each row less its target's logit, and the squares of
    the log-sum-exps."""
    lg = constrain(dot(x, w).float(), data_axes(), None, tp_axis())
    vocab_ids = torch.arange(lg.shape[-1], device=lg.device)
    lg = torch.where(vocab_ids < cfg.vocab, lg, NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    # the target's logit from a vocabulary-sharded DTensor is a masked
    # partial sum: reduced before the index drops its last dimension
    picked = constrain(lg.gather(-1, targets[..., None].long()),
                       data_axes(), None, None)[..., 0]
    return (lse - picked).sum(), (lse * lse).sum()


def loss_fn(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any]):
    """Next-token CE (+ z-loss, + the MoE aux). Returns (loss, metrics).

    Runs the model's plain forms on every device
    (:func:`layers.xla_route`: no kernel has a backward).  With
    ``run.loss_chunk`` the head projection and softmax-xent run a chunk of
    positions at a time, each checkpointed, so the (B, S, V) f32 logits
    are never resident; the remainder (the -1 of the target shift) runs
    unchunked after them."""
    with xla_route():
        x, aux, _ = _backbone(cfg, run, params, batch, "train")
        targets = batch["tokens"][:, 1:]
        xs = x[:, :-1]
        B, Sm1, _ = xs.shape
        w = _head_weight(cfg, params)
        sums = functools.partial(_ce_sums, cfg, w)
        chunk = run.loss_chunk
        if chunk and Sm1 > chunk:
            main = Sm1 // chunk * chunk
            ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                         device=x.device)
            for c0 in range(0, main, chunk):
                c, z = checkpoint(sums, xs[:, c0:c0 + chunk],
                                  targets[:, c0:c0 + chunk])
                ce_sum, z_sum = ce_sum + c, z_sum + z
            if main < Sm1:
                c, z = sums(xs[:, main:], targets[:, main:])
                ce_sum, z_sum = ce_sum + c, z_sum + z
        else:
            ce_sum, z_sum = sums(xs, targets)
    n_tok = B * Sm1
    ce = ce_sum / n_tok
    zl = run.z_loss * z_sum / n_tok
    loss = ce + zl + aux
    return loss, {"ce": ce, "z_loss": zl, "aux": aux, "loss": loss}


def prefill(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any]):
    """Returns (the last position's logits (B, V), the decode cache).

    Under XLA's exact CPU forms (:func:`numerics.exact_forms`) the head
    is applied to all B * S rows and the last position taken, as the JAX
    package does: a product over B rows sums in another order than one
    over B * S rows and can differ in a last bit.  On the card, and in the
    dry run's :func:`numerics.card_forms`, the head is applied to the last
    position only (the same function without the (B, S, V) tensor, 1.2 GB
    at qwen3-1.7b's serving shape)."""
    x, _, cache = _backbone(cfg, run, params, batch, "prefill")
    w = _head_weight(cfg, params)
    if numerics.exact_forms(x):
        logits = constrain(dot(x, w), data_axes(), None, tp_axis())
        return logits[:, -1], cache
    return constrain(dot(x[:, -1], w), data_axes(), tp_axis()), cache


def decode_step(cfg: ModelConfig, run: RunConfig, params: Params,
                cache: Params, tokens, pos):
    """One decode step. tokens: (B, 1); pos: the absolute position, a host
    int.  Returns (logits (B, V), the cache with this position's state
    written in place)."""
    pos = operator.index(pos)
    x = _embed(cfg, params, tokens)
    x, new_cache, _ = _run_stack(cfg, run, params, x, mode="decode",
                                 cache=cache, pos=pos, causal=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dot(x, _head_weight(cfg, params))
    return logits[:, 0], new_cache
