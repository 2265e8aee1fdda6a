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
"""
from __future__ import annotations

import math
import operator
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.machine import resolve_device
from . import moe as moe_lib
from . import recurrent as rec
from .layers import (COMPUTE_DTYPE, NEG_INF, PARAM_DTYPE, apply_mlp,
                     attention, attn_out, attn_qkv, dense_init, dot,
                     init_attn, init_mlp, rms_norm)

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
        o = attention(q, ck, cv, causal=False, kv_len=pos + 1)
        return attn_out(cfg, p, o), dict(cache, k=ck, v=cv)

    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    q, k, v = attn_qkv(cfg, p, h, positions[None].expand(B, S))
    o = attention(q, k, v, causal=causal, window=window, chunk=run.attn_chunk)
    out = attn_out(cfg, p, o)

    new_cache = None
    if mode == "prefill":
        if kind == "local_attn":
            # the ring: the last w positions, position t in slot t % w
            w = min(cfg.window, S)
            last_pos = torch.arange(S - w, S, dtype=torch.int32,
                                    device=h.device)
            slots = (last_pos % w).long()
            kk, vv = torch.zeros_like(k[:, -w:]), torch.zeros_like(v[:, -w:])
            kk[:, slots] = k[:, -w:]
            vv[:, slots] = v[:, -w:]
            sp = torch.full((w,), -1, dtype=torch.int32, device=h.device)
            sp[slots] = last_pos
            new_cache = {"k": kk, "v": vv, "slot_pos": sp}
        else:
            pad = run.decode_budget
            if pad:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            new_cache = {"k": k, "v": v}
    return out, new_cache


def _masked_decode_attn(q, k, v, mask):
    """q: (B,1,Hq,hd); k/v: (B,W,Hkv,hd); mask: (B,1,W).  The JAX model's
    plain masked attention (no Pallas kernel computes it there either):
    f32 logits, softmax, probabilities in v's dtype for P V."""
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, 1, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(NEG_INF, device=logits.device))
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
        B, Se, _ = enc_out.shape
        k = dot(enc_out, p["wk"].to(enc_out.dtype)).reshape(
            B, Se, cfg.n_kv_heads, cfg.hd)
        v = dot(enc_out, p["wv"].to(enc_out.dtype)).reshape(
            B, Se, cfg.n_kv_heads, cfg.hd)
    B, S, _ = h.shape
    q = dot(h, p["wq"].to(h.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    o = attention(q, k, v, causal=False)
    return attn_out(cfg, p, o), {"xk": k, "xv": v}


def apply_block(cfg: ModelConfig, run: RunConfig, kind: str, p: Params, x, *,
                mode: str, cache=None, pos=None, enc_out=None, causal=True):
    """Returns (x, new_cache, aux): aux is the MoE's auxiliary loss, an f32
    zero without experts."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
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
    x = x + y
    if "xattn" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        y, xkv = _cross_attention(cfg, p["xattn"], hx, enc_out=enc_out,
                                  cache=cache)
        x = x + y
        if mode in ("prefill", "decode"):
            new_cache = dict(new_cache, **xkv)
    if "ln2" in p:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            y, aux = moe_lib.apply_moe(cfg, p["moe"], h2,
                                       expert_scan=run.moe_expert_scan)
        else:
            y = apply_mlp(cfg, p["mlp"], h2)
        x = x + y
    return x, new_cache, aux


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


def _run_stack(cfg: ModelConfig, run: RunConfig, params: Params, x, *,
               mode: str, cache=None, pos=None, enc_out=None, causal=True,
               tiles_key: str = "tiles", tail_key: str = "tail"):
    """Loop the pattern-tiled stack (``tiles_key``: the decoder's or the
    encoder's), then the tail blocks; returns (x, new_cache, aux), aux
    summed over the blocks in stack order."""
    pat = cfg.block_pattern if tiles_key == "tiles" else ("attn",)
    tiles = params[tiles_key]
    tile_caches = cache[tiles_key] if cache else None
    n_tiles = tree_leaves(tiles)[0].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(mode=mode, pos=pos, enc_out=enc_out, causal=causal)
    per_tile = []
    for i in range(n_tiles):
        new_tc = {}
        for bi, kind in enumerate(pat):
            tp = tree_map(lambda a: a[i], tiles[f"b{bi}"])
            bc = (tree_map(lambda a: a[i], tile_caches[f"b{bi}"])
                  if tile_caches else None)
            x, new_tc[f"b{bi}"], a = apply_block(cfg, run, kind, tp, x,
                                                 cache=bc, **kw)
            aux = aux + a
            if mode == "decode":
                _write_back(bc, new_tc[f"b{bi}"])
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
    x = params["embed"]["tok"][tokens].to(COMPUTE_DTYPE)
    if cfg.emb_scale:
        x = x * float(math.sqrt(cfg.d_model))  # stays bf16
    if prefix_emb is not None:
        pe = dot(prefix_emb.to(COMPUTE_DTYPE),
                 params["frontend_proj"].to(COMPUTE_DTYPE))
        x = torch.cat([pe, x], dim=1)
    return x


def _encode(cfg: ModelConfig, run: RunConfig, params: Params, enc_emb):
    x = dot(enc_emb.to(COMPUTE_DTYPE),
            params["frontend_proj"].to(COMPUTE_DTYPE))
    x, _, _ = _run_stack(cfg, run, params, x, mode="train", causal=False,
                         tiles_key="enc_tiles", tail_key="enc_tail")
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


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
        return params["embed"]["tok"].to(COMPUTE_DTYPE).T
    return params["lm_head"].to(COMPUTE_DTYPE)


def forward(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any], mode: str = "train"):
    """Full-sequence forward. Returns (logits, aux, cache|None); aux, the
    MoE auxiliary loss summed over the blocks, is zero without experts."""
    x, aux, cache = _backbone(cfg, run, params, batch, mode)
    logits = dot(x, _head_weight(cfg, params))
    return logits, aux, (cache if mode == "prefill" else None)


def prefill(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any]):
    """Returns (the last position's logits (B, V), the decode cache).

    On CPU tensors the head is applied to all B * S rows and the last
    position taken, as the JAX package does: a product over B rows sums in
    another order than one over B * S rows and can differ in a last bit.
    On the card the head is applied to the last position only (the same
    function without the (B, S, V) tensor, 1.2 GB at qwen3-1.7b's serving
    shape)."""
    x, _, cache = _backbone(cfg, run, params, batch, "prefill")
    w = _head_weight(cfg, params)
    if x.device.type == "cpu":
        return dot(x, w)[:, -1], cache
    return dot(x[:, -1], w), cache


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
