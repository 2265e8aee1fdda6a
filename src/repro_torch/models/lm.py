"""The decoder-only LM of the PyTorch port: ``attn``, ``local_attn``,
``rglru``, ``mlstm`` and ``slstm`` blocks, tail blocks, their decode
caches.

The JAX package's ``models/lm.py`` for the decoders without experts,
encoder or modality frontend (qwen3-1.7b, qwen3-4b, gemma-7b,
qwen1.5-110b, recurrentgemma-2b, xlstm-350m); :func:`check_ported` raises
``NotImplementedError`` for the rest, naming what is missing.  The
parameter tree is the JAX package's, leaf for leaf: ``{"embed": {"tok"},
"final_norm", "tiles": {"b<i>": <block stacked over n_tiles>}[, "tail":
{"b<i>": <block>}][, "lm_head"]}``, where the tail holds the
``n_layers % len(block_pattern)`` blocks after the last whole tile, so
weights carry across with :mod:`repro_torch.models.interop`.  The
``lax.scan`` over tiles is a Python loop over the stacked leading axis.

Modes:
  * ``train``   — full-sequence forward, no cache.
  * ``prefill`` — full-sequence forward, returns the decode cache: K/V of
    the prompt padded with ``run.decode_budget`` zero slots (``attn``), a
    ring of the last ``min(window, S)`` positions with their positions in
    ``slot_pos`` (``local_attn``), the last h and conv taps (``rglru``),
    the matrix memory C and normaliser n (``mlstm``), the c, n, m, h
    carry (``slstm``).
  * ``decode``  — one token against the cache.  Every block's new state
    is written into the cache in place (the JAX function returns a new
    cache; here the returned cache is the one passed in, updated), which
    saves a copy of the whole cache per token.

Attention on CUDA tensors runs through the hand-written kernels (prefill,
windowed or not, through flash attention; ``attn`` decode through
flash-decode); CPU tensors take the JAX model's plain attention
(:func:`layers.attention`).  The ring decode of ``local_attn`` is the JAX
model's masked attention (:func:`_masked_decode_attn`) on both devices.
The RG-LRU scan and the mLSTM run through their kernels on the card;
the sLSTM is plain PyTorch, a loop over time, on both devices
(:mod:`repro_torch.models.recurrent`).  The xLSTM blocks have no MLP
(``ln2``/``mlp``), as in the JAX model.
"""
from __future__ import annotations

import math
import operator
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.machine import resolve_device
from . import recurrent as rec
from .layers import (COMPUTE_DTYPE, NEG_INF, PARAM_DTYPE, apply_mlp,
                     attention, attn_out, attn_qkv, dense_init, dot,
                     init_attn, init_mlp, rms_norm)

Params = Dict[str, Any]
PORTED_KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first block kind or
    feature of ``cfg`` that the port does not have yet."""
    for kind in cfg.block_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: moe is not ported yet")
    if cfg.kind != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: model kind {cfg.kind!r} (encdec) is not ported yet")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet")


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
                lead=()) -> Params:
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
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        p["ln2"] = ones()
        p["mlp"] = init_mlp(cfg, gen, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on its device (a CUDA
    generator puts them on the card).  Same tree and scales as the JAX
    package's ``init_params``; the values differ (another generator)."""
    check_ported(cfg)
    n_tiles, tail = _tile_split(cfg)
    params: Params = {
        # 1/sqrt(d) so tied-head logits are O(1) at init
        "embed": {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                    scale=1.0 / math.sqrt(cfg.d_model))},
        "final_norm": torch.ones((cfg.d_model,), dtype=PARAM_DTYPE,
                                 device=gen.device),
    }
    params["tiles"] = {f"b{bi}": _init_block(cfg, kind, gen,
                                             lead=(n_tiles,))
                       for bi, kind in enumerate(cfg.block_pattern)}
    if tail:
        params["tail"] = {f"b{bi}": _init_block(cfg, kind, gen)
                          for bi, kind in enumerate(tail)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab))
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      *, lead=(), device) -> Params:
    lead = tuple(lead)
    if kind in ("rglru", "mlstm", "slstm"):
        init = getattr(rec, f"init_{kind}_cache")
        return init(cfg, batch, lead=lead, device=device)
    if kind == "local_attn":
        seq_len = min(cfg.window, seq_len)
    elif kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    shape = lead + (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    c = {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
         "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    if kind == "local_attn":
        c["slot_pos"] = torch.full(lead + (seq_len,), -1, dtype=torch.int32,
                                   device=device)
    return c


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Params:
    """An all-zero decode cache of ``seq_len`` positions; ``device=None``
    is the card."""
    check_ported(cfg)
    dev = resolve_device(device)
    n_tiles, tail = _tile_split(cfg)
    cache: Params = {"tiles": {
        f"b{bi}": _init_block_cache(cfg, kind, batch, seq_len,
                                    lead=(n_tiles,), device=dev)
        for bi, kind in enumerate(cfg.block_pattern)}}
    if tail:
        cache["tail"] = {f"b{bi}": _init_block_cache(cfg, kind, batch,
                                                     seq_len, device=dev)
                         for bi, kind in enumerate(tail)}
    return cache


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _self_attention(cfg: ModelConfig, run: RunConfig, p: Params, h, *,
                    kind: str, mode: str, cache, pos):
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
    o = attention(q, k, v, causal=True, window=window, chunk=run.attn_chunk)
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


def apply_block(cfg: ModelConfig, run: RunConfig, kind: str, p: Params, x, *,
                mode: str, cache=None, pos=None):
    """Returns (x, new_cache).  (The JAX function also returns the MoE
    auxiliary loss, zero without experts.)"""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local_attn"):
        y, new_cache = _self_attention(cfg, run, p["attn"], h, kind=kind,
                                       mode=mode, cache=cache, pos=pos)
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
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    x = x + y
    if "ln2" in p:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + apply_mlp(cfg, p["mlp"], h2)
    return x, new_cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def _write_back(cache: Params, new: Params) -> None:
    """Decode: copy every leaf of a block's new state that is not already
    the cache's own tensor into the cache (the RG-LRU and sLSTM states,
    and the mLSTM's on the CPU, are new tensors; attention rows, and on
    the card the mLSTM's C and n, were written in place)."""
    for leaf, t in new.items():
        if t is not cache[leaf]:
            cache[leaf].copy_(t)


def _run_stack(cfg: ModelConfig, run: RunConfig, params: Params, x, *,
               mode: str, cache=None, pos=None):
    """Loop the pattern-tiled stack, then the tail blocks; returns
    (x, new_cache)."""
    pat = cfg.block_pattern
    tiles = params["tiles"]
    tile_caches = cache["tiles"] if cache else None
    n_tiles = tree_leaves(tiles)[0].shape[0]
    per_tile = []
    for i in range(n_tiles):
        new_tc = {}
        for bi, kind in enumerate(pat):
            tp = tree_map(lambda a: a[i], tiles[f"b{bi}"])
            bc = (tree_map(lambda a: a[i], tile_caches[f"b{bi}"])
                  if tile_caches else None)
            x, new_tc[f"b{bi}"] = apply_block(
                cfg, run, kind, tp, x, mode=mode, cache=bc, pos=pos)
            if mode == "decode":
                _write_back(bc, new_tc[f"b{bi}"])
        per_tile.append(new_tc)
    new_tail = {}
    if "tail" in params:
        _, tail_kinds = _tile_split(cfg)
        for bi, kind in enumerate(tail_kinds):
            bc = cache["tail"][f"b{bi}"] if cache else None
            x, new_tail[f"b{bi}"] = apply_block(
                cfg, run, kind, params["tail"][f"b{bi}"], x, mode=mode,
                cache=bc, pos=pos)
            if mode == "decode":
                _write_back(bc, new_tail[f"b{bi}"])
    if mode == "decode":
        return x, cache  # every block's state written in place
    if mode != "prefill":
        return x, {}
    new_cache: Params = {"tiles": {
        f"b{bi}": {leaf: torch.stack([t[f"b{bi}"][leaf] for t in per_tile])
                   for leaf in per_tile[0][f"b{bi}"]}
        for bi in range(len(pat))}}
    if new_tail:
        new_cache["tail"] = new_tail
    return x, new_cache


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params, tokens):
    x = params["embed"]["tok"][tokens].to(COMPUTE_DTYPE)
    if cfg.emb_scale:
        x = x * float(math.sqrt(cfg.d_model))  # stays bf16
    return x


def _backbone(cfg: ModelConfig, run: RunConfig, params: Params,
              batch: Dict[str, Any], mode: str):
    """Embed + stack + final norm. Returns (x_normed, cache)."""
    check_ported(cfg)
    x = _embed(cfg, params, batch["tokens"])
    x, cache = _run_stack(cfg, run, params, x, mode=mode)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, cache


def _head_weight(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        return params["embed"]["tok"].to(COMPUTE_DTYPE).T
    return params["lm_head"].to(COMPUTE_DTYPE)


def forward(cfg: ModelConfig, run: RunConfig, params: Params,
            batch: Dict[str, Any], mode: str = "train"):
    """Full-sequence forward. Returns (logits, aux, cache|None); aux, the
    MoE auxiliary loss, is zero without experts."""
    x, cache = _backbone(cfg, run, params, batch, mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    x, cache = _backbone(cfg, run, params, batch, "prefill")
    w = _head_weight(cfg, params)
    if x.device.type == "cpu":
        return dot(x, w)[:, -1], cache
    return dot(x[:, -1], w), cache


def decode_step(cfg: ModelConfig, run: RunConfig, params: Params,
                cache: Params, tokens, pos):
    """One decode step. tokens: (B, 1); pos: the absolute position, a host
    int.  Returns (logits (B, V), the cache with this position's state
    written in place)."""
    check_ported(cfg)
    pos = operator.index(pos)
    x = _embed(cfg, params, tokens)
    x, new_cache = _run_stack(cfg, run, params, x, mode="decode",
                              cache=cache, pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dot(x, _head_weight(cfg, params))
    return logits[:, 0], new_cache
