"""Batched serving engine: prefill + greedy decode against the KV cache.

The JAX package's ``serve/engine.py``, behaviour for behaviour: requests
are batched up to ``max_batch``; prompts are left-padded with token 0 to
the longest prompt of the batch, and the padding is not masked (it is
attended to as tokens at positions 0..); a model with a modality
frontend gets a zero prefix of ``max(plen // frontend_len_div, 1)``
positions before the tokens (decode positions then start past it), the
encoder-decoder a zero encoder input of that many frames; one prefill,
then one decode step per new token with one argmax and one host copy per
step; the cache must hold every new token (``run.decode_budget``).  On
the card the model's kernels run: flash attention for every prefill
attention layer (with the window for recurrentgemma-2b's local
attention; over the prefix and the tokens for llava-next-34b; the
encoder's non-causal layers and the cross-attention over the encoder
output for seamless-m4t-medium) and flash-decode for every decode step's
``attn`` layer and cross-attention; the RG-LRU scan kernel for every
RG-LRU layer's prefill and decode step, the ring decode of local
attention being the model's plain masked attention; the mLSTM kernels
for every mLSTM layer's prefill (the scores pass and the state pass) and
decode step (in place, in the cache), the sLSTM being a plain loop over
time; the MoE's routing, experts and combine are PyTorch operations
(qwen2-moe-a2.7b, dbrx-132b).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.machine import resolve_device
from ..models import lm


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray           # (n_new,) int32


def model_input(cfg: ModelConfig, toks, plen: int):
    """The model's input for a padded batch of tokens ``toks`` (B, plen),
    and the prefix length: zero ``prefix_emb`` of ``npfx = max(plen //
    frontend_len_div, 1)`` positions for a decoder with a frontend, zero
    ``enc_emb`` of as many frames for the encoder-decoder (its prefix is
    0), on the tokens' device."""
    batch = {"tokens": toks}
    n = max(plen // cfg.frontend_len_div, 1)
    shape = (toks.shape[0], n, cfg.d_model)
    if cfg.kind == "encdec":
        batch["enc_emb"] = torch.zeros(shape, device=toks.device)
    elif cfg.frontend is not None:
        batch["prefix_emb"] = torch.zeros(shape, device=toks.device)
        return batch, n
    return batch, 0


class ServeEngine:
    """``params`` live on ``device`` (``None`` = the card; pass
    ``device="cpu"`` for the plain version on the CPU)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params, *,
                 max_batch: int = 8, device=None):
        self.cfg, self.run, self.params = cfg, run, params
        self.max_batch = max_batch
        self.device = resolve_device(device)
        for leaf in lm.tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"a parameter is on {leaf.device}, the "
                                 f"engine runs on {self.device}")

    def _pad_batch(self, reqs: List[Request]):
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        return torch.from_numpy(toks).to(self.device), plen

    def generate(self, reqs: List[Request]) -> List[Completion]:
        out: List[Completion] = []
        for i in range(0, len(reqs), self.max_batch):
            out.extend(self._generate_batch(reqs[i:i + self.max_batch]))
        return out

    def _generate_batch(self, reqs: List[Request]) -> List[Completion]:
        cfg, run = self.cfg, self.run
        toks, plen = self._pad_batch(reqs)
        n_new = max(r.max_new_tokens for r in reqs)
        if n_new > run.decode_budget:
            raise AssertionError("decode budget too small")
        batch, npfx = model_input(cfg, toks, plen)
        logits, cache = lm.prefill(cfg, run, self.params, batch)
        new_tokens = np.zeros((len(reqs), n_new), np.int32)
        cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        for t in range(n_new):
            new_tokens[:, t] = cur.cpu().numpy()
            logits, cache = lm.decode_step(cfg, run, self.params, cache,
                                           cur[:, None], plen + npfx + t)
            cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        return [Completion(tokens=new_tokens[i, :r.max_new_tokens])
                for i, r in enumerate(reqs)]
