"""Batched serving engine: prefill + greedy decode against the KV cache.

The JAX package's ``serve/engine.py``, behaviour for behaviour: requests
are batched up to ``max_batch``; prompts are left-padded with token 0 to
the longest prompt of the batch, and the padding is not masked (it is
attended to as tokens at positions 0..); one prefill, then one decode step
per new token with one argmax and one host copy per step; the cache must
hold every new token (``run.decode_budget``).  On the card the model's
kernels run: for the attention-only decoders (qwen3, gemma-7b, qwen1.5)
flash attention for every prefill layer and flash-decode for every decode
step's layer; for recurrentgemma-2b flash attention (with the window) for
every local-attention prefill and the RG-LRU scan kernel for every RG-LRU
layer's prefill and decode step, the ring decode of local attention being
the model's plain masked attention; for xlstm-350m the mLSTM kernels for
every mLSTM layer's prefill (the scores pass and the state pass) and
decode step (in place, in the cache), the sLSTM being a plain loop over
time.
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


class ServeEngine:
    """``params`` live on ``device`` (``None`` = the card; pass
    ``device="cpu"`` for the plain version on the CPU)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params, *,
                 max_batch: int = 8, device=None):
        lm.check_ported(cfg)
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
        logits, cache = lm.prefill(cfg, run, self.params, {"tokens": toks})
        new_tokens = np.zeros((len(reqs), n_new), np.int32)
        cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        for t in range(n_new):
            new_tokens[:, t] = cur.cpu().numpy()
            logits, cache = lm.decode_step(cfg, run, self.params, cache,
                                           cur[:, None], plen + t)
            cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        return [Completion(tokens=new_tokens[i, :r.max_new_tokens])
                for i, r in enumerate(reqs)]
