"""Batched serving demo: prefill and greedy decode with the KV-cache
engine, on the card.

The JAX package's ``examples/serve_demo.py`` through the port's
``ServeEngine``: a SMOKE config, weights drawn from a seeded CPU
``torch.Generator`` (the same on every device) and moved to the device,
three seeded prompts.  On the card prefill attention runs in the
flash-attention kernel and decode attention in flash-decode; the RG-LRU
scan (``--arch recurrentgemma-2b``) and the mLSTM (``--arch xlstm-350m``)
in theirs.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo \
        [--arch recurrentgemma-2b] [--new-tokens 12] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCHS, get_smoke
from ..configs.base import ModelConfig, RunConfig
from ..core.machine import resolve_device
from ..models import lm
from ..serve.engine import Completion, Request, ServeEngine

PROMPT_LENS = (6, 9, 4)
MAX_BATCH = 4


def demo_run(new_tokens: int) -> RunConfig:
    return RunConfig(attn_chunk=8, mlstm_chunk=4, remat_policy="none",
                     decode_budget=max(new_tokens, 16))


def demo_requests(cfg: ModelConfig, new_tokens: int) -> List[Request]:
    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=new_tokens) for n in PROMPT_LENS]


def demo_engine(arch: str, new_tokens: int, device=None,
                params: Optional[dict] = None
                ) -> Tuple[ServeEngine, List[Request]]:
    """The engine (on ``device``, None: the card) and its requests.
    ``params`` (the port's parameter tree on that device) replaces the
    seeded weights."""
    dev = resolve_device(device)
    cfg = get_smoke(arch)
    if params is None:
        params = lm.tree_map(lambda t: t.to(dev), lm.init_params(
            cfg, torch.Generator().manual_seed(0)))
    engine = ServeEngine(cfg, demo_run(new_tokens), params,
                         max_batch=MAX_BATCH, device=dev)
    return engine, demo_requests(cfg, new_tokens)


def demo_lines(reqs: List[Request], outs: List[Completion]) -> List[str]:
    return [f"req{i}: prompt={rq.prompt.tolist()} -> {out.tokens.tolist()}"
            for i, (rq, out) in enumerate(zip(reqs, outs))]


def serve_demo(arch: str = "qwen3-1.7b", new_tokens: int = 12, device=None,
               params: Optional[dict] = None) -> List[str]:
    """The example's lines: each request's prompt and generated tokens."""
    engine, reqs = demo_engine(arch, new_tokens, device, params)
    return demo_lines(reqs, engine.generate(reqs))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCHS))
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch forms on the CPU)")
    args = ap.parse_args(argv)
    print("\n".join(serve_demo(args.arch, args.new_tokens, args.device)))


if __name__ == "__main__":
    main()
