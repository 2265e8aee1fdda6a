"""Deterministic synthetic data pipeline (the JAX package's
``repro.data.pipeline``, a copy: it is numpy only, so it imports neither
JAX nor PyTorch).

Every batch is a pure function of (seed, step, host shard): restart-safe
(resume from any step without data state files), elastic (re-sharding hosts
just changes the slice each host materialises), and cheap to verify in tests.
A background prefetch thread keeps the host-side generation off the step's
critical path; it yields the stream in order however slowly it is read.
Batches are numpy arrays built on the host; the training
loop moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


class TokenStream:
    """Seeded synthetic LM batches with host sharding + checkpointable state."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        if shape.global_batch % n_hosts:
            raise ValueError(f"global batch {shape.global_batch} is not a "
                             f"multiple of {n_hosts} hosts")
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.host_id, self.n_hosts = host_id, n_hosts
        self.local_batch = shape.global_batch // n_hosts
        self.step = 0

    # -- pure batch functions --------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        cfg, shape = self.cfg, self.shape
        seq = shape.seq_len
        npfx = 0
        batch: Dict[str, np.ndarray] = {}
        if cfg.frontend is not None and cfg.kind != "encdec":
            npfx = seq // cfg.frontend_len_div
            batch["prefix_emb"] = rng.standard_normal(
                (self.local_batch, npfx, cfg.d_model), dtype=np.float32)
        if cfg.kind == "encdec":
            batch["enc_emb"] = rng.standard_normal(
                (self.local_batch, seq // cfg.frontend_len_div, cfg.d_model),
                dtype=np.float32)
        n_tok = seq - npfx
        # learnable stream: per-sequence arithmetic progressions with a small
        # stride alphabet — next-token entropy falls from ln(V) to ~ln(|strides|)
        # as the model trains, so convergence tests have a real signal.
        start = rng.integers(0, cfg.vocab, (self.local_batch, 1), dtype=np.int64)
        stride = rng.integers(1, 5, (self.local_batch, 1), dtype=np.int64)
        pos = np.arange(n_tok, dtype=np.int64)[None, :]
        batch["tokens"] = ((start + stride * pos) % cfg.vocab).astype(np.int32)
        return batch

    # -- stateful iteration (checkpointable) ------------------------------------
    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed,
                "host_id": self.host_id, "n_hosts": self.n_hosts}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        if s["seed"] != self.seed:
            raise ValueError(f"data state of seed {s['seed']}, stream seed "
                             f"{self.seed}")
        self.step = s["step"]


class Prefetcher:
    """Background-thread prefetch wrapper (depth-bounded)."""

    def __init__(self, stream: TokenStream, depth: int = 2):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # a batch that found the queue full is put again, not dropped (the
        # JAX package's prefetcher draws the next one and loses it)
        item = None
        while not self._stop.is_set():
            if item is None:
                item = next(self.stream)
            try:
                self.q.put(item, timeout=0.1)
                item = None
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
