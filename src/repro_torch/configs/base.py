"""Configuration system: model configs, input shapes, run settings."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    lb_coef: float = 0.02


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``block_pattern`` entries: attn | local_attn |
    rglru | mlstm | slstm — the pattern tiles the layer stack."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    act: str = "swiglu"                  # swiglu | geglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                      # local-attention window
    moe: Optional[MoeConfig] = None
    kind: str = "decoder"                # decoder | encdec
    enc_layers: int = 0                  # encdec only
    frontend: Optional[str] = None       # None | patch | audio (stubs)
    frontend_len_div: int = 8            # frontend seq = seq_len // div
    d_rnn: Optional[int] = None          # rglru width (default d_model)
    norm_eps: float = 1e-6
    emb_scale: bool = False              # gemma-style sqrt(d) embed scaling
    vocab_pad_multiple: int = 256

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab, self.vocab_pad_multiple)

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer block kinds, tiling block_pattern over n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer attends over unbounded context (long_500k ok)."""
        return all(k in ("rglru", "mlstm", "slstm", "local_attn")
                   for k in self.layer_kinds())

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        per_kind = {}
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        gated_ff = 3 * d * ff
        per_kind["attn"] = attn + (0 if self.d_ff == 0 else gated_ff)
        per_kind["local_attn"] = per_kind["attn"]
        dr = self.rnn_width
        per_kind["rglru"] = 2 * d * dr + dr * d + 2 * dr + 4 * dr + (0 if ff == 0 else 3 * d * ff)
        per_kind["mlstm"] = 2 * d * 2 * d + 3 * (2 * d) * (2 * d) // 1 // 4 + 2 * d * d  # approx
        per_kind["slstm"] = 4 * d * d + 4 * d * d // max(self.n_heads, 1) + 2 * d * d
        if self.moe:
            e = self.moe
            per_expert = 3 * d * e.d_ff_expert
            moe_ff = (e.n_experts + e.n_shared) * per_expert + d * e.n_experts
            per_kind["attn"] = attn + moe_ff
        for k in self.layer_kinds():
            n += per_kind[k] + 2 * d  # + norms
        if self.kind == "encdec":
            # encoder layers: self-attn + ff; decoder already counted above,
            # add cross-attention per decoder layer
            n += self.enc_layers * (per_kind["attn"] + 2 * d)
            n += self.n_layers * (attn + d)
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        e = self.moe
        d = self.d_model
        per_expert = 3 * d * e.d_ff_expert
        inactive = (e.n_experts - e.top_k) * per_expert * self.n_layers
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """long_500k only for sub-quadratic archs (skip noted in DESIGN.md)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run settings (optimizer, schedule, checkpointing)."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    seed: int = 0
    remat_policy: str = "nothing"        # nothing | dots | full
    grad_compression: str = "none"       # none | int8_ef
    ckpt_every: int = 200
    ckpt_keep: int = 3
    ckpt_dir: str = "/tmp/repro_ckpt"
    attn_impl: str = "xla"               # xla | pallas
    attn_chunk: int = 1024               # q-chunk for online-softmax attention
    mlstm_chunk: int = 256
    decode_budget: int = 64              # extra KV slots appended at prefill
    seq_shard: bool = True               # Megatron-SP: shard inter-block
                                         # activations (scan carries) on seq
                                         # over the TP axis in train mode
    attn_act_constraints: bool = False   # force q/k/v head-layout shardings
                                         # (OFF: propagation chooses; see
                                         # EXPERIMENTS.md §Perf iteration 1)
    loss_chunk: int = 0                  # fused-xent seq chunk (0 = off);
                                         # avoids resident (B,S,V) f32 logits
    attn_chunk_remat: bool = False       # checkpoint each attention q-chunk
                                         # (backward never stacks S^2 probs;
                                         # §Perf iteration 2)
    moe_expert_scan: bool = True         # scan over experts (small buffers)
                                         # vs one E-batched einsum (fewer
                                         # fusion boundaries, better MXU)
    microbatch: int = 1                  # gradient-accumulation steps: batch
                                         # is split on-device and grads
                                         # accumulate under a scan (memory /
                                         # collective trade)
    sharding_mode: str = "2d"            # 2d (FSDP×TP) | zero3 (FSDP-only:
                                         # no TP activation all-reduces,
                                         # params gathered per layer)
    param_wire_bf16: bool = False        # cast params to bf16 *before* use so
                                         # FSDP all-gathers (and the mirrored
                                         # grad reduce-scatters) move half the
                                         # bytes; f32 master stays sharded
                                         # (§Perf iteration 3)
