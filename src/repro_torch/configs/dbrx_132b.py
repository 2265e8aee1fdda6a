"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, act="swiglu", qk_norm=False,
    rope_theta=500_000.0,
    moe=MoeConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, act="swiglu", vocab_pad_multiple=16,
    moe=MoeConfig(n_experts=4, top_k=2, d_ff_expert=96),
)
