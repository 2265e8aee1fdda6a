"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936; 60 routed experts top-4 + 4 shared (fine-grained).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936, act="swiglu",
    moe=MoeConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, act="swiglu", vocab_pad_multiple=16,
    moe=MoeConfig(n_experts=6, top_k=2, d_ff_expert=64, n_shared=2),
)
