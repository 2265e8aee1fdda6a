"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres patch frontend is a STUB (precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, act="swiglu", rope_theta=5_000_000.0,
    frontend="patch", frontend_len_div=8,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, act="swiglu", frontend="patch",
    frontend_len_div=4, vocab_pad_multiple=16,
)
