"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064; QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, act="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, act="swiglu", qkv_bias=True, vocab_pad_multiple=16,
)
