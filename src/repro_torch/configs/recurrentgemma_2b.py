"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, pattern (R,R,A), window=2048.
Sub-quadratic: runs long_500k. [arXiv:2402.19427; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, act="geglu",
    block_pattern=("rglru", "rglru", "local_attn"), window=2048,
    d_rnn=2560, tie_embeddings=True, emb_scale=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256, act="geglu",
    block_pattern=("rglru", "rglru", "local_attn"), window=16,
    d_rnn=64, tie_embeddings=True, emb_scale=True, vocab_pad_multiple=16,
)
