"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.

12 encoder + 12 decoder layers, d_model=1024, 16H (GQA kv=16), d_ff=4096,
vocab=256206 (padded to 256256 for TP divisibility).  [arXiv:2308.11596; hf]
The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (backbone-only, per the assignment).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, act="gelu", kind="encdec", enc_layers=12,
    frontend="audio", frontend_len_div=8, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, act="gelu", kind="encdec", enc_layers=2,
    frontend="audio", frontend_len_div=4, vocab_pad_multiple=16,
)
