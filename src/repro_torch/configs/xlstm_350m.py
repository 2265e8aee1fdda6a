"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304;
mLSTM (matrix memory) + sLSTM blocks, pattern 3:1 (m,m,m,s).
Sub-quadratic: runs long_500k. [arXiv:2405.04517; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304, act="gelu",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256, act="gelu",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    tie_embeddings=True, vocab_pad_multiple=16,
)
