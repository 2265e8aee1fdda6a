"""The yardstick's arithmetic: the bytes a census needs, the model FLOPs
of a training step, and the card's published peaks.

The census byte count is the one the port's bring-up check used
(``census_bound_ms`` at commit ef15f65), copied so that a later change to
the program cannot move it.  Its operation term is left out: NVIDIA
publishes no 64-bit integer rate for the H100, and the census's work is
64-bit integer arithmetic, so the least time here is the bytes' alone
and a share of it reads at or below the share of a bound that also
counted operations.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 data sheet (dense, no sparsity): HBM3 bandwidth and the
# bf16 tensor-core rate; they assume the card's full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# the census's carry: 173 int64 words a lane besides ``mem`` and
# ``k_ino_data`` (read once and written once), the int32 image id, and
# 16 bytes of decode table a code word
SMALL_WORDS = 173


def census_bytes(*, lanes: int, code_words: int, stream_bytes: int,
                 emul_payload: int) -> int:
    """The bytes one untraced census needs: each lane's small carry read
    and written once, its image id, the distinct images' decode tables,
    the guest's stream I/O, and the emulation's data mover, which reads
    each payload byte from one plane and writes it to the other."""
    return (lanes * 8 * 2 * SMALL_WORDS + lanes * 4 + 16 * code_words
            + stream_bytes + 2 * emul_payload)


def census_least_s(**kw) -> float:
    return census_bytes(**kw) / HBM_BYTES_PER_S


def train_flops(*, params_in_matmuls: int, layers: int, heads: int,
                head_dim: int, seq_len: int, tokens: int) -> float:
    """Model FLOPs of one training step in PaLM's convention (Chowdhery et
    al. 2022, appendix B): 6 N T for the matmuls of the forward and the
    backward, plus 12 L H d_h S T for the attention's two products, the
    causal mask not discounted and recomputation not counted."""
    return (6.0 * params_in_matmuls * tokens
            + 12.0 * layers * heads * head_dim * seq_len * tokens)


def qwen3_matmul_params(c: Dict) -> int:
    """The parameters of a Qwen3 configuration that take part in a matmul
    for each token: every projection of every layer and the (tied) output
    head over the published vocabulary; norms left out."""
    d, ff, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    nq, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    per_layer = d * nq * hd * 2 + d * nkv * hd * 2 + 3 * d * ff
    return c["num_hidden_layers"] * per_layer + c["vocab_size"] * d
