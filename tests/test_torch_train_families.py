"""The port's training loss and gradients against the JAX package's for
the families whose JAX gradients take longest to compile: the hybrid
(recurrentgemma-2b: RG-LRU scan and local attention), the xLSTM
(xlstm-350m: mLSTM and sLSTM) and the encoder-decoder
(seamless-m4t-medium) — held as ``tests/test_torch_train.py`` holds the
others (loss within 1e-6 relative, every leaf's gradient within relative
L2 2e-2 of ``jax.grad``).
"""
import pytest

from test_torch_train import FAMILIES, assert_loss_and_grads_match_jax
from test_torch_train import one_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    assert_loss_and_grads_match_jax(arch)
