"""Config registry: ``--arch <id>`` resolution for the ten architectures.

A copy of the JAX package's registry, data only, field for field (a test
holds it there).  The port's model (:mod:`repro_torch.models.lm`) runs
every one of them.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import (dbrx_132b, gemma_7b, llava_next_34b, qwen2_moe_a27b,
               qwen3_17b, qwen3_4b, qwen15_110b, recurrentgemma_2b,
               seamless_m4t_medium, xlstm_350m)
from .base import (LM_SHAPES, ModelConfig, MoeConfig, RunConfig, ShapeConfig,
                   applicable_shapes, shape_by_name)

_MODULES = {
    "seamless-m4t-medium": seamless_m4t_medium,
    "gemma-7b": gemma_7b,
    "qwen3-4b": qwen3_4b,
    "qwen1.5-110b": qwen15_110b,
    "qwen3-1.7b": qwen3_17b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "dbrx-132b": dbrx_132b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "llava-next-34b": llava_next_34b,
    "xlstm-350m": xlstm_350m,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.CONFIG for k, m in _MODULES.items()}


__all__ = [
    "ARCHS", "LM_SHAPES", "ModelConfig", "MoeConfig", "RunConfig",
    "ShapeConfig", "all_configs", "applicable_shapes", "get_config",
    "get_smoke", "shape_by_name",
]
