"""Architecture registry: one module per assigned architecture.

A copy of the reference package's ``configs/`` (pure dataclasses, no JAX):
the same fields, numbers, ``reduced()`` and parameter counts, so a config
names the same model in both packages.
"""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, active_param_count, param_count

from repro_torch.configs import (  # noqa: E402
    deepseek_moe_16b, llama3_2_1b, llava_next_mistral_7b, minicpm3_4b,
    phi3_5_moe_42b, qwen2_5_14b, rwkv6_3b, seamless_m4t_large_v2, yi_34b,
    zamba2_1_2b,
)

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (
        yi_34b, llama3_2_1b, qwen2_5_14b, minicpm3_4b, llava_next_mistral_7b,
        zamba2_1_2b, deepseek_moe_16b, phi3_5_moe_42b, rwkv6_3b,
        seamless_m4t_large_v2,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)
