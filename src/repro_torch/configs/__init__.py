"""Config registry: one module per architecture, the reference's ten.
``get_config(name)`` returns the full ModelConfig; ``get_smoke_config(name)``
returns the reduced same-family config used by CPU tests. ``ARCHS`` holds
the dense decoder family, the recurrent models (RecurrentGemma's RG-LRU
hybrid, xLSTM), the MoE models (DeepSeek-V3 with MLA, Llama-4 Maverick),
the VLM (InternVL2's patch frontend stub) and the encoder-decoder model
(Whisper), in the reference's order.
"""
from __future__ import annotations

import importlib

from .base import (ModelConfig, ParallelConfig, RunConfig, ShapeConfig,
                   SHAPES)

ARCHS = [
    "qwen15_110b",
    "phi3_medium_14b",
    "phi4_mini_3p8b",
    "gemma3_1b",
    "internvl2_1b",
    "xlstm_350m",
    "deepseek_v3_671b",
    "llama4_maverick",
    "recurrentgemma_2b",
    "whisper_base",
]

# canonical ids as assigned (hyphens) -> module names
_ALIASES = {
    "qwen1.5-110b": "qwen15_110b",
    "phi3-medium-14b": "phi3_medium_14b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "gemma3-1b": "gemma3_1b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-350m": "xlstm_350m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-base": "whisper_base",
}


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_arch_names() -> list[str]:
    return list(ARCHS)


__all__ = ["ModelConfig", "ParallelConfig", "RunConfig", "ShapeConfig",
           "SHAPES", "ARCHS", "get_config",
           "get_smoke_config", "all_arch_names"]
