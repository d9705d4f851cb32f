"""Config registry: one module per architecture ported so far.
``get_config(name)`` returns the full ModelConfig; ``get_smoke_config(name)``
returns the reduced same-family config used by CPU tests. ``ARCHS`` grows
as the model stack is ported (``repro.configs`` lists the rest).
"""
from __future__ import annotations

import importlib

from .base import (ModelConfig, ParallelConfig, RunConfig, ShapeConfig,
                   SHAPES)

ARCHS = [
    "phi4_mini_3p8b",
]

# canonical ids as assigned (hyphens) -> module names
_ALIASES = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
}


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise ValueError(f"unknown or not yet ported architecture {name!r}; "
                         f"ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_arch_names() -> list[str]:
    return list(ARCHS)


__all__ = ["ModelConfig", "ParallelConfig", "RunConfig", "ShapeConfig",
           "SHAPES", "ARCHS", "get_config", "get_smoke_config",
           "all_arch_names"]
