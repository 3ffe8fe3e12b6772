"""Architecture registry of the port: all ten of the reference's archs
resolve here, in the reference's order (`repro.configs`)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ModelConfig, ShapeCell, SHAPES,
                                      cell_applicable, shape_by_name)

_MODULES: Dict[str, str] = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "ARCH_NAMES",
           "get_config", "get_smoke_config", "all_configs",
           "cell_applicable", "shape_by_name"]
