"""Architecture registry of the port: the ported archs resolve here.

Two of the reference's ten archs are ported: zamba2-7b (hybrid) and
mamba2-130m (ssm). The other eight are listed in ROADMAP.md (queue 1, the
LLM stack) as still to port; asking for one raises KeyError.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ModelConfig, ShapeCell, SHAPES,
                                      cell_applicable, shape_by_name)

_MODULES: Dict[str, str] = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP.md, queue "
                       f"1, the LLM stack); ported: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "ARCH_NAMES",
           "get_config", "get_smoke_config", "cell_applicable",
           "shape_by_name"]
