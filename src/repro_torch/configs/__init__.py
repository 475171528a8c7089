"""Config registry: ``get_config("<arch-id>")`` (the port of
``repro.configs``: the same ten architectures, in the same order, with
``CONFIG``/``SMOKE`` copied field for field)."""

from __future__ import annotations

from typing import List

from .base import (ArchConfig, ShapeSpec, SHAPES, LONG_CONTEXT_OK,
                   cell_supported, extra_input_specs, input_specs)
from . import (qwen2_5_14b, deepseek_7b, gemma3_27b, minicpm_2b,
               deepseek_v3_671b, mixtral_8x22b, mamba2_780m,
               internvl2_2b, recurrentgemma_9b, whisper_base)

_MODULES = {
    "qwen2.5-14b": qwen2_5_14b,
    "deepseek-7b": deepseek_7b,
    "gemma3-27b": gemma3_27b,
    "minicpm-2b": minicpm_2b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mixtral-8x22b": mixtral_8x22b,
    "mamba2-780m": mamba2_780m,
    "internvl2-2b": internvl2_2b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "whisper-base": whisper_base,
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "LONG_CONTEXT_OK",
           "cell_supported", "extra_input_specs", "input_specs",
           "get_config", "ARCH_NAMES"]
