"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch`` ids."""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "hubert_xlarge",
    "pixtral_12b",
    "deepseek_7b",
    "mistral_nemo_12b",
    "qwen2_7b",
    "gemma_7b",
    "deepseek_moe_16b",
    "deepseek_v2_lite_16b",
    "mamba2_1p3b",
    "zamba2_2p7b",
]

#: dashes/dots tolerated on the CLI
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({"mamba2-1.3b": "mamba2_1p3b", "zamba2-2.7b": "zamba2_2p7b",
                 "deepseek-v2-lite": "deepseek_v2_lite_16b",
                 "deepseek-moe": "deepseek_moe_16b"})


def arch_id(arch: str) -> str:
    """The registry id of ``arch``: an id, its dashed form or an alias
    (``mamba2-1.3b``); raises ``ValueError`` for an unknown name."""
    key = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if key not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return key


def get_config(arch: str) -> ModelConfig:
    try:
        key = arch_id(arch)
    except ValueError as e:
        raise KeyError(str(e)) from None
    mod = importlib.import_module(f".{key}", __package__)
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{arch_id(arch)}", __package__)
    return mod.smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
