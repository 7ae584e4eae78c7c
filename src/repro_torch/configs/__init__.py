"""Config registry: the 10 assigned architectures by id, their reduced
smoke variants, and the TCQ-engine workload shapes (``configs/tcq.py``).
A copy of ``repro.configs``."""

from __future__ import annotations

import importlib
from typing import Dict, List

_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "granite-34b": "granite_34b",
    "gemma-7b": "gemma_7b",
    "qwen2-7b": "qwen2_7b",
    "gemma2-2b": "gemma2_2b",
    "whisper-small": "whisper_small",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str):
    """Full-size ModelConfig for an architecture id."""
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str):
    return get_config(name).smoke()



def get_tcq_config(name: str):
    from repro_torch.configs import tcq

    return tcq.CONFIGS[name]


def list_tcq_configs() -> List[str]:
    from repro_torch.configs import tcq

    return list(tcq.CONFIGS)
