"""Architecture config registry: ``--arch <id>`` lookup.

Every assigned architecture cites its source in the module docstring.
``get_config(name)`` returns the full production config;
``get_config(name, reduced=True)`` the CPU smoke variant.
"""

from typing import Dict, List

from repro_torch.models.config import ModelConfig

from . import (deepseek_v2_236b, internvl2_1b, mamba2_1_3b, musicgen_large,
               phi35_moe_42b, qwen1_5_4b, qwen2_7b, qwen3_32b, stablelm_1_6b,
               zamba2_2_7b)

_REGISTRY = {
    "qwen3-32b": qwen3_32b.config,
    "musicgen-large": musicgen_large.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "internvl2-1b": internvl2_1b.config,
    "zamba2-2.7b": zamba2_2_7b.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.config,
    "qwen1.5-4b": qwen1_5_4b.config,
    "qwen2-7b": qwen2_7b.config,
    "stablelm-1.6b": stablelm_1_6b.config,
}


def arch_names() -> List[str]:
    return list(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg.reduced() if reduced else cfg


__all__ = ["arch_names", "get_config", "ModelConfig"]
