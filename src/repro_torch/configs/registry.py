"""Architecture registry: ``--arch <id>`` lookup for every launcher."""
from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig
from .deepseek_7b import CONFIG as _deepseek_7b
from .gemma_7b import CONFIG as _gemma_7b
from .granite_moe_1b import CONFIG as _granite_moe
from .jamba_1_5_large import CONFIG as _jamba
from .llama4_maverick_400b import CONFIG as _llama4
from .mamba2_2_7b import CONFIG as _mamba2
from .mistral_nemo_12b import CONFIG as _nemo
from .musicgen_large import CONFIG as _musicgen
from .paper_models import QWEN3_1_7B, QWEN3_30B_A3B, QWEN3_8B
from .qwen1_5_110b import CONFIG as _qwen110b
from .qwen2_vl_2b import CONFIG as _qwen2vl

__all__ = ["ARCHS", "PAPER_MODELS", "get_config", "list_archs"]

#: The ten assigned architectures (the dry-run / roofline matrix).
ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _qwen2vl,
        _qwen110b,
        _gemma_7b,
        _deepseek_7b,
        _nemo,
        _musicgen,
        _granite_moe,
        _llama4,
        _mamba2,
        _jamba,
    ]
}

#: The paper's own models (benchmarks only, not dry-run cells).
PAPER_MODELS: Dict[str, ModelConfig] = {
    c.name: c for c in [QWEN3_1_7B, QWEN3_8B, QWEN3_30B_A3B]
}

_ALL = {**ARCHS, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _ALL:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ALL)}"
        )
    return _ALL[name]


def list_archs(include_paper: bool = False) -> List[str]:
    return sorted(ARCHS if not include_paper else _ALL)
