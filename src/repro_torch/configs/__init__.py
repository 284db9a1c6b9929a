"""Configuration registry, the port's copy of ``src/repro/configs``: the
federated-run dataclasses and the ten architectures, ``get_arch("olmo-1b")``,
``get_shape("train_4k")``."""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig, FaultConfig, FederatedConfig, ShapeConfig, SHAPES, validate,
)

from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.yi_34b import CONFIG as _yi

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _rwkv6,
        _rgemma,
        _dsv2,
        _llama3,
        _olmo,
        _stablelm,
        _llama4,
        _llava,
        _musicgen,
        _yi,
    )
}

for _c in ARCHS.values():
    validate(_c)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ArchConfig",
    "FaultConfig",
    "FederatedConfig",
    "ShapeConfig",
    "ARCHS",
    "SHAPES",
    "get_arch",
    "get_shape",
    "validate",
]
