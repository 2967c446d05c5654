"""Config registry: each architecture registers a FULL config (the
published widths) and a SMOKE config (same family, reduced widths, runs
on the CPU).

The port's copy of ``repro/configs/base.py`` without the reference's
input shapes (dry-run analysis) and skip notes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.transformer import ModelConfig

__all__ = ["ArchEntry", "ARCH_REGISTRY", "register", "get_arch",
           "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    full: ModelConfig
    smoke: ModelConfig
    source: str


ARCH_REGISTRY: Dict[str, ArchEntry] = {}


def register(name: str, full: ModelConfig, smoke: ModelConfig,
             source: str = "") -> None:
    ARCH_REGISTRY[name] = ArchEntry(full=full, smoke=smoke, source=source)


def get_arch(name: str) -> ArchEntry:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def list_archs():
    return sorted(ARCH_REGISTRY)
