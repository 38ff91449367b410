"""Config registry for the archs the port runs (``flux-mmdit`` only)."""

from __future__ import annotations

from repro_torch.configs import flux_mmdit
from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

ARCH_IDS = ["flux-mmdit"]


def _module(arch: str):
    if arch.replace("_", "-") != "flux-mmdit":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port runs {ARCH_IDS}")
    return flux_mmdit


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ArchConfig:
    return _module(arch).SMOKE
