"""Config registry for the archs the port runs (the paper's own two)."""

from __future__ import annotations

from repro_torch.configs import flux_mmdit, hunyuan_video
from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

_MODULES = {"flux-mmdit": flux_mmdit, "hunyuan-video-dit": hunyuan_video}
ARCH_IDS = list(_MODULES)


def _module(arch: str):
    try:
        return _MODULES[arch.replace("_", "-")]
    except KeyError:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port runs {ARCH_IDS}") from None


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ArchConfig:
    return _module(arch).SMOKE
