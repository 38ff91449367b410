"""Config registry for the archs the port runs: the paper's two DiTs and the
decoder-only LM family (dense and MoE).  ``ARCH_IDS`` keeps the reference's
order.  The ssm, hybrid, encdec and vlm archs are not ported yet (ROADMAP
A.10.2) and raise ``NotImplementedError``."""

from __future__ import annotations

from repro_torch.configs import (flux_mmdit, gemma3_12b, gemma3_1b, granite_8b,
                                 granite_moe_3b_a800m, hunyuan_video, llama3_405b,
                                 mixtral_8x22b)
from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

_MODULES = {
    "gemma3-1b": gemma3_1b, "granite-8b": granite_8b, "llama3-405b": llama3_405b,
    "gemma3-12b": gemma3_12b, "mixtral-8x22b": mixtral_8x22b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "flux-mmdit": flux_mmdit, "hunyuan-video-dit": hunyuan_video,
}
ARCH_IDS = list(_MODULES)
_UNPORTED = ("mamba2-370m", "whisper-large-v3", "llama-3.2-vision-11b", "recurrentgemma-2b")


def _module(arch: str):
    key = arch if arch in _MODULES else arch.replace("_", "-")
    if key in _MODULES:
        return _MODULES[key]
    if key in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ssm, hybrid, encdec and vlm families: "
            f"ROADMAP A.10.2); the port runs {ARCH_IDS}")
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ArchConfig:
    return _module(arch).SMOKE
