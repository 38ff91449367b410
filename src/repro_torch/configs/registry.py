"""Config registry: ``--arch <id>`` resolution for the port's launchers and
tests.  ``ARCH_IDS`` holds the reference's twelve archs in its order: the
decoder-only LMs, the ssm, encdec, vlm and hybrid archs, and the paper's
two DiTs.  :func:`arch_shapes` gives the shape-grid cells an arch runs
(``configs.base.SHAPES`` less its skips, or the DiT serving cell), which
the dry run (``launch/dryrun``, ``perf_probe``, ``roofline_sweep``)
walks."""

from __future__ import annotations

from repro_torch.configs import (flux_mmdit, gemma3_12b, gemma3_1b, granite_8b,
                                 granite_moe_3b_a800m, hunyuan_video, llama3_405b,
                                 llama_3_2_vision_11b, mamba2_370m, mixtral_8x22b,
                                 recurrentgemma_2b, whisper_large_v3)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCH_IDS", "get_config", "get_smoke", "arch_shapes"]

_MODULES = {
    "gemma3-1b": gemma3_1b, "granite-8b": granite_8b, "llama3-405b": llama3_405b,
    "gemma3-12b": gemma3_12b, "mixtral-8x22b": mixtral_8x22b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "mamba2-370m": mamba2_370m, "whisper-large-v3": whisper_large_v3,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "flux-mmdit": flux_mmdit, "hunyuan-video-dit": hunyuan_video,
}
ARCH_IDS = list(_MODULES)


def _module(arch: str):
    key = arch if arch in _MODULES else arch.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[key]


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ArchConfig:
    return _module(arch).SMOKE


def arch_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """The shape-grid cells this arch runs, the reference's: a DiT serves
    one request of batch 1 at its text tokens plus 4096 (flux) or 32 768
    vision tokens; any other family runs ``SHAPES`` less its
    ``skip_shapes``."""
    if cfg.family == "dit":
        return [ShapeSpec("dit_serve", cfg.n_text_tokens +
                          (4096 if "flux" in cfg.name else 32768), 1, "dit")]
    return [s for s in SHAPES.values() if s.name not in cfg.skip_shapes]
