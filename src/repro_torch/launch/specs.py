"""Input shape stand-ins and their logical specs for every (arch × shape)
cell, port of ``repro.launch.specs``.

The shape halves (:func:`train_batch`, :func:`prefill_batch`,
:func:`dit_inputs`) are ``meta`` tensors, the counterpart of the reference's
``ShapeDtypeStruct``: shapes and dtypes, nothing allocated.  The dtypes are
the reference's: bf16 frames, patches and latents, int32 tokens, f32 ``t``.
The logical halves name each dim's logical axis, as the models'
``param_specs`` do; :mod:`repro_torch.launch.steps` lays the batches out by
them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["train_batch", "train_batch_logical", "prefill_batch",
           "prefill_batch_logical", "dit_inputs", "dit_inputs_logical"]


def _f(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "dit":
        nv = s - cfg.n_text_tokens
        return {"latents": _f((b, nv, cfg.patch_dim), torch.bfloat16),
                "noise": _f((b, nv, cfg.patch_dim), torch.bfloat16),
                "patch_emb": _f((b, nv, cfg.d_model), torch.bfloat16),
                "text_emb": _f((b, cfg.n_text_tokens, cfg.d_model), torch.bfloat16),
                "t": _f((b,), torch.float32)}
    batch = {"tokens": _f((b, s), torch.int32), "labels": _f((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _f((b, cfg.encoder_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = _f((b, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
    return batch


def train_batch_logical(cfg: ArchConfig) -> dict:
    if cfg.family == "dit":
        return {"latents": ("dp", None, None), "noise": ("dp", None, None),
                "patch_emb": ("dp", None, None), "text_emb": ("dp", None, None),
                "t": ("dp",)}
    base = {"tokens": ("dp", None), "labels": ("dp", None)}
    if cfg.family == "encdec":
        base["frames"] = ("dp", None, None)
    if cfg.family == "vlm":
        base["patches"] = ("dp", None, None)
    return base


def prefill_batch(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _f((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _f((b, cfg.encoder_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = _f((b, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_logical(cfg: ArchConfig) -> dict:
    base = {"tokens": ("dp", None)}
    if cfg.family == "encdec":
        base["frames"] = ("dp", None, None)
    if cfg.family == "vlm":
        base["patches"] = ("dp", None, None)
    return base


def dit_inputs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b = shape.global_batch
    nv = shape.seq_len - cfg.n_text_tokens
    return {"x_vision": _f((b, nv, cfg.d_model), torch.bfloat16),
            "text_emb": _f((b, cfg.n_text_tokens, cfg.d_model), torch.bfloat16),
            "t": _f((b,), torch.float32)}


def dit_inputs_logical(cfg: ArchConfig) -> dict:
    return {"x_vision": ("dp", "sp", None), "text_emb": ("dp", None, None), "t": ("dp",)}
