"""Shared model layers, port of the part of ``repro.models.layers`` the DiT uses."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
