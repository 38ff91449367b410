"""Logical mask generation (paper §3.3, Observation 1, Eq. 1), port of
``repro.core.masks``.

Masks are boolean with True = compute.  The caching mask never selects
text blocks (Observation 1); the skip mask optionally protects the
text↔vision regions.  Both come from float thresholds on an f32 softmax
map, so a last-bit difference against the reference can flip a block:
the tests report the mismatch count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "MaskConfig",
    "pool_tokens",
    "compressed_attention_map",
    "caching_scores",
    "select_by_cummass",
    "make_caching_mask",
    "make_skip_mask",
    "apply_degradation",
    "expand_block_mask",
]


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """FlashOmni sparsity configuration ``(τ_q, τ_kv, 𝒩, 𝒟, S_q)`` (paper A.1.1).

    ``pool`` is ``n·b``, the token-gathering granularity of the compressed
    attention map; ``block_q``/``block_kv`` are the attention tile sizes.
    """

    tau_q: float = 0.5
    tau_kv: float = 0.15
    interval: int = 5
    order: int = 1
    degrade: float = 0.3
    block_q: int = 64
    block_kv: int = 64
    pool: int = 128
    protect_text: bool = True
    warmup_steps: int = 4

    def n_blocks(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool)


def pool_tokens(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Mean-pool groups of ``pool`` consecutive tokens: (..., N, d) -> (..., ⌈N/pool⌉, d)."""
    n = x.shape[-2]
    pad = -(-n // pool) * pool - n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    out = x.reshape(*x.shape[:-2], -1, pool, x.shape[-1]).mean(dim=-2)
    if pad:
        scale = torch.ones(out.shape[-2], dtype=x.dtype, device=x.device)
        scale[-1] = pool / (pool - pad)
        out = out * scale[:, None]
    return out


def compressed_attention_map(q: torch.Tensor, k: torch.Tensor, pool: int, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """P̃ = softmax(q̃ k̃ᵀ / √d) over pooled tokens.  q,k: (..., N, d)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    qc = pool_tokens(q.to(torch.float32), pool)
    kc = pool_tokens(k.to(torch.float32), pool)
    s = torch.einsum("...id,...jd->...ij", qc, kc) * scale
    return torch.softmax(s, dim=-1)


def caching_scores(p_map: torch.Tensor, n_text: int):
    """Vision-to-Text contribution C and Text-to-Vision guidance G, each (..., T_vision)."""
    contrib = p_map[..., :n_text, n_text:].sum(dim=-2)
    beta = torch.softmax(p_map[..., n_text:, :n_text].transpose(-1, -2), dim=-1)
    guidance = beta.sum(dim=-2)
    return contrib, guidance


def select_by_cummass(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Eq. 1 selector: True where the block is SPARSIFIED (ascending
    cumulative mass stays ≤ τ·total), in the original block order."""
    order = torch.argsort(scores, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(scores, -1, order), dim=-1)
    total = scores.sum(dim=-1, keepdim=True)
    picked_sorted = cum <= tau * total
    return torch.empty_like(picked_sorted).scatter_(-1, order, picked_sorted)


def make_caching_mask(q: torch.Tensor, k: torch.Tensor, cfg: MaskConfig,
                      n_text_tokens: int, *,
                      tau_q: Optional[float] = None) -> torch.Tensor:
    """Per-head caching mask M_c (..., T) at compressed granularity (True = compute)."""
    tau = cfg.tau_q if tau_q is None else tau_q
    p_map = compressed_attention_map(q, k, cfg.pool)
    n_t = -(-n_text_tokens // cfg.pool) if n_text_tokens else 0
    t_total = p_map.shape[-1]
    if n_t == 0:
        return ~select_by_cummass(p_map.sum(dim=-2), tau)
    contrib, guidance = caching_scores(p_map, n_t)
    cached_v = select_by_cummass(contrib, tau) & select_by_cummass(guidance, tau)
    text_keep = torch.ones((*cached_v.shape[:-1], n_t), dtype=torch.bool,
                           device=q.device)
    return torch.cat([text_keep, ~cached_v], dim=-1)[..., :t_total]


def make_skip_mask(q: torch.Tensor, k: torch.Tensor, cfg: MaskConfig,
                   n_text_tokens: int, *, tau_kv: Optional[float] = None,
                   static_window: Optional[int] = None) -> torch.Tensor:
    """Per-head skip mask M_s (..., T, T) at compressed granularity (True = compute)."""
    tau = cfg.tau_kv if tau_kv is None else tau_kv
    p_map = compressed_attention_map(q, k, cfg.pool)
    compute = ~select_by_cummass(p_map, tau)
    t = p_map.shape[-1]
    idx = torch.arange(t, device=q.device)
    if static_window is not None:
        compute = compute & ((idx[:, None] - idx[None, :]).abs() < static_window)
    # Text protection last, so a static window can never narrow it.
    if cfg.protect_text and n_text_tokens:
        is_text = idx < -(-n_text_tokens // cfg.pool)
        compute = compute | is_text[:, None] | is_text[None, :]
    return compute


def apply_degradation(m_c: torch.Tensor, degrade: float) -> torch.Tensor:
    """Paper A.1.1 ``S_q``: below ``degrade`` live fraction the layer
    degenerates to full feature caching (all-cached)."""
    frac = m_c.to(torch.float32).mean(dim=-1, keepdim=True)
    return torch.where(frac < degrade, torch.zeros_like(m_c), m_c)


def expand_block_mask(mask: torch.Tensor, factor: int, n_total: int) -> torch.Tensor:
    """Compressed-granularity mask -> kernel-block granularity, truncated
    to ``n_total`` blocks."""
    return torch.repeat_interleave(mask, factor, dim=-1)[..., :n_total]
