"""Update-side GEMM-O helpers, port of the parts of ``repro.core.sparse_gemm``
the serving path runs.  The Dispatch-side sparse GEMMs are the kernels in
:mod:`repro_torch.kernels`."""

from __future__ import annotations

import torch

__all__ = ["gemm_o_update_bias", "rows_any_head_live"]


def rows_any_head_live(m_ch: torch.Tensor) -> torch.Tensor:
    """(..., T, H) per-(block, head) compute mask -> (..., T) block-live mask."""
    return m_ch.any(dim=-1)


def gemm_o_update_bias(o_heads: torch.Tensor, w: torch.Tensor,
                       m_ch: torch.Tensor, *, block: int) -> torch.Tensor:
    """Update-step stage 1: cache bias ``B_c = Σ_{h∉H_i} O_i^h W_h``.

    o_heads (..., N, H, dh); w (H, dh, d_out); m_ch (..., T, H).  Returns
    (..., N, d_out), zero on rows whose every head is live.  The cached
    heads are zeroed before one contraction, instead of forming the
    reference's (..., N, H, d_out) per-head products (2.7 GB at
    flux-mmdit width); the sum runs in another order, so results agree to
    f32 rounding.
    """
    n = o_heads.shape[-3]
    cached = torch.repeat_interleave(~m_ch, block, dim=-2)[..., :n, :]
    return torch.einsum("...nhd,hdf->...nf",
                        o_heads * cached[..., None].to(o_heads.dtype), w)
