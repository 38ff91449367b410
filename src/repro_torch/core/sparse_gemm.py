"""FlashOmni sparse GEMMs, port of ``repro.core.sparse_gemm`` (paper §3.5).

GEMM-Q skips the query projection of row blocks cached in every head: the
structural path gathers the live row blocks, projects only those and
scatters them into a zero output (or, ``compact``, returns them in slot
order, the kernels' layout).  GEMM-O adds the live heads' partial products
to the Taylor-forecast bias ``B_c`` of the cached heads (Eq. 4).  These are
the structural twin's GEMMs (``backend.TorchBackend``); the Dispatch
kernels are in :mod:`repro_torch.kernels`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import _gather_blocks, scatter_blocks
from repro_torch.core.symbols import active_indices

__all__ = ["gemm_q_sparse", "gemm_q_from_plan", "gemm_o_update_bias", "gemm_o_sparse",
           "gemm_o_from_plan", "rows_any_head_live"]

_gather_rows = _gather_blocks     # (..., T, block, d) at ids (..., C) -> (..., C, block, d)


def gemm_q_from_plan(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                     cnt: torch.Tensor, *, block: int, bias: Optional[torch.Tensor] = None,
                     compact: bool = False) -> torch.Tensor:
    """Row-block-sparse ``x @ w`` over precomputed live-row ids/counts.

    ``compact``: the projection of the gathered blocks in slot order,
    (..., cap·block, d_out), padding slots included; otherwise scattered to
    (..., N, d_out) with zeros on the cached rows."""
    n, d_in = x.shape[-2], x.shape[-1]
    t = n // block
    xg = _gather_rows(x.reshape(*x.shape[:-2], t, block, d_in), ids)
    yg = torch.einsum("...cbd,df->...cbf", xg, w)
    if bias is not None:
        yg = yg + bias
    if compact:
        return yg.reshape(*x.shape[:-2], ids.shape[-1] * block, w.shape[-1])
    outb = torch.zeros((*x.shape[:-2], t, block, w.shape[-1]), dtype=yg.dtype,
                       device=x.device)
    return scatter_blocks(outb, ids, cnt, yg).reshape(*x.shape[:-1], w.shape[-1])


def gemm_q_sparse(x: torch.Tensor, w: torch.Tensor, m_rows: torch.Tensor, *, block: int,
                  cap: int, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask-level GEMM-Q: x (..., N, d_in), m_rows (..., N // block) True =
    live; cached row blocks give zeros.
    Kept for parity with the reference; nothing in the port calls it."""
    ids, cnt = active_indices(m_rows, cap)
    return gemm_q_from_plan(x, w, ids, cnt, block=block, bias=bias)


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


def gemm_o_from_plan(o_heads: torch.Tensor, w: torch.Tensor, head_mask: torch.Tensor,
                     ids: torch.Tensor, cnt: torch.Tensor, bias_forecast: torch.Tensor, *,
                     block: int) -> torch.Tensor:
    """Dispatch-step GEMM-O over a plan's live rows ``ids``/``cnt`` and their
    live-head mask ``head_mask`` (..., cap, H): o_heads (..., N, H, dh), w
    (H, dh, d_out), bias_forecast (..., N, d_out).  The plan's ``head_mask``
    carries any bucket clamp, so this path needs no bucket awareness."""
    n, h, dh = o_heads.shape[-3:]
    t = n // block
    ob = o_heads.reshape(*o_heads.shape[:-3], t, block, h * dh)
    og = _gather_rows(ob, ids).reshape(*ids.shape, block, h, dh)   # (..., cap, block, H, dh)
    og = torch.where(head_mask[..., None, :, None], og, 0)
    yg = torch.einsum("...cbhd,hdf->...cbf", og, w)
    outb = torch.zeros((*o_heads.shape[:-3], t, block, w.shape[-1]), dtype=yg.dtype,
                       device=o_heads.device)
    out = scatter_blocks(outb, ids, cnt, yg).reshape(*o_heads.shape[:-3], n, w.shape[-1])
    return out + bias_forecast


def gemm_o_sparse(o_heads: torch.Tensor, w: torch.Tensor, m_ch: torch.Tensor,
                  bias_forecast: torch.Tensor, *, block: int, cap: int) -> torch.Tensor:
    """Mask-level GEMM-O: m_ch (..., T, H) per-(block, head) compute mask;
    fully cached row blocks cost no GEMM work.
    Kept for parity with the reference; nothing in the port calls it."""
    ids, cnt = active_indices(rows_any_head_live(m_ch), cap)
    mh = torch.gather(m_ch, -2, ids.long()[..., None].expand(*ids.shape, m_ch.shape[-1]))
    return gemm_o_from_plan(o_heads, w, mh, ids, cnt, bias_forecast, block=block)
