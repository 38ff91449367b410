"""GEMM-O — output projection with head sparsity (paper §3.5, Obs. 3, Eq. 3-4).

Port of ``repro.kernels.gemm_o.gemm_o_sparse_kernel``.  The CUDA kernel is
``csrc/gemm_o.cu`` (its header says what bounds it on the H100 and how the
design answers that); the plain version is :func:`repro_torch.kernels.ref.
gemm_o_ref`.  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_o_ref

__all__ = ["gemm_o_sparse_kernel"]


def gemm_o_sparse_kernel(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         row_ids: torch.Tensor, head_ids: torch.Tensor,
                         head_cnt: torch.Tensor, *, block_rows: int) -> torch.Tensor:
    """``out[b,row] = bias[b,row] + Σ_{live h} O[b,h,row] @ w[h]`` on live rows.

    o_heads (B, H, N, dh), w (H, dh, F), bias (B, N, F); row_ids and
    head_cnt (B, Cr), head_ids (B, Cr, H) int32.  Slots with
    ``head_cnt == 0`` never store; rows no slot visits keep ``bias``.  The
    bias is cloned once into the output, which the kernel then updates in
    place.  ``gemm_o_sparse_kernel.launches`` counts the CUDA launches.
    """
    if o_heads.device.type == "cpu":
        return gemm_o_ref(o_heads, w, bias, row_ids, head_ids, head_cnt,
                          block=block_rows)
    lib = _build.load()
    b, h, n, dh = o_heads.shape
    f = w.shape[-1]
    cr = row_ids.shape[-1]
    if n % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide N {n}")
    dev, dt = o_heads.device, o_heads.dtype
    _build.check("o_heads", o_heads, dev, dt, (b, h, n, dh))
    _build.check("w", w, dev, dt, (h, dh, f))
    _build.check("bias", bias, dev, dt, (b, n, f))
    _build.check("row_ids", row_ids, dev, torch.int32, (b, cr))
    _build.check("head_ids", head_ids, dev, torch.int32, (b, cr, h))
    _build.check("head_cnt", head_cnt, dev, torch.int32, (b, cr))
    out = bias.clone()
    rc = lib.fo_gemm_o(_build.dtype_code(dt), o_heads.data_ptr(), w.data_ptr(),
                       row_ids.data_ptr(), head_ids.data_ptr(), head_cnt.data_ptr(),
                       out.data_ptr(), b, h, n, dh, f, cr, block_rows,
                       _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "gemm_o_sparse_kernel")
    gemm_o_sparse_kernel.launches += 1
    return out


gemm_o_sparse_kernel.launches = 0
