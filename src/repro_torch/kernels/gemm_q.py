"""GEMM-Q — compact row-gathered query projection (paper §3.5, Obs. 2).

Port of ``repro.kernels.gemm_q.gemm_q_sparse_kernel``.  The CUDA kernel is
``csrc/gemm_q.cu`` (its header says what bounds it on the H100 and how the
design answers that); the plain version is :func:`repro_torch.kernels.ref.
gemm_q_ref`.  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises; a ``meta`` tensor (the dry run's) passes the CUDA route's
checks and returns an empty ``meta`` output, launching and counting nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._region import kernel_region
from repro_torch.kernels.ref import gemm_q_ref

__all__ = ["gemm_q_sparse_kernel"]


@kernel_region
def gemm_q_sparse_kernel(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
                         row_cnt: torch.Tensor, *, block_rows: int) -> torch.Tensor:
    """Compact ``(B, Cr·bm, F)`` projection of the live row blocks.

    x (B, N, K), w (K, F), row_ids (B, Cr) and row_cnt (B,) int32;
    ``block_rows`` (bm) divides N.  Slot ``c < row_cnt[b]`` holds
    ``x[b, row_ids[b,c]·bm:+bm] @ w``; padding slots hold zeros.
    ``gemm_q_sparse_kernel.launches`` counts the CUDA launches.
    """
    if x.device.type == "cpu":
        return gemm_q_ref(x, w, row_ids, row_cnt, block=block_rows)
    lib = None if x.is_meta else _build.load()
    b, n, k = x.shape
    f = w.shape[-1]
    cr = row_ids.shape[-1]
    if n % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide N {n}")
    dev = x.device
    _build.check("x", x, dev, x.dtype, (b, n, k))
    _build.check("w", w, dev, x.dtype, (k, f))
    _build.check("row_ids", row_ids, dev, torch.int32, (b, cr))
    _build.check("row_cnt", row_cnt, dev, torch.int32, (b,))
    out = torch.empty((b, cr * block_rows, f), dtype=x.dtype, device=dev)
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    vec = _build.aligned_rows((x, k), (w, f), (out, f))
    rc = lib.fo_gemm_q(_build.dtype_code(x.dtype), int(vec), x.data_ptr(), w.data_ptr(),
                       row_ids.data_ptr(), row_cnt.data_ptr(), out.data_ptr(),
                       b, n, k, f, cr, block_rows, _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "gemm_q_sparse_kernel")
    gemm_q_sparse_kernel.launches += 1
    return out


gemm_q_sparse_kernel.launches = 0
