"""GEMM-O — output projection with head sparsity (paper §3.5, Obs. 3, Eq. 3-4),
uniform and occupancy-bucketed row layouts.

Port of ``repro.kernels.gemm_o.gemm_o_sparse_kernel`` and
``gemm_o_sparse_bucketed_kernel``.  The CUDA kernels are in
``csrc/gemm_o.cu`` (its header says what bounds them on the H100 and how the
design answers that); the plain versions are :func:`repro_torch.kernels.ref.
gemm_o_ref` and :func:`~repro_torch.kernels.ref.gemm_o_bucketed_ref`.  A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or raises; a
``meta`` tensor (the dry run's) passes the CUDA route's checks and returns an
empty ``meta`` output, launching and counting nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._region import kernel_region
from repro_torch.kernels.ref import gemm_o_bucketed_ref, gemm_o_ref

__all__ = ["gemm_o_sparse_kernel", "gemm_o_sparse_bucketed_kernel"]


@kernel_region
def gemm_o_sparse_kernel(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         row_ids: torch.Tensor, head_ids: torch.Tensor,
                         head_cnt: torch.Tensor, *, block_rows: int,
                         h_lo: int = 0) -> torch.Tensor:
    """``out[b,row] = bias[b,row] + Σ_{live h} O[b,h,row] @ w[h]`` on live rows.

    o_heads (B, H, N, dh), w (H, dh, F), bias (B, N, F); row_ids and
    head_cnt (B, Cr), head_ids (B, Cr, Hp) int32.  Slots with
    ``head_cnt == 0`` never store; rows no slot visits keep ``bias``.  The
    bias is cloned once into the output, which the kernel then updates in
    place.  The head range: the lists name heads of the whole plan (``Hp``
    of them) and ``o_heads``/``w`` hold heads ``[h_lo, h_lo + H)`` (a rank's
    share of a ``model`` row), so a listed head outside the range adds
    nothing and head ``h`` is read at ``h - h_lo``; ``h_lo = 0`` with
    ``Hp = H`` is every head.  ``gemm_o_sparse_kernel.launches`` counts the
    CUDA launches.
    """
    if o_heads.device.type == "cpu":
        return gemm_o_ref(o_heads, w, bias, row_ids, head_ids, head_cnt,
                          block=block_rows, h_lo=h_lo)
    lib = None if o_heads.is_meta else _build.load()
    b, h, n, dh = o_heads.shape
    f = w.shape[-1]
    cr, hp = row_ids.shape[-1], head_ids.shape[-1]
    if n % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide N {n}")
    if not 0 <= h_lo <= hp - h:
        raise ValueError(f"head range [{h_lo}, {h_lo + h}) lies outside the plan's {hp} heads")
    dev, dt = o_heads.device, o_heads.dtype
    _build.check("o_heads", o_heads, dev, dt, (b, h, n, dh))
    _build.check("w", w, dev, dt, (h, dh, f))
    _build.check("bias", bias, dev, dt, (b, n, f))
    _build.check("row_ids", row_ids, dev, torch.int32, (b, cr))
    _build.check("head_ids", head_ids, dev, torch.int32, (b, cr, hp))
    _build.check("head_cnt", head_cnt, dev, torch.int32, (b, cr))
    out = bias.clone()
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    vec = _build.aligned_rows((o_heads, dh), (w, f), (out, f))
    rc = lib.fo_gemm_o(_build.dtype_code(dt), int(vec), o_heads.data_ptr(), w.data_ptr(),
                       row_ids.data_ptr(), head_ids.data_ptr(), head_cnt.data_ptr(),
                       out.data_ptr(), b, h, hp, h_lo, n, dh, f, cr, block_rows,
                       _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "gemm_o_sparse_kernel")
    gemm_o_sparse_kernel.launches += 1
    return out


@kernel_region
def gemm_o_sparse_bucketed_kernel(o_heads: torch.Tensor, w: torch.Tensor,
                                  bias: torch.Tensor, gmo_rows: torch.Tensor,
                                  gmo_src: torch.Tensor, gmo_head_ids: torch.Tensor,
                                  gmo_head_cnt: torch.Tensor, geometry, *,
                                  block_rows: int) -> torch.Tensor:
    """GEMM-O over the live-head-count buckets of a DispatchPlan.

    o_heads (B, H, N, dh), w (H, dh, F), bias (B, N, F); gmo_rows (dead
    slots: N // block_rows), gmo_src, gmo_head_cnt (B, Cr) and gmo_head_ids
    (B, S) int32, laid out by ``geometry`` (``plan.bucket_geometry(Cr, H, 1,
    kv_buckets)``).  Slots with ``gmo_head_cnt == 0`` never store; rows no
    slot writes keep ``bias``, cloned once into the output.
    ``gemm_o_sparse_bucketed_kernel.launches`` counts the CUDA launches.
    """
    if o_heads.device.type == "cpu":
        return gemm_o_bucketed_ref(o_heads, w, bias, gmo_rows, gmo_src, gmo_head_ids,
                                   gmo_head_cnt, geometry, block=block_rows)
    lib = None if o_heads.is_meta else _build.load()
    b, h, n, dh = o_heads.shape
    f = w.shape[-1]
    cr = gmo_rows.shape[-1]
    s = gmo_head_ids.shape[-1]
    if n % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide N {n}")
    _build.check_geometry(geometry, cr, s)
    dev, dt = o_heads.device, o_heads.dtype
    _build.check("o_heads", o_heads, dev, dt, (b, h, n, dh))
    _build.check("w", w, dev, dt, (h, dh, f))
    _build.check("bias", bias, dev, dt, (b, n, f))
    for name, t in (("gmo_rows", gmo_rows), ("gmo_src", gmo_src),
                    ("gmo_head_cnt", gmo_head_cnt)):
        _build.check(name, t, dev, torch.int32, (b, cr))
    _build.check("gmo_head_ids", gmo_head_ids, dev, torch.int32, (b, s))
    out = bias.clone()
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    vec = _build.aligned_rows((o_heads, dh), (w, f), (out, f))
    rc = lib.fo_gemm_o_bucketed(
        _build.dtype_code(dt), int(vec), o_heads.data_ptr(), w.data_ptr(), gmo_rows.data_ptr(),
        gmo_src.data_ptr(), gmo_head_ids.data_ptr(), gmo_head_cnt.data_ptr(),
        _build.row_offsets(geometry, dev).data_ptr(), out.data_ptr(), b, h, n, dh, f, cr,
        s, block_rows, _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "gemm_o_sparse_bucketed_kernel")
    gemm_o_sparse_bucketed_kernel.launches += 1
    return out


gemm_o_sparse_kernel.launches = 0
gemm_o_sparse_bucketed_kernel.launches = 0
