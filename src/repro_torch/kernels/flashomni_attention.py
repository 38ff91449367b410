"""FlashOmni sparse attention (paper §3.4, Algorithm 1): CSR lists in the
uniform and the occupancy-bucketed layouts, and the packed symbols.

Port of ``repro.kernels.flashomni_attention.flashomni_attention_csr``,
``flashomni_attention_csr_bucketed`` and ``flashomni_attention_symbols``.
The CUDA kernels are ``csrc/flashomni_attention.cu``,
``csrc/flashomni_attention_bucketed.cu`` and
``csrc/flashomni_attention_symbols.cu`` (their headers say what bounds them
on the H100 and how the design answers that); the plain versions are
:func:`repro_torch.kernels.ref.attention_csr_ref`,
:func:`~repro_torch.kernels.ref.attention_csr_bucketed_ref` and
:func:`~repro_torch.kernels.ref.attention_symbols_ref`.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises; a ``meta``
tensor (the dry run's) passes the CUDA route's checks and returns an empty
``meta`` output, launching and counting nothing.
:func:`count_walk` counts, on the card, what the grouped walk of the
kernels launched inside it staged and computed.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core.symbols import packed_len
from repro_torch.kernels import _build
from repro_torch.kernels._region import kernel_region
from repro_torch.kernels.ref import (attention_csr_bucketed_ref, attention_csr_ref,
                                     attention_symbols_ref)

__all__ = ["flashomni_attention_csr", "flashomni_attention_csr_bucketed",
           "flashomni_attention_symbols", "count_walk"]

_WALK: Optional[torch.Tensor] = None


@contextlib.contextmanager
def count_walk(device) -> Iterator[torch.Tensor]:
    """Count the grouped walk of the attention kernels launched on
    ``device`` inside the block: yields a (2,) int64 tensor on the card to
    which each launch adds the KV blocks its block walks staged ([0]) and
    the (16-row warp, KV block) updates its warps made ([1]).  For
    measurement: outside the block the kernels count nothing."""
    global _WALK
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the walk is counted on a CUDA device, not {device}")
    _WALK = torch.zeros(2, dtype=torch.int64, device=device)
    try:
        yield _WALK
    finally:
        _WALK = None


def _walk_ptr(device: torch.device) -> Optional[int]:
    return _WALK.data_ptr() if _WALK is not None and _WALK.device == device else None


def _check_attention_tensors(dev, dt, q, k, v, o_reuse, q_shape, kv_shape, o_shape) -> None:
    for name, t, shape in (("q", q, q_shape), ("k", k, kv_shape), ("v", v, kv_shape),
                           ("o_reuse", o_reuse, o_shape)):
        _build.check(name, t, dev, dt, shape)
        _build.check_aligned(name, t)


@kernel_region
def flashomni_attention_csr(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o_reuse: torch.Tensor, q_ids: torch.Tensor,
                            q_src: torch.Tensor, q_cnt: torch.Tensor,
                            kv_ids: torch.Tensor, kv_cnt: torch.Tensor, *,
                            block_q: int, block_kv: int,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over per-row CSR KV lists.

    q (BH, N_q, d) — full layout, or the compact GEMM-Q layout with
    ``q_src`` holding compact slots; k, v (BH, N_kv, d); o_reuse (BH, N, d);
    q_ids/q_src (BH, Cq), q_cnt (BH,), kv_ids (BH, Cq, Ckv), kv_cnt
    (BH, Cq) int32.  Slots ``c >= q_cnt`` are skipped, so their rows (and a
    whole all-cached ``bh``) keep ``o_reuse``, which is cloned once into the
    output.  ``flashomni_attention_csr.launches`` counts the CUDA launches.
    """
    if q.device.type == "cpu":
        return attention_csr_ref(q, k, v, o_reuse, q_ids, q_src, q_cnt, kv_ids,
                                 kv_cnt, block_q=block_q, block_kv=block_kv,
                                 scale=scale)
    lib = None if q.is_meta else _build.load()
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    n = o_reuse.shape[1]
    cq, ckv = kv_ids.shape[-2:]
    _check_sizes(n_q, n_kv, n, d, block_q, block_kv)
    dev, dt = q.device, q.dtype
    _check_attention_tensors(dev, dt, q, k, v, o_reuse, (bh, n_q, d), (bh, n_kv, d),
                             (bh, n, d))
    _build.check("q_ids", q_ids, dev, torch.int32, (bh, cq))
    _build.check("q_src", q_src, dev, torch.int32, (bh, cq))
    _build.check("q_cnt", q_cnt, dev, torch.int32, (bh,))
    _build.check("kv_ids", kv_ids, dev, torch.int32, (bh, cq, ckv))
    _build.check("kv_cnt", kv_cnt, dev, torch.int32, (bh, cq))
    scale = (d ** -0.5) if scale is None else scale
    out = o_reuse.clone()
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    rc = lib.fo_csr_attention(
        _build.dtype_code(dt), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_ids.data_ptr(), q_src.data_ptr(), q_cnt.data_ptr(), kv_ids.data_ptr(),
        kv_cnt.data_ptr(), bh, n_q, n_kv, n, d, cq, ckv, block_q, block_kv,
        float(scale), _walk_ptr(dev), _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "flashomni_attention_csr")
    flashomni_attention_csr.launches += 1
    return out


def _check_sizes(n_q: int, n_kv: int, n: int, d: int, block_q: int, block_kv: int) -> None:
    if n_q % block_q or n % block_q or n_kv % block_kv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) must divide N_q {n_q}, "
                         f"N {n} and N_kv {n_kv}")
    if d not in (32, 64, 128) or block_q not in (16, 32, 64, 128) \
            or block_kv not in (16, 32, 64, 128):
        raise ValueError(f"unsupported head_dim {d} / blocks ({block_q}, {block_kv}); "
                         "built: head_dim 32/64/128, blocks 16/32/64/128")


@kernel_region
def flashomni_attention_csr_bucketed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     o_reuse: torch.Tensor, bkt_head: torch.Tensor,
                                     bkt_q_ids: torch.Tensor, bkt_q_src: torch.Tensor,
                                     bkt_kv_ids: torch.Tensor, bkt_kv_cnt: torch.Tensor,
                                     geometry, *, heads: int, block_q: int, block_kv: int,
                                     scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over the occupancy-bucketed layout of a DispatchPlan.

    q (B·H, N_q, d) — full layout, or compact with ``bkt_q_src`` holding
    compact slots; k, v (B·H, N_kv, d); o_reuse (B·H, N, d); bkt_head,
    bkt_q_ids (dead rows: N // block_q), bkt_q_src, bkt_kv_cnt (B, R) and
    bkt_kv_ids (B, S) int32, laid out by ``geometry`` (``plan.
    bucket_geometry``).  Dead layout rows are skipped and every row no live
    layout row writes keeps ``o_reuse``, cloned once into the output.
    ``flashomni_attention_csr_bucketed.launches`` counts the CUDA launches.
    """
    if q.device.type == "cpu":
        return attention_csr_bucketed_ref(
            q, k, v, o_reuse, bkt_head, bkt_q_ids, bkt_q_src, bkt_kv_ids, bkt_kv_cnt,
            geometry, heads=heads, block_q=block_q, block_kv=block_kv, scale=scale)
    lib = None if q.is_meta else _build.load()
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    n = o_reuse.shape[1]
    b, r = bkt_head.shape
    s = bkt_kv_ids.shape[-1]
    _check_sizes(n_q, n_kv, n, d, block_q, block_kv)
    if bh != b * heads:
        raise ValueError(f"q has {bh} (batch, head) rows; the layout wants {b} x {heads}")
    _build.check_geometry(geometry, r, s)
    dev, dt = q.device, q.dtype
    _check_attention_tensors(dev, dt, q, k, v, o_reuse, (bh, n_q, d), (bh, n_kv, d),
                             (bh, n, d))
    for name, t in (("bkt_head", bkt_head), ("bkt_q_ids", bkt_q_ids),
                    ("bkt_q_src", bkt_q_src), ("bkt_kv_cnt", bkt_kv_cnt)):
        _build.check(name, t, dev, torch.int32, (b, r))
    _build.check("bkt_kv_ids", bkt_kv_ids, dev, torch.int32, (b, s))
    scale = (d ** -0.5) if scale is None else scale
    out = o_reuse.clone()
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    rc = lib.fo_csr_attention_bucketed(
        _build.dtype_code(dt), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bkt_head.data_ptr(), bkt_q_ids.data_ptr(), bkt_q_src.data_ptr(),
        bkt_kv_ids.data_ptr(), bkt_kv_cnt.data_ptr(),
        _build.row_offsets(geometry, dev).data_ptr(), b, heads, r, s, n_q, n_kv, n, d,
        block_q, block_kv, float(scale), _walk_ptr(dev), _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "flashomni_attention_csr_bucketed")
    flashomni_attention_csr_bucketed.launches += 1
    return out


@kernel_region
def flashomni_attention_symbols(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                o_reuse: torch.Tensor, s_c: torch.Tensor, s_s: torch.Tensor,
                                *, block_q: int, block_kv: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Algorithm 1 on the packed sparse symbols.

    q, o_reuse (BH, N, d); k, v (BH, N_kv, d); s_c (BH, ⌈T_q/8⌉) and s_s
    (BH, ⌈T_q·T_kv/8⌉) uint8, big-endian within a byte, ``s_s`` the
    row-major (T_q × T_kv) bit matrix.  A row block whose ``s_c`` bit is 0
    copies ``o_reuse``; a live one attends its live KV blocks (zeros when it
    has none).  The kernel writes every row, so nothing is cloned.
    ``flashomni_attention_symbols.launches`` counts the CUDA launches.
    """
    if q.device.type == "cpu":
        return attention_symbols_ref(q, k, v, o_reuse, s_c, s_s, block_q=block_q,
                                     block_kv=block_kv, scale=scale)
    lib = None if q.is_meta else _build.load()
    bh, n, d = q.shape
    n_kv = k.shape[1]
    _check_sizes(n, n_kv, n, d, block_q, block_kv)
    t_q, t_kv = n // block_q, n_kv // block_kv
    c_bytes, s_bytes = packed_len(t_q), packed_len(t_q * t_kv)
    dev, dt = q.device, q.dtype
    _check_attention_tensors(dev, dt, q, k, v, o_reuse, (bh, n, d), (bh, n_kv, d),
                             (bh, n, d))
    _build.check("s_c", s_c, dev, torch.uint8, (bh, c_bytes))
    _build.check("s_s", s_s, dev, torch.uint8, (bh, s_bytes))
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty_like(o_reuse)
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    rc = lib.fo_symbols_attention(
        _build.dtype_code(dt), q.data_ptr(), k.data_ptr(), v.data_ptr(), o_reuse.data_ptr(),
        out.data_ptr(), s_c.data_ptr(), s_s.data_ptr(), bh, n, n_kv, d, c_bytes, s_bytes,
        block_q, block_kv, float(scale), _walk_ptr(dev), _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "flashomni_attention_symbols")
    flashomni_attention_symbols.launches += 1
    return out


flashomni_attention_csr.launches = 0
flashomni_attention_csr_bucketed.launches = 0
flashomni_attention_symbols.launches = 0
