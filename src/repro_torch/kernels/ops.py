"""The unified kernel entry (kernel side of paper Fig. 4), port of
``repro.kernels.ops``.

These translate the engine's logical masks into the index lists (or the
packed symbols) the kernels take, with the reference's signatures and
defaults.  What differs:

  * no ``interpret`` flag, and ``on_tpu`` is not applicable (ROADMAP
    A.10.3): the route follows the tensors' device, as everywhere in the
    port (a CPU tensor runs each kernel's plain version, a CUDA tensor
    launches the kernel or raises);
  * no ``kernel_tiles``: the reference sizes its TPU GEMM tiles from a
    calibration table, while the Hopper kernels pick their own tiles; a
    Hopper tile table needs a sweep on the H100 (ROADMAP A.9);
  * no guard for an all-cached head, a GEMM-O with no live row or a Taylor
    reuse with nothing cached: the reference needs them because its grids
    visit the padding slots, while the Hopper kernels skip every slot past
    its count, so the output already holds ``o_reuse`` / ``bias`` / ``base``
    there.

:func:`csr_layout`, :func:`bucketed_layout` and :func:`gemm_o_layout` are
the index lists each entry builds, for a check that wants the kernel's
exact input.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import bucket_geometry, bucket_layout, gmo_layout
from repro_torch.core.symbols import active_indices, pack_bits
from repro_torch.kernels.flashomni_attention import (flashomni_attention_csr,
                                                     flashomni_attention_csr_bucketed,
                                                     flashomni_attention_symbols)
from repro_torch.kernels.gemm_o import gemm_o_sparse_bucketed_kernel, gemm_o_sparse_kernel
from repro_torch.kernels.gemm_q import gemm_q_sparse_kernel
from repro_torch.kernels.ref import csr_layout
from repro_torch.kernels.taylor_reuse import taylor_reuse_kernel

__all__ = [
    "flashomni_attention",
    "gemm_q",
    "gemm_o",
    "taylor_reuse",
    "scatter_rows",
    "csr_layout",
    "bucketed_layout",
    "gemm_o_layout",
]


def scatter_rows(compact: torch.Tensor, row_ids: torch.Tensor, row_cnt: torch.Tensor,
                 base: torch.Tensor, block: int) -> torch.Tensor:
    """Scatter a compact (Cr·block, F) result back into ``base`` (N, F)."""
    cr = row_ids.shape[0]
    t = base.shape[0] // block
    vals = compact.reshape(cr, block, -1)
    slot = torch.arange(cr, device=base.device)
    sid = torch.where(slot < row_cnt, row_ids.long(), t)
    padded = torch.cat([base.reshape(t, block, -1),
                        base.new_zeros((1, block, base.shape[-1]))], 0)
    padded[sid] = vals.to(base.dtype)
    return padded[:t].reshape(base.shape)


def bucketed_layout(m_c: torch.Tensor, m_s: torch.Tensor, *, cap_q: Optional[int] = None,
                    cap_kv: Optional[int] = None, kv_buckets: int, heads: int):
    """The occupancy-bucketed layout :func:`flashomni_attention` runs at
    ``kv_buckets > 1``: ``(bkt, geometry)``, ``bkt`` the ``bkt_*`` fields
    (B, R) / (B, S) with B = BH // heads.  Rows rank by their live mass."""
    t_q, t_kv = m_c.shape[-1], m_s.shape[-1]
    cap_q = t_q if cap_q is None else cap_q
    cap_kv = t_kv if cap_kv is None else cap_kv
    q_ids, q_cnt, kv_ids, kv_cnt, rows = csr_layout(m_c, m_s, cap_q, cap_kv)
    bh = m_c.shape[0]
    if bh % heads:
        raise ValueError(f"{bh} (batch, head) rows do not split into {heads} heads")
    b = bh // heads
    geometry = bucket_geometry(cap_q, cap_kv, heads, kv_buckets)
    shp = lambda a: a.reshape(b, heads, *a.shape[1:])
    score = rows.sum(dim=-1).to(torch.float32)                     # live-mass proxy
    bkt, _ = bucket_layout(shp(q_ids), shp(q_cnt), shp(q_ids), shp(kv_ids), shp(kv_cnt),
                           shp(score), geometry, t_q)
    return bkt, geometry


def flashomni_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        m_c: torch.Tensor, m_s: torch.Tensor, o_reuse: torch.Tensor, *,
                        block_q: int, block_kv: int, variant: str = "csr",
                        cap_q: Optional[int] = None, cap_kv: Optional[int] = None,
                        kv_buckets: int = 1, heads: int = 1) -> torch.Tensor:
    """Unified sparse attention entry.

    q, o_reuse (BH, N, d); k, v (BH, N_kv, d); m_c (BH, T_q) and m_s
    (BH, T_q, T_kv) bool block masks, True = compute.  ``variant="symbols"``
    packs the masks and runs Algorithm 1 on the symbols (``cap_*`` and
    ``kv_buckets`` do not apply); ``"csr"`` runs the CSR kernel on the
    masks' lists truncated at ``cap_q``/``cap_kv``, or with ``kv_buckets >
    1`` the occupancy-bucketed kernel, the leading axis read as
    ``B·heads``.  NB: buckets may TRUNCATE a row's KV list to its slot width
    — compare against a reference fed the same layout
    (:func:`bucketed_layout`).
    """
    if variant == "symbols":
        s_c = pack_bits(m_c)
        s_s = pack_bits(m_s.reshape(m_s.shape[0], -1))
        return flashomni_attention_symbols(q, k, v, o_reuse, s_c, s_s,
                                           block_q=block_q, block_kv=block_kv)
    if variant != "csr":
        raise ValueError(f"unknown attention variant {variant!r}; 'csr' or 'symbols'")
    if kv_buckets > 1:
        bkt, geometry = bucketed_layout(m_c, m_s, cap_q=cap_q, cap_kv=cap_kv,
                                        kv_buckets=kv_buckets, heads=heads)
        return flashomni_attention_csr_bucketed(
            q, k, v, o_reuse, bkt["bkt_head"], bkt["bkt_q_ids"], bkt["bkt_q_src"],
            bkt["bkt_kv_ids"], bkt["bkt_kv_cnt"], geometry, heads=heads,
            block_q=block_q, block_kv=block_kv)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s, cap_q, cap_kv)
    return flashomni_attention_csr(q, k, v, o_reuse, q_ids, q_ids, q_cnt, kv_ids, kv_cnt,
                                   block_q=block_q, block_kv=block_kv)


def gemm_q(x: torch.Tensor, w: torch.Tensor, row_mask: torch.Tensor, *, block_rows: int,
           cap: Optional[int] = None, compact: bool = True):
    """GEMM-Q of the live row blocks of x (N, K) @ w (K, F); row_mask (T,)
    bool, T = N // block_rows.  Returns ``(y, row_ids, row_cnt)``: ``y`` is
    the compact (cap·block_rows, F) projection, padding slots zero, or with
    ``compact=False`` scattered to (N, F) with zeros elsewhere."""
    row_ids, row_cnt = active_indices(row_mask, row_mask.shape[-1] if cap is None else cap)
    y = gemm_q_sparse_kernel(x[None], w, row_ids[None], row_cnt.reshape(1),
                             block_rows=block_rows)[0]
    if not compact:
        y = scatter_rows(y, row_ids, row_cnt, x.new_zeros((x.shape[0], w.shape[-1])),
                         block_rows)
    return y, row_ids, row_cnt


def gemm_o_layout(m_ch: torch.Tensor, *, cap_rows: Optional[int] = None,
                  cap_heads: Optional[int] = None, hc_buckets: int = 1) -> dict:
    """The lists :func:`gemm_o` runs on, from m_ch (T, H): ``row_ids``,
    ``row_cnt``, ``head_ids`` (Cr, H: the listed heads, padded past
    ``cap_heads``) and ``head_cnt`` (0 on padding slots); with
    ``hc_buckets > 1`` also ``gmo`` (the ``gmo_*`` fields, batch 1) and
    ``geometry``."""
    t, h = m_ch.shape
    cap_rows = t if cap_rows is None else cap_rows
    cap_heads = h if cap_heads is None else cap_heads
    row_ids, row_cnt = active_indices(m_ch.any(dim=-1), cap_rows)
    rows = m_ch[row_ids.long()]                                    # (Cr, H)
    head_ids, head_cnt = active_indices(rows, cap_heads)
    # The kernels take H-wide head lists: pad past cap_heads (never read).
    head_ids = torch.cat([head_ids, head_ids[:, -1:].expand(-1, h - cap_heads)], -1)
    # Padding slots duplicate the last live row; empty their head lists.
    head_cnt = torch.where(torch.arange(cap_rows, device=m_ch.device) < row_cnt, head_cnt, 0)
    lay = dict(row_ids=row_ids, row_cnt=row_cnt, head_ids=head_ids, head_cnt=head_cnt)
    if hc_buckets > 1:
        geometry = bucket_geometry(cap_rows, cap_heads, 1, hc_buckets)
        score = rows.sum(dim=-1).to(torch.float32)                 # live-head mass proxy
        gmo, _, _ = gmo_layout(row_ids[None], row_cnt.reshape(1), head_ids[None],
                               head_cnt[None], score[None], geometry, t)
        lay.update(gmo=gmo, geometry=geometry)
    return lay


def gemm_o(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, m_ch: torch.Tensor, *,
           block_rows: int, cap_rows: Optional[int] = None, cap_heads: Optional[int] = None,
           hc_buckets: int = 1) -> torch.Tensor:
    """GEMM-O ``out = bias + Σ_{live h} O_h @ w_h`` on the live rows.

    o_heads (H, N, dh), w (H, dh, F), bias (N, F) (the forecast OP_reuse),
    m_ch (T, H) per-(row block, head) live mask.  ``hc_buckets > 1`` runs
    the bucketed kernel over live-head counts.  NB: buckets may TRUNCATE a
    row's head list to its slot width — compare against a reference fed the
    same layout (:func:`gemm_o_layout`)."""
    lay = gemm_o_layout(m_ch, cap_rows=cap_rows, cap_heads=cap_heads, hc_buckets=hc_buckets)
    if hc_buckets > 1:
        g = lay["gmo"]
        out = gemm_o_sparse_bucketed_kernel(
            o_heads[None], w, bias[None], g["gmo_rows"], g["gmo_src"], g["gmo_head_ids"],
            g["gmo_head_cnt"], lay["geometry"], block_rows=block_rows)
    else:
        out = gemm_o_sparse_kernel(o_heads[None], w, bias[None], lay["row_ids"][None],
                                   lay["head_ids"][None], lay["head_cnt"][None],
                                   block_rows=block_rows)
    return out[0]


def taylor_reuse(derivs: torch.Tensor, coef: torch.Tensor, base: torch.Tensor,
                 cached_mask: torch.Tensor, *, block: int,
                 cap: Optional[int] = None) -> torch.Tensor:
    """OP_reuse over the cached blocks: derivs (D+1, BH, N, d), coef (D+1,),
    base (BH, N, d), cached_mask (BH, T) True = cached.  The first ``cap``
    cached blocks of each row take ``Σ_d coef[d]·derivs[d]``; every other
    block keeps ``base``."""
    t = cached_mask.shape[-1]
    ids, cnt = active_indices(cached_mask, t if cap is None else cap)
    return taylor_reuse_kernel(derivs, coef.to(device=base.device, dtype=torch.float32),
                               base, ids, cnt, block=block)
