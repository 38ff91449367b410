"""Plain PyTorch versions of the five Dispatch kernels.

Same semantics as ``repro.kernels.ref`` (gemm_q_ref, attention_ref,
gemm_o_ref), written in the index-list signatures the CUDA kernels take, so
each kernel wrapper can run its plain version on CPU tensors and
``chip_smoke.py`` can hold each kernel against it on the card.  No tiling:
gathers, dense products in float32 and masks.  The two bucketed versions
put the bucketed layout back into the uniform one and call the uniform
version, so on the same plan they give its result bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import bucket_row_offsets, bucket_row_widths

__all__ = ["gemm_q_ref", "attention_csr_ref", "gemm_o_ref",
           "attention_csr_bucketed_ref", "gemm_o_bucketed_ref"]

_NEG_INF = -1e30

# Elements of the (BH chunk, Cq·block_q, N_kv) score tensor the attention
# oracle materialises at once; bounds its memory at full model width.
_SCORE_ELEMS = 1 << 28


def gemm_q_ref(x: torch.Tensor, w: torch.Tensor, row_ids: torch.Tensor,
               row_cnt: torch.Tensor, *, block: int) -> torch.Tensor:
    """Compact GEMM-Q: ``out[b, c·bm:(c+1)·bm] = x[b, row_ids[b,c]·bm:+bm] @ w``
    for ``c < row_cnt[b]``, zeros for padding slots.

    x (B, N, K), w (K, F), row_ids (B, Cr), row_cnt (B,) -> (B, Cr·bm, F)."""
    b, n, k = x.shape
    cr = row_ids.shape[-1]
    xb = x.reshape(b, n // block, block, k)
    idx = row_ids.long()[..., None, None].expand(b, cr, block, k)
    xg = torch.gather(xb, 1, idx).to(torch.float32)            # (B, Cr, bm, K)
    y = xg @ w.to(torch.float32)
    live = torch.arange(cr, device=x.device) < row_cnt[:, None]
    y = torch.where(live[..., None, None], y, 0.0)
    return y.reshape(b, cr * block, -1).to(x.dtype)


def attention_csr_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o_reuse: torch.Tensor, q_ids: torch.Tensor,
                      q_src: torch.Tensor, q_cnt: torch.Tensor,
                      kv_ids: torch.Tensor, kv_cnt: torch.Tensor, *,
                      block_q: int, block_kv: int,
                      scale: Optional[float] = None) -> torch.Tensor:
    """CSR sparse attention (Algorithm 1 semantics over per-row lists).

    q (BH, N_q, d) read at block ``q_src[bh, c]``; k/v (BH, N_kv, d);
    o_reuse (BH, N, d); q_ids/q_src (BH, Cq); q_cnt (BH,); kv_ids
    (BH, Cq, Ckv); kv_cnt (BH, Cq).  For slots ``c < q_cnt[bh]`` the rows of
    block ``q_ids[bh, c]`` attend to the KV blocks ``kv_ids[bh, c, :kv_cnt]``
    (zeros when the list is empty); every other row keeps ``o_reuse``."""
    bh, n_kv, d = k.shape
    cq, ckv = kv_ids.shape[-2:]
    t_kv = n_kv // block_kv
    scale = (d ** -0.5) if scale is None else scale
    # Block mask of each slot's KV list -> token mask over N_kv.
    j_live = torch.arange(ckv, device=k.device) < kv_cnt[..., None]
    sid = torch.where(j_live, kv_ids.long(), t_kv)
    blk = torch.zeros((bh, cq, t_kv + 1), dtype=torch.bool, device=k.device)
    blk.scatter_(-1, sid, True)
    tok = torch.repeat_interleave(blk[..., :t_kv], block_kv, dim=-1)  # (BH, Cq, N_kv)

    qb = q.reshape(bh, -1, block_q, d)
    qg = torch.gather(qb, 1, q_src.long()[..., None, None].expand(bh, cq, block_q, d))
    qg = qg.reshape(bh, cq * block_q, d).to(torch.float32)
    out_rows = torch.empty((bh, cq * block_q, d), dtype=torch.float32, device=k.device)
    chunk = max(1, _SCORE_ELEMS // max(1, cq * block_q * n_kv))
    for s0 in range(0, bh, chunk):
        sl = slice(s0, s0 + chunk)
        s = (qg[sl] @ k[sl].to(torch.float32).transpose(-1, -2)) * scale
        mask = torch.repeat_interleave(tok[sl], block_q, dim=1)
        s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        l = p.sum(dim=-1, keepdim=True)
        out_rows[sl] = (p @ v[sl].to(torch.float32)) / torch.where(l == 0, 1.0, l)

    out = o_reuse.clone()
    live = torch.arange(cq, device=k.device) < q_cnt[:, None]        # (BH, Cq)
    b_idx, c_idx = live.nonzero(as_tuple=True)
    rows = (q_ids[b_idx, c_idx].long()[:, None] * block_q
            + torch.arange(block_q, device=k.device))                # (L, bq)
    src = out_rows.reshape(bh, cq, block_q, d)[b_idx, c_idx]          # (L, bq, d)
    out[b_idx[:, None], rows] = src.to(out.dtype)
    return out


def gemm_o_ref(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               row_ids: torch.Tensor, head_ids: torch.Tensor,
               head_cnt: torch.Tensor, *, block: int) -> torch.Tensor:
    """GEMM-O with head sparsity (Eq. 3): ``out[b, row] = bias[b, row] +
    Σ_{h ∈ head_ids[b,c,:head_cnt[b,c]]} O[b,h,row] @ w[h]`` over the rows of
    slots with ``head_cnt > 0``; every other row keeps ``bias``.

    o_heads (B, H, N, dh), w (H, dh, F), bias (B, N, F), row_ids/head_cnt
    (B, Cr), head_ids (B, Cr, H) -> (B, N, F)."""
    b, h, n, dh = o_heads.shape
    cr = row_ids.shape[-1]
    hc = head_ids.shape[-1]
    h_live = torch.arange(hc, device=w.device) < head_cnt[..., None]
    hid = torch.where(h_live, head_ids.long(), h)
    hmask = torch.zeros((b, cr, h + 1), dtype=torch.bool, device=w.device)
    hmask.scatter_(-1, hid, True)
    hmask = hmask[..., :h]                                            # (B, Cr, H)

    ob = o_heads.reshape(b, h, n // block, block, dh)
    og = torch.gather(ob, 2, row_ids.long()[:, None, :, None, None].expand(
        b, h, cr, block, dh)).to(torch.float32)                       # (B, H, Cr, bm, dh)
    og = og * hmask.permute(0, 2, 1)[..., None, None]
    part = torch.einsum("bhcrd,hdf->bcrf", og, w.to(torch.float32))  # (B, Cr, bm, F)

    out = bias.clone()
    b_idx, c_idx = (head_cnt > 0).nonzero(as_tuple=True)
    rows = (row_ids[b_idx, c_idx].long()[:, None] * block
            + torch.arange(block, device=w.device))                   # (L, bm)
    new = bias[b_idx[:, None], rows].to(torch.float32) + part[b_idx, c_idx]
    out[b_idx[:, None], rows] = new.to(out.dtype)
    return out


def _row_lists(ids: torch.Tensor, geometry) -> torch.Tensor:
    """Flat bucketed lists (B, S) -> (B, R, widest) per layout row; the tail
    past a row's own width repeats its last slot (never read past the count)."""
    off = torch.from_numpy(bucket_row_offsets(geometry)).to(ids.device).long()
    width = torch.from_numpy(bucket_row_widths(geometry)).to(ids.device).long()
    j = torch.arange(geometry[0][1], device=ids.device)
    return ids[:, off[:, None] + torch.minimum(j, width[:, None] - 1)]


def attention_csr_bucketed_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               o_reuse: torch.Tensor, bkt_head: torch.Tensor,
                               bkt_q_ids: torch.Tensor, bkt_q_src: torch.Tensor,
                               bkt_kv_ids: torch.Tensor, bkt_kv_cnt: torch.Tensor,
                               geometry, *, heads: int, block_q: int, block_kv: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """CSR attention over the bucketed layout (B4's semantics).

    q (B·H, N_q, d), k/v (B·H, N_kv, d), o_reuse (B·H, N, d); bkt_head,
    bkt_q_ids (dead rows: N // block_q), bkt_q_src, bkt_kv_cnt (B, R);
    bkt_kv_ids (B, S) laid out by ``geometry``.  Layout row r of batch b
    attends ``q[b·H + bkt_head[b,r]]`` at block ``bkt_q_src[b,r]`` to its
    ``bkt_kv_cnt`` listed KV blocks and writes block ``bkt_q_ids[b,r]``;
    every other row keeps ``o_reuse``."""
    b = bkt_head.shape[0]
    r = bkt_head.shape[-1]
    t_q = o_reuse.shape[1] // block_q
    # Uniform slot order: per (b, h), live rows by ascending q block, then
    # the dead rows (each head owns exactly R / H layout rows).
    bh = torch.arange(b, device=k.device)[:, None] * heads + bkt_head.long()
    order = torch.argsort((bh * (t_q + 1) + bkt_q_ids.long()).reshape(-1),
                          stable=True).reshape(b * heads, r // heads)
    take = lambda a: a.reshape(b * r, *a.shape[2:])[order]
    return attention_csr_ref(
        q, k, v, o_reuse, take(bkt_q_ids), take(bkt_q_src),
        take(bkt_q_ids < t_q).sum(dim=-1), take(_row_lists(bkt_kv_ids, geometry)),
        take(bkt_kv_cnt), block_q=block_q, block_kv=block_kv, scale=scale)


def gemm_o_bucketed_ref(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        gmo_rows: torch.Tensor, gmo_src: torch.Tensor,
                        gmo_head_ids: torch.Tensor, gmo_head_cnt: torch.Tensor,
                        geometry, *, block: int) -> torch.Tensor:
    """GEMM-O over the bucketed row layout (B5's semantics).

    gmo_rows (dead slots: N // block), gmo_src, gmo_head_cnt (B, Cr);
    gmo_head_ids (B, S_o) laid out by ``geometry``.  A live slot reads and
    writes row block ``gmo_src == gmo_rows``; slots with no head never store."""
    order = torch.argsort(gmo_rows.long(), dim=-1, stable=True)   # dead slots last
    take = lambda a: torch.gather(a, 1, order)
    heads = _row_lists(gmo_head_ids, geometry)
    heads = torch.gather(heads, 1, order[..., None].expand_as(heads))
    return gemm_o_ref(o_heads, w, bias, take(gmo_src), heads, take(gmo_head_cnt),
                      block=block)
