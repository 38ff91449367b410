"""Plain PyTorch versions of the seven kernels, and the reference's oracles.

Same semantics as ``repro.kernels.ref`` (gemm_q_ref, attention_ref,
gemm_o_ref, taylor_reuse_ref), written in the index-list signatures the CUDA
kernels take, so each kernel wrapper can run its plain version on CPU
tensors and ``chip_smoke.py`` can hold each kernel against it on the card.
No tiling: gathers, dense products in float32 and masks.  The two bucketed
versions put the bucketed layout back into the uniform one and call the
uniform version, so on the same plan they give its result bit for bit; the
symbols version decodes the packed bits into the uniform lists the same way.

:func:`attention_ref` and :func:`taylor_reuse_ref` are the reference's own
oracles in its signatures (masks and coefficient stacks, no index lists).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import bucket_row_offsets, bucket_row_widths
from repro_torch.core.symbols import active_indices, unpack_bits

__all__ = ["gemm_q_ref", "attention_csr_ref", "gemm_o_ref",
           "attention_csr_bucketed_ref", "gemm_o_bucketed_ref",
           "csr_layout", "attention_symbols_ref", "taylor_reuse_blocks_ref",
           "attention_ref", "taylor_reuse_ref"]

_NEG_INF = -1e30

# Elements the attention oracles materialise at once (scores, or gathered
# K/V per chunk of slots); bounds their memory at full model width.
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
    (zeros when the list is empty); every other row keeps ``o_reuse``.

    Each live slot gathers its own list's K/V blocks in list order and
    reduces over them alone (``Ckv · block_kv`` keys), so a row's result
    depends on its Q block and the blocks it lists, not on where they lie in
    K/V: a shard that holds a row's blocks in a smaller buffer computes the
    same bits (mesh dispatch).  Slots run in chunks that bound the gathered
    K/V and the scores."""
    bh, n_kv, d = k.shape
    cq, ckv = kv_ids.shape[-2:]
    kb = k.reshape(bh, n_kv // block_kv, block_kv, d)
    vb = v.reshape(bh, n_kv // block_kv, block_kv, d)
    qb = q.reshape(bh, -1, block_q, d)
    scale = (d ** -0.5) if scale is None else scale
    out = o_reuse.clone()
    b_idx, c_idx = (torch.arange(cq, device=k.device) < q_cnt[:, None]).nonzero(as_tuple=True)
    j_live = torch.arange(ckv, device=k.device)
    chunk = max(1, _SCORE_ELEMS // (ckv * block_kv * max(d, block_q)))
    for s0 in range(0, b_idx.numel(), chunk):
        bi, ci = b_idx[s0:s0 + chunk], c_idx[s0:s0 + chunk]
        ids = kv_ids[bi, ci].long()                                      # (L, Ckv)
        kg = kb[bi[:, None], ids].reshape(-1, ckv * block_kv, d).to(torch.float32)
        vg = vb[bi[:, None], ids].reshape(-1, ckv * block_kv, d).to(torch.float32)
        qg = qb[bi, q_src[bi, ci].long()].to(torch.float32)              # (L, bq, d)
        mask = torch.repeat_interleave(j_live < kv_cnt[bi, ci][:, None], block_kv,
                                       dim=-1)[:, None, :]               # (L, 1, Ckv·bk)
        s = torch.where(mask, (qg @ kg.transpose(-1, -2)) * scale, _NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        l = p.sum(dim=-1, keepdim=True)
        rows = q_ids[bi, ci].long()[:, None] * block_q + torch.arange(block_q, device=k.device)
        out[bi[:, None], rows] = ((p @ vg) / torch.where(l == 0, 1.0, l)).to(out.dtype)
    return out


def gemm_o_ref(o_heads: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               row_ids: torch.Tensor, head_ids: torch.Tensor,
               head_cnt: torch.Tensor, *, block: int, h_lo: int = 0) -> torch.Tensor:
    """GEMM-O with head sparsity (Eq. 3): ``out[b, row] = bias[b, row] +
    Σ_{h ∈ head_ids[b,c,:head_cnt[b,c]]} O[b,h,row] @ w[h]`` over the rows of
    slots with ``head_cnt > 0``; every other row keeps ``bias``.

    o_heads (B, H, N, dh), w (H, dh, F), bias (B, N, F), row_ids/head_cnt
    (B, Cr), head_ids (B, Cr, Hc) -> (B, N, F).  The lists may name heads
    of a whole plan of which ``o_heads`` and ``w`` hold the range
    ``[h_lo, h_lo + H)`` (a rank's share of a ``model`` row): a listed head
    outside it is skipped and head ``h`` is read at ``h - h_lo``."""
    b, h, n, dh = o_heads.shape
    cr = row_ids.shape[-1]
    hc = head_ids.shape[-1]
    h_live = torch.arange(hc, device=w.device) < head_cnt[..., None]
    hid = head_ids.long() - h_lo
    hid = torch.where(h_live & (hid >= 0) & (hid < h), hid, h)
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


def _layout_order(key: torch.Tensor, group: torch.Tensor, n_groups: int,
                  hi: int) -> torch.Tensor:
    """(B, R) layout rows in the order of a stable sort by (group, key): the
    rows of group g fill positions ``g·R/G`` to ``(g+1)·R/G``, live rows
    (``key < hi``, unique within their group) by ascending key, then the
    dead ones (``key == hi``) in layout order.  A counting sort (a table
    and two cumulative sums), so the plain versions run no sort op, as the
    kernels they stand for."""
    b, r = key.shape
    dev = key.device
    live = key < hi
    table = torch.zeros((b, n_groups * (hi + 1)), dtype=torch.int64, device=dev)
    table.scatter_(1, group * (hi + 1) + key, 1)
    table = table.reshape(b, n_groups, hi + 1)[..., :hi]
    before = (table.cumsum(-1) - table).reshape(b, -1)         # smaller keys, same group
    dead = (~live)[..., None] & (group[..., None] == torch.arange(n_groups, device=dev))
    dead_before = dead.long().cumsum(1) - dead.long()           # earlier dead rows, same group
    rank = torch.where(
        live, torch.gather(before, 1, group * hi + key.clamp(max=hi - 1)),
        torch.gather(table.sum(-1), 1, group)
        + torch.gather(dead_before, 2, group[..., None])[..., 0])
    dest = group * (r // n_groups) + rank
    return torch.empty_like(key).scatter_(1, dest, torch.arange(r, device=dev).expand(b, r))


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
    order = _layout_order(bkt_q_ids.long(), bkt_head.long(), heads, t_q)
    order = (order + torch.arange(b, device=k.device)[:, None] * r).reshape(b * heads, r // heads)
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
    t = o_heads.shape[2] // block
    order = _layout_order(gmo_rows.long(), torch.zeros_like(gmo_rows, dtype=torch.long), 1,
                          t)                                      # dead slots last
    take = lambda a: torch.gather(a, 1, order)
    heads = _row_lists(gmo_head_ids, geometry)
    heads = torch.gather(heads, 1, order[..., None].expand_as(heads))
    return gemm_o_ref(o_heads, w, bias, take(gmo_src), heads, take(gmo_head_cnt),
                      block=block)


def csr_layout(m_c: torch.Tensor, m_s: torch.Tensor, cap_q: Optional[int] = None,
               cap_kv: Optional[int] = None):
    """The CSR lists of block masks m_c (BH, T_q) and m_s (BH, T_q, T_kv):
    ``(q_ids, q_cnt, kv_ids, kv_cnt, rows)`` — live q blocks ascending (at
    most ``cap_q``), each one's live KV blocks ascending (at most
    ``cap_kv``), and the listed rows of ``m_s`` (BH, Cq, T_kv)."""
    t_q, t_kv = m_c.shape[-1], m_s.shape[-1]
    q_ids, q_cnt = active_indices(m_c, t_q if cap_q is None else cap_q)
    rows = torch.gather(m_s, -2, q_ids.long()[..., None].expand(*q_ids.shape, t_kv))
    kv_ids, kv_cnt = active_indices(rows, t_kv if cap_kv is None else cap_kv)
    return q_ids, q_cnt, kv_ids, kv_cnt, rows


def attention_symbols_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o_reuse: torch.Tensor, s_c: torch.Tensor, s_s: torch.Tensor, *,
                          block_q: int, block_kv: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Algorithm 1 on the packed symbols (B6's semantics).

    q, o_reuse (BH, N, d); k, v (BH, N_kv, d); s_c (BH, ⌈T_q/8⌉) and s_s
    (BH, ⌈T_q·T_kv/8⌉) uint8, big-endian, ``s_s`` the row-major (T_q × T_kv)
    bit matrix.  A row block whose ``s_c`` bit is 0 copies ``o_reuse``; a
    live one attends its live KV blocks in ascending order (zeros when it
    has none)."""
    bh, n, _ = q.shape
    t_q, t_kv = n // block_q, k.shape[1] // block_kv
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(
        unpack_bits(s_c, t_q), unpack_bits(s_s, t_q * t_kv).reshape(bh, t_q, t_kv))
    return attention_csr_ref(q, k, v, o_reuse, q_ids, q_ids, q_cnt, kv_ids, kv_cnt,
                             block_q=block_q, block_kv=block_kv, scale=scale)


def taylor_reuse_blocks_ref(derivs: torch.Tensor, coef: torch.Tensor, base: torch.Tensor,
                            ids: torch.Tensor, cnt: torch.Tensor, *,
                            block: int) -> torch.Tensor:
    """OP_reuse over the listed blocks (B7's semantics).

    derivs (D+1, BH, N, d), coef (D+1,) f32 (any shape of D+1 elements),
    base (BH, N, d), ids (BH, Cc) and cnt (BH,) int32.  Row block
    ``ids[bh, c]`` for ``c < cnt[bh]`` becomes ``Σ_d coef[d]·derivs[d, bh,
    block]`` in f32, stored in ``base``'s dtype; every other block keeps
    ``base``."""
    o1, bh, n, d = derivs.shape
    cc = ids.shape[-1]
    live = torch.arange(cc, device=base.device) < cnt[:, None]         # (BH, Cc)
    b_idx, c_idx = live.nonzero(as_tuple=True)
    rows = (ids[b_idx, c_idx].long()[:, None] * block
            + torch.arange(block, device=base.device))                # (L, block)
    blocks = derivs[:, b_idx[:, None], rows].to(torch.float32)         # (D+1, L, block, d)
    out = base.clone()
    out[b_idx[:, None], rows] = torch.tensordot(
        coef.reshape(o1).to(torch.float32), blocks, dims=1).to(base.dtype)
    return out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, m_c: torch.Tensor,
                  m_s: torch.Tensor, o_reuse: torch.Tensor, *, block_q: int, block_kv: int,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The reference's mask oracle (``repro.kernels.ref.attention_ref``).

    q (BH, N, d), k/v (BH, N_kv, d), m_c (BH, T_q), m_s (BH, T_q, T_kv)
    bool (True = compute), o_reuse (BH, N, d).  Dense masked softmax; rows
    of cached blocks take ``o_reuse``.  As in the reference, a live row
    whose mask row is empty gets a uniform softmax over every key (all its
    scores are -1e30), where the kernels write zeros (ROADMAP C.4).  The
    leading axis runs in chunks to bound the score tensor's memory."""
    bh, n, d = q.shape
    n_kv = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    chunk = max(1, _SCORE_ELEMS // max(1, n * n_kv))
    for s0 in range(0, bh, chunk):
        sl = slice(s0, s0 + chunk)
        tok = torch.repeat_interleave(torch.repeat_interleave(m_s[sl], block_q, dim=-2),
                                      block_kv, dim=-1)[..., :n, :n_kv]
        s = (q[sl] @ k[sl].transpose(-1, -2)).to(torch.float32) * scale
        p = torch.softmax(torch.where(tok, s, _NEG_INF), dim=-1)
        out[sl] = (p @ v[sl].to(torch.float32)).to(q.dtype)
    row_live = torch.repeat_interleave(m_c, block_q, dim=-1)[..., :n]
    return torch.where(row_live[..., None], out, o_reuse)


def taylor_reuse_ref(derivs: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """The reference's OP_reuse oracle: ``Σ_d coefs[d] · derivs[d]`` in f32,
    returned in ``derivs``' dtype (TaylorSeer forecast)."""
    return torch.tensordot(coefs.to(torch.float32), derivs.to(torch.float32),
                           dims=1).to(derivs.dtype)
