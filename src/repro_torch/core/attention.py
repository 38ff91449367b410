"""FlashOmni attention, port of ``repro.core.attention``: the dense oracles,
the plan's attention index decode and the structural-sparse path.

The structural path (:func:`sparse_attention_from_plan`, the engine's
``TorchBackend``) computes the CSR kernels' results from gathers, einsums
and a softmax: cached Q blocks are dropped by a capacity-padded gather, and
the KV reduction runs over the per-head union of live KV blocks with the
exact pair mask inside it or, whenever ``cap_kv`` can truncate a row
(``cap_kv < T_kv``, ``kv_buckets > 1`` or ``force_per_row``), over each live
row's own CSR list, the kernels' truncation.  Masks are boolean, True =
compute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.symbols import active_indices, clamp_mask_topk

__all__ = ["SparseAttentionSpec", "dense_attention", "masked_block_attention",
           "attention_plan_indices", "scatter_blocks", "sparse_attention_from_plan",
           "sparse_attention_xla", "sparse_decode_attention"]

_NEG_INF = -1e30
# Elements of the f32 score chunk dense_attention forms at once (1 GiB).
_SCORE_ELEMS = 1 << 28


class SparseAttentionSpec(NamedTuple):
    """Static capacities at kernel-block granularity."""

    block_q: int
    block_kv: int
    cap_q: int       # max live Q blocks per (batch, head)
    cap_kv: int      # max live KV blocks per row / in the per-head union
    kv_buckets: int = 1


def dense_attention(q, k, v, *, scale: Optional[float] = None, mask=None):
    """Plain softmax attention (einsum + softmax, not SDPA).  q,k,v: (..., N, d);
    ``mask`` (broadcast to (..., N_q, N_kv)) keeps the True pairs.

    The (..., N_q, N_kv) f32 score tensor does not fit on a card at full width
    (105 GB at hunyuan-video-dit, B=1), so the scores are formed for one chunk
    of heads (the last leading dim) and query rows at a time, at most
    ``_SCORE_ELEMS`` elements; every row's softmax is whole within its chunk,
    and runs in place.  The chunks are views: no input is copied.
    """
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    lead = tuple(np.broadcast_shapes(q.shape[:-2], k.shape[:-2], v.shape[:-2]))
    n_q, n_kv, d_v = q.shape[-2], k.shape[-2], v.shape[-1]
    # (rest, heads, N, d): every leading dim but the last folds into ``rest``.
    rest = int(np.prod(lead[:-1], dtype=np.int64))
    fold = lambda t, *tail: t.expand(*lead, *tail).reshape(rest, *(lead[-1:] or (1,)), *tail)
    q4, k4 = fold(q, n_q, q.shape[-1]), fold(k, n_kv, k.shape[-1])
    v4 = fold(v, n_kv, d_v).to(torch.float32)
    m4 = None if mask is None else fold(mask, n_q, n_kv)
    rows = max(1, min(n_q, _SCORE_ELEMS // max(1, n_kv)))
    heads = max(1, _SCORE_ELEMS // max(1, rows * n_kv)) if rows == n_q else 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = _dense_attention_grad(q4, k4, v4, m4, scale, rows, heads, q.dtype)
        return out.reshape(*lead, n_q, d_v)
    out = torch.empty((*q4.shape[:2], n_q, d_v), dtype=q.dtype, device=q.device)
    for i in range(q4.shape[0]):
        for h0 in range(0, q4.shape[1], heads):
            hs = slice(h0, h0 + heads)
            for r0 in range(0, n_q, rows):
                rs = slice(r0, r0 + rows)
                s = torch.einsum("...qd,...kd->...qk", q4[i, hs, rs], k4[i, hs]).to(torch.float32)
                s.mul_(scale)
                if m4 is not None:
                    s.masked_fill_(~m4[i, hs, rs], _NEG_INF)
                s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
                s.div_(s.sum(dim=-1, keepdim=True))
                out[i, hs, rs] = torch.einsum("...qk,...kd->...qd", s, v4[i, hs]).to(q.dtype)
    return out.reshape(*lead, n_q, d_v)


def _dense_attention_grad(q4, k4, v4, m4, scale, rows, heads, dtype):
    """The grad branch of :func:`dense_attention`, over the same (heads, rows)
    chunks: each chunk's scores, softmax and weighted sum are formed out of
    place and the chunks are joined with ``torch.cat``, so autograd can
    differentiate it.  It keeps one f32 probability chunk per chunk for the
    backward (``torch.softmax`` saves its output, which the second einsum
    also reads): ≈ 2.04 GB a layer at flux-mmdit's width, batch 1."""
    out = []
    for i in range(q4.shape[0]):
        by_head = []
        for h0 in range(0, q4.shape[1], heads):
            hs = slice(h0, h0 + heads)
            by_row = []
            for r0 in range(0, q4.shape[2], rows):
                rs = slice(r0, r0 + rows)
                s = torch.einsum("...qd,...kd->...qk", q4[i, hs, rs],
                                 k4[i, hs]).to(torch.float32) * scale
                if m4 is not None:
                    s = s.masked_fill(~m4[i, hs, rs], _NEG_INF)
                p = torch.softmax(s, dim=-1)
                by_row.append(torch.einsum("...qk,...kd->...qd", p, v4[i, hs]).to(dtype))
            by_head.append(torch.cat(by_row, dim=-2))
        out.append(torch.cat(by_head, dim=0))
    return torch.stack(out)


def attention_plan_indices(m_c: torch.Tensor, m_s: torch.Tensor,
                           spec: SparseAttentionSpec):
    """Index decode of the attention slice of a DispatchPlan (Update time).

    Returns ``(q_ids, q_cnt, kv_ids, kv_cnt, pair_live)``.
    """
    q_ids, q_cnt = active_indices(m_c, spec.cap_q)
    need = (m_s & m_c[..., None]).sum(dim=-2)
    kv_union = clamp_mask_topk(need > 0, need, spec.cap_kv)
    kv_ids, kv_cnt = active_indices(kv_union, spec.cap_kv)
    rows = torch.gather(
        m_s, -2, q_ids.to(torch.int64)[..., :, None].expand(
            *q_ids.shape, m_s.shape[-1]))
    pair = torch.gather(
        rows, -1, kv_ids.to(torch.int64)[..., None, :].expand(
            *rows.shape[:-1], kv_ids.shape[-1]))
    kv_valid = torch.arange(spec.cap_kv, device=m_c.device) < kv_cnt[..., None]
    return q_ids, q_cnt, kv_ids, kv_cnt, pair & kv_valid[..., None, :]


def _block_mask_to_tokens(m_s: torch.Tensor, block_q: int, block_kv: int, n_q: int,
                          n_kv: int) -> torch.Tensor:
    """(…, T_q, T_kv) block mask -> (…, n_q, n_kv) token mask."""
    m = m_s.repeat_interleave(block_q, dim=-2).repeat_interleave(block_kv, dim=-1)
    return m[..., :n_q, :n_kv]


def masked_block_attention(q, k, v, m_c, m_s, o_reuse, *, block_q, block_kv,
                           scale: Optional[float] = None):
    """Dense oracle with FlashOmni semantics: rows in blocks with ``m_c == 0``
    take ``o_reuse``; live rows attend only the KV blocks with ``m_s == 1``
    (a live row with none gets a uniform softmax, every score being −1e30).
    Kept for parity with the reference; nothing in the port calls it."""
    n_q, n_kv = q.shape[-2], k.shape[-2]
    tok_mask = _block_mask_to_tokens(m_s, block_q, block_kv, n_q, n_kv)
    out = dense_attention(q, k, v, scale=scale, mask=tok_mask)
    row_live = m_c.repeat_interleave(block_q, dim=-1)[..., :n_q]
    return torch.where(row_live[..., None], out, o_reuse)


def _gather_blocks(x_blocks: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather block rows: x_blocks (..., T, b, d), ids (..., C) -> (..., C, b, d).

    Advanced indexing over the flattened leading dims, so the index is
    (P, C) and not the output's size, as ``torch.gather`` would need."""
    lead = ids.shape[:-1]
    xf = x_blocks.reshape(-1, *x_blocks.shape[-3:])
    idx = ids.reshape(-1, ids.shape[-1]).long()
    rows = torch.arange(xf.shape[0], device=ids.device)[:, None]
    return xf[rows, idx].reshape(*lead, ids.shape[-1], *x_blocks.shape[-2:])


def _gather_row_blocks(x_blocks: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-row block gather: x_blocks (..., T, b, d), ids (..., C, Ck) ->
    (..., C, Ck, b, d): each row gets its own KV-block list (CSR layout)."""
    flat = _gather_blocks(x_blocks, ids.reshape(*ids.shape[:-2], -1))
    return flat.reshape(*ids.shape, *x_blocks.shape[-2:])


def scatter_blocks(base: torch.Tensor, ids: torch.Tensor, cnt: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Scatter capacity-padded block rows into a copy of ``base`` (..., T, b, d).

    Padding slots (slot >= cnt) write to a trash block past ``T`` that is
    sliced off, so they never clobber a live block that shares their
    (duplicated) id; live ids are distinct.  Every shape is static: the
    write costs the same for every plan of one capacity, and nothing waits
    for the card.  The reference writes through a one-hot einsum, a
    workaround for GSPMD (a data-dependent scatter on a sequence-sharded
    axis gathered the whole operand); every one-hot weight is 0 or 1 and
    each block receives at most one live slot, so this index write gives the
    same values.  The result is a view of the padded copy."""
    t = base.shape[-3]
    out = base.new_empty((*base.shape[:-3], t + 1, *base.shape[-2:]))
    out[..., :t, :, :] = base
    of = out.view(-1, t + 1, *base.shape[-2:])
    idx = ids.reshape(-1, ids.shape[-1]).long()
    live = torch.arange(idx.shape[-1], device=ids.device) < cnt.reshape(-1, 1)
    rows = torch.arange(idx.shape[0], device=ids.device)[:, None]
    of[rows, torch.where(live, idx, t)] = vals.reshape(*idx.shape, *vals.shape[-2:]) \
        .to(base.dtype)
    return out[..., :t, :, :]


def _masked_softmax_av(qg, kg, vg, live, scale, eq_s, eq_o, out_dtype):
    """Scores of a chunk of gathered q blocks against gathered KV blocks,
    masked to −1e30 off ``live`` (broadcast to the scores), softmax over each
    row's whole KV axis (``cap_kv · block_kv``), weighted sum of V."""
    s = torch.einsum(eq_s, qg, kg).to(torch.float32) * scale
    s = s.masked_fill(~live, _NEG_INF)
    shape = s.shape
    p = torch.softmax(s.reshape(*shape[:-2], shape[-2] * shape[-1]), dim=-1)
    return torch.einsum(eq_o, p.reshape(shape), vg.to(torch.float32)).to(out_dtype)


def sparse_attention_from_plan(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o_reuse: torch.Tensor,
    q_ids: torch.Tensor, q_cnt: torch.Tensor, kv_ids: torch.Tensor,
    kv_cnt: torch.Tensor, pair_live: torch.Tensor, spec: SparseAttentionSpec, *,
    scale: Optional[float] = None, q_chunk_blocks: int = 16,
    q_src_ids: Optional[torch.Tensor] = None,
    kv_row_ids: Optional[torch.Tensor] = None,
    kv_row_cnt: Optional[torch.Tensor] = None,
    force_per_row: bool = False,
) -> torch.Tensor:
    """Structurally sparse attention over precomputed plan indices.

    q/k/v/o_reuse (..., N, d); the index tensors as
    :func:`attention_plan_indices` returns them.  No index decoding happens
    here.  ``q_src_ids`` re-maps the Q gather to the compact GEMM-Q layout
    while the output scatter keeps ``q_ids``.  The reduction runs per row over
    ``kv_row_ids``/``kv_row_cnt`` (the kernels' truncation) whenever
    ``cap_kv < T_kv``, ``kv_buckets > 1`` (the bucket clamp lives in
    ``kv_row_cnt``) or ``force_per_row``; otherwise over the per-head union
    ``kv_ids`` with ``pair_live`` masking pairs inside it.  A live row whose
    list is empty gets a uniform softmax (every score −1e30), where the
    kernels write zeros.

    The live q blocks run in chunks of ``q_chunk_blocks`` so that the
    gathered per-row K/V stay O(chunk · Ckv · block_kv · d).  The reference
    maps over equal chunks only when ``cap_q`` is a multiple of the chunk
    (``lax.map`` needs one shape) and runs one chunk otherwise; here the
    last chunk may be short.  Each row's softmax lies whole in one chunk,
    so chunking does not change the rows.
    """
    bq, bk = spec.block_q, spec.block_kv
    d = q.shape[-1]
    n_kv = k.shape[-2]
    t_q = o_reuse.shape[-2] // bq
    t_kv = n_kv // bk
    scale = (d ** -0.5) if scale is None else scale
    q_src_ids = q_ids if q_src_ids is None else q_src_ids
    per_row = kv_row_ids is not None and (force_per_row or spec.cap_kv < t_kv
                                          or spec.kv_buckets > 1)
    qb = q.reshape(*q.shape[:-2], q.shape[-2] // bq, bq, d)
    kb = k.reshape(*k.shape[:-2], t_kv, bk, d)
    vb = v.reshape(*v.shape[:-2], t_kv, bk, d)
    if not per_row:
        kg = _gather_blocks(kb, kv_ids)                              # (..., Ck, bk, d)
        vg = _gather_blocks(vb, kv_ids)
    slots = torch.arange(spec.cap_kv, device=q.device)
    chunks = []
    for c0 in range(0, q_src_ids.shape[-1], q_chunk_blocks):
        cs = slice(c0, c0 + q_chunk_blocks)
        qg = _gather_blocks(qb, q_src_ids[..., cs])                  # (..., cc, bq, d)
        if per_row:
            live = slots < kv_row_cnt[..., cs, None]                 # (..., cc, Ck)
            chunks.append(_masked_softmax_av(
                qg, _gather_row_blocks(kb, kv_row_ids[..., cs, :]),
                _gather_row_blocks(vb, kv_row_ids[..., cs, :]),
                live[..., :, None, :, None], scale,
                "...ipd,...ijqd->...ipjq", "...ipjq,...ijqd->...ipd", q.dtype))
        else:
            chunks.append(_masked_softmax_av(
                qg, kg, vg, pair_live[..., cs, None, :, None], scale,
                "...ipd,...jqd->...ipjq", "...ipjq,...jqd->...ipd", q.dtype))
    og = torch.cat(chunks, dim=-3)                                   # (..., Cq, bq, d)
    out_blocks = o_reuse.reshape(*o_reuse.shape[:-2], t_q, bq, d)
    return scatter_blocks(out_blocks, q_ids, q_cnt, og).reshape(o_reuse.shape)


def sparse_attention_xla(q, k, v, m_c, m_s, o_reuse, spec: SparseAttentionSpec, *,
                         scale: Optional[float] = None, q_chunk_blocks: int = 16):
    """Mask-level entry of the structural path: decodes the plan indices per
    call (m_c (..., T_q), m_s (..., T_q, T_kv)) and runs
    :func:`sparse_attention_from_plan`, with the per-row lists decoded
    whenever ``cap_kv`` can truncate.  The name is the reference's.
    Kept for parity with the reference; nothing in the port calls it."""
    q_ids, q_cnt, kv_ids, kv_cnt, pair_live = attention_plan_indices(m_c, m_s, spec)
    kv_row_ids = kv_row_cnt = None
    if spec.cap_kv < m_s.shape[-1] or spec.kv_buckets > 1:
        rows = torch.gather(m_s, -2, q_ids.long()[..., :, None].expand(
            *q_ids.shape, m_s.shape[-1]))
        kv_row_ids, kv_row_cnt = active_indices(rows, spec.cap_kv)
    return sparse_attention_from_plan(
        q, k, v, o_reuse, q_ids, q_cnt, kv_ids, kv_cnt, pair_live, spec, scale=scale,
        q_chunk_blocks=q_chunk_blocks, kv_row_ids=kv_row_ids, kv_row_cnt=kv_row_cnt)


def sparse_decode_attention(q, k_cache, v_cache, kv_ids, kv_cnt, block_kv: int, *,
                            scale: Optional[float] = None, positions=None,
                            cache_len: Optional[torch.Tensor] = None):
    """Block-sparse decode: a few query tokens q (..., n_new, d) against the
    gathered KV-cache blocks ``kv_ids``/``kv_cnt`` of caches (..., S, d);
    ``cache_len`` (...) masks tokens past the filled length.  ``positions``
    is accepted for the reference's signature and unused, as there.
    Its caller is :mod:`repro_torch.long_context_lm`, the port of the
    reference's long-context example."""
    d = q.shape[-1]
    t_kv = k_cache.shape[-2] // block_kv
    scale = (d ** -0.5) if scale is None else scale
    kg = _gather_blocks(k_cache.reshape(*k_cache.shape[:-2], t_kv, block_kv, d), kv_ids)
    vg = _gather_blocks(v_cache.reshape(*v_cache.shape[:-2], t_kv, block_kv, d), kv_ids)
    s = torch.einsum("...nd,...jqd->...njq", q, kg).to(torch.float32) * scale
    live = (torch.arange(kv_ids.shape[-1], device=q.device) < kv_cnt[..., None])
    live = live[..., None, :, None]
    if cache_len is not None:
        tok_pos = kv_ids.long()[..., :, None] * block_kv + torch.arange(block_kv,
                                                                          device=q.device)
        live = live & (tok_pos < cache_len[..., None, None, None])
    s = s.masked_fill(~live, _NEG_INF)
    p = torch.softmax(s.reshape(*s.shape[:-2], -1), dim=-1).reshape(s.shape)
    return torch.einsum("...njq,...jqd->...nd", p, vg.to(torch.float32)).to(q.dtype)
