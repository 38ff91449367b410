"""Attention oracles and the plan's attention index decode, port of the
parts of ``repro.core.attention`` the serving path runs."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.symbols import active_indices, clamp_mask_topk

__all__ = ["SparseAttentionSpec", "dense_attention", "attention_plan_indices"]

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
    fold = lambda t, *tail: t.expand(*lead, *tail).reshape(-1, *(lead[-1:] or (1,)), *tail)
    q4, k4 = fold(q, n_q, q.shape[-1]), fold(k, n_kv, k.shape[-1])
    v4 = fold(v, n_kv, d_v).to(torch.float32)
    m4 = None if mask is None else fold(mask, n_q, n_kv)
    out = torch.empty((*q4.shape[:2], n_q, d_v), dtype=q.dtype, device=q.device)
    rows = max(1, min(n_q, _SCORE_ELEMS // max(1, n_kv)))
    heads = max(1, _SCORE_ELEMS // max(1, rows * n_kv)) if rows == n_q else 1
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
