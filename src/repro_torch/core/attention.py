"""Attention oracles and the plan's attention index decode, port of the
parts of ``repro.core.attention`` the serving path runs."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.symbols import active_indices, clamp_mask_topk

__all__ = ["SparseAttentionSpec", "dense_attention", "attention_plan_indices"]

_NEG_INF = -1e30


class SparseAttentionSpec(NamedTuple):
    """Static capacities at kernel-block granularity."""

    block_q: int
    block_kv: int
    cap_q: int       # max live Q blocks per (batch, head)
    cap_kv: int      # max live KV blocks per row / in the per-head union
    kv_buckets: int = 1


def dense_attention(q, k, v, *, scale: Optional[float] = None, mask=None):
    """Plain softmax attention (einsum + softmax, not SDPA).  q,k,v: (..., N, d).

    The (..., N, N) score tensor is the dominant allocation at full width
    (4 GB at flux-mmdit, B=2), so the softmax runs in place on it.
    """
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    s = torch.einsum("...qd,...kd->...qk", q, k).to(torch.float32)
    s.mul_(scale)
    if mask is not None:
        s.masked_fill_(~mask, _NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.div_(s.sum(dim=-1, keepdim=True))
    return torch.einsum("...qk,...kd->...qd", s, v.to(torch.float32)).to(q.dtype)


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
