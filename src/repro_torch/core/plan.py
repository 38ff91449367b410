"""Compile-once DispatchPlan, port of ``repro.core.plan`` (uniform layout).

The Update step derives every index structure the next ``𝒩−1`` Dispatch
steps need, once; a Dispatch step reads the plan as-is, with no unpack,
top-k, sort or index work.  Fields (kernel-block granularity unless noted):

  * ``q_ids``/``q_cnt``        live q-block ids per (B, H), full layout;
  * ``q_slots``                the same blocks in the COMPACT GEMM-Q layout,
    so the attention kernel reads Q straight out of the compact projection;
  * ``kv_ids``/``kv_cnt``/``pair_live``  per-(B, H) KV-block union + exact
    pair mask (the reference's XLA layout, kept for parity);
  * ``kv_row_ids``/``kv_row_cnt``  per-live-row CSR lists (the kernel's);
  * ``row_ids``/``row_cnt``    pool-granularity rows live in any head;
  * ``head_ids``/``head_cnt``/``head_mask``  live heads per live row;
  * ``m_ch``, ``row_score``, ``occ_hist``.

Only ``kv_buckets == 1`` without a mesh is ported: the reference's
``bkt_*``/``gmo_*``/``shd_*`` fields do not exist here yet (ROADMAP B4/B5,
A.12).  Id fields are stored int16 when block ids fit in 15 bits and
:meth:`DispatchPlan.widen` restores int32 before launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import masks as masklib
from repro_torch.core.attention import attention_plan_indices
from repro_torch.core.symbols import active_indices, clamp_mask_topk, slot_positions

__all__ = ["DispatchPlan", "build_dispatch_plan", "empty_plan_like",
           "occupancy_histogram", "OCC_BINS"]

#: Width classes of ``DispatchPlan.occ_hist`` (see :func:`occupancy_histogram`).
OCC_BINS = 8

_ID_FIELDS = ("q_ids", "q_slots", "kv_ids", "kv_row_ids", "row_ids", "head_ids")


def occupancy_histogram(kv_row_cnt: torch.Tensor, q_cnt: torch.Tensor,
                        cap_kv: int) -> torch.Tensor:
    """(B, OCC_BINS) int32 count of live rows per halving width class: a row
    lands in class ``#{i : cnt ≤ ⌈cap_kv/2^{i+1}⌉}``."""
    live = (torch.arange(kv_row_cnt.shape[-1], device=q_cnt.device)
            < q_cnt[..., None])
    ths = torch.tensor([-(-cap_kv // (1 << (i + 1))) for i in range(OCC_BINS - 1)],
                       dtype=torch.int32, device=q_cnt.device)
    cls = (kv_row_cnt[..., None] <= ths).sum(dim=-1)
    onehot = (cls[..., None] == torch.arange(OCC_BINS, device=q_cnt.device)) \
        & live[..., None]
    return onehot.sum(dim=(1, 2)).to(torch.int32)


class DispatchPlan(NamedTuple):
    """Precomputed index plan for Dispatch steps (tensors, int16/int32/bool)."""

    q_ids: torch.Tensor       # (B, H, Cq)
    q_cnt: torch.Tensor       # (B, H)
    q_slots: torch.Tensor     # (B, H, Cq)
    kv_ids: torch.Tensor      # (B, H, Ck)
    kv_cnt: torch.Tensor      # (B, H)
    pair_live: torch.Tensor   # (B, H, Cq, Ck) bool
    kv_row_ids: torch.Tensor  # (B, H, Cq, Ck)
    kv_row_cnt: torch.Tensor  # (B, H, Cq)
    row_ids: torch.Tensor     # (B, Cr)
    row_cnt: torch.Tensor     # (B,)
    head_ids: torch.Tensor    # (B, Cr, H)
    head_cnt: torch.Tensor    # (B, Cr)
    head_mask: torch.Tensor   # (B, Cr, H) bool
    m_ch: torch.Tensor        # (B, T, H) bool
    row_score: torch.Tensor   # (B, T) f32
    occ_hist: torch.Tensor    # (B, OCC_BINS) int32

    def widen(self) -> "DispatchPlan":
        """The plan with every int16 id field widened to contiguous int32."""
        return self._replace(**{f: getattr(self, f).to(torch.int32).contiguous()
                                for f in _ID_FIELDS})


def build_dispatch_plan(m_c: torch.Tensor, m_s: torch.Tensor, cfg, n_tokens: int,
                        row_score=None, compact_ids: bool = True) -> DispatchPlan:
    """Derive the full index plan from compressed-granularity masks.

    ``m_c`` (B, H, T) / ``m_s`` (B, H, T, T) bool, True = compute.
    ``row_score`` (B, T) ranks rows for the capacity truncation; when
    ``None`` it falls back to the live-pair count per row.
    """
    spec = cfg.caps(n_tokens)
    if spec.kv_buckets != 1:
        raise NotImplementedError("occupancy-bucketed plans (kv_buckets > 1) "
                                  "are not ported yet")
    m = cfg.mask
    factor = m.pool // m.block_q
    t_q = -(-n_tokens // m.block_q)
    t_kv = -(-n_tokens // m.block_kv)
    t_cmp = m_c.shape[-1]
    dev = m_c.device

    # GEMM-Q / GEMM-O row gather (pool granularity, any-head union), ranked
    # by column mass when the row capacity truncates.
    cap_rows = cfg.cap_q_cmp(n_tokens)
    row_live = m_c.any(dim=-2)
    if row_score is None:
        row_score = torch.where(m_c, m_s.sum(dim=-1).to(torch.float32),
                                0.0).sum(dim=-2)
    row_score = row_score.to(torch.float32)
    row_live = clamp_mask_topk(row_live, row_score, cap_rows)
    row_ids, row_cnt = active_indices(row_live, cap_rows)
    slot = torch.arange(cap_rows, dtype=torch.int32, device=dev)
    sid = torch.where(slot < row_cnt[..., None], row_ids.to(torch.int64), t_cmp)
    kept = torch.zeros((*row_ids.shape[:-1], t_cmp + 1), dtype=torch.bool,
                       device=dev).scatter_(-1, sid, True)[..., :t_cmp]
    m_c = m_c & kept[..., None, :]

    m_c_blk = masklib.expand_block_mask(m_c, factor, t_q)
    m_s_blk = torch.repeat_interleave(
        torch.repeat_interleave(m_s, factor, dim=-2),
        m.pool // m.block_kv, dim=-1)[..., :t_q, :t_kv]

    q_ids, q_cnt, kv_ids, kv_cnt, pair_live = attention_plan_indices(
        m_c_blk, m_s_blk, spec)

    # Kernel reduction layout: per-live-row CSR column lists.
    rows = torch.gather(m_s_blk, -2, q_ids.to(torch.int64)[..., :, None].expand(
        *q_ids.shape, t_kv))
    kv_row_ids, kv_row_cnt = active_indices(rows, spec.cap_kv)

    # Compact-layout remap: live q block i sits at block
    # slot(i // factor)·factor + i % factor of the compact GEMM-Q output.
    row_slot = slot_positions(row_ids, row_cnt, t_cmp)            # (B, T)
    slot_of = torch.gather(row_slot[:, None, :].expand(*q_ids.shape[:-1], t_cmp),
                           -1, (q_ids // factor).to(torch.int64))
    q_slots = slot_of * factor + q_ids % factor

    # GEMM-O reduction sparsity over the kept rows; padding slots get empty
    # head lists (the kernel's output aliases the bias, so a padded
    # duplicate with live heads would re-accumulate its row).
    m_ch = m_c.transpose(-1, -2)                                   # (B, T, H)
    heads = m_ch.shape[-1]
    head_mask = torch.gather(m_ch, -2, row_ids.to(torch.int64)[..., None].expand(
        *row_ids.shape, heads))
    head_mask = head_mask & (slot < row_cnt[..., None])[..., None]
    head_ids, head_cnt = active_indices(head_mask, heads)

    occ_hist = occupancy_histogram(kv_row_cnt, q_cnt, spec.cap_kv)

    if compact_ids and max(t_cmp, t_q + 1, t_kv, heads) < 2 ** 15:
        kv_row_ids, row_ids, q_ids, q_slots, kv_ids, head_ids = (
            a.to(torch.int16) for a in
            (kv_row_ids, row_ids, q_ids, q_slots, kv_ids, head_ids))

    return DispatchPlan(
        q_ids=q_ids, q_cnt=q_cnt, q_slots=q_slots,
        kv_ids=kv_ids, kv_cnt=kv_cnt, pair_live=pair_live,
        kv_row_ids=kv_row_ids, kv_row_cnt=kv_row_cnt,
        row_ids=row_ids, row_cnt=row_cnt,
        head_ids=head_ids, head_cnt=head_cnt, head_mask=head_mask,
        m_ch=m_ch, row_score=row_score, occ_hist=occ_hist)


def empty_plan_like(batch: int, heads: int, n_tokens: int, cfg,
                    device) -> DispatchPlan:
    """All-live plan matching the all-ones init symbols (warmup state)."""
    t = cfg.mask.n_blocks(n_tokens)
    m_c = torch.ones((batch, heads, t), dtype=torch.bool, device=device)
    m_s = torch.ones((batch, heads, t, t), dtype=torch.bool, device=device)
    return build_dispatch_plan(m_c, m_s, cfg, n_tokens)
