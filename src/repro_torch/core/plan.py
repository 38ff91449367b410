"""Compile-once DispatchPlan, port of ``repro.core.plan``.

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
  * ``m_ch``, ``row_score``, ``occ_hist``;
  * with ``kv_buckets > 1``, the occupancy-bucketed layouts: ``bkt_*`` sorts
    the H·Cq (head, q-slot) attention rows into halving-width KV buckets
    (:func:`bucket_layout`), ``gmo_*`` sorts the Cr compact row slots into
    halving-depth live-head buckets (:func:`gmo_layout`).  Each bucket clamp
    is folded back into ``kv_row_cnt`` / ``head_cnt`` / ``head_mask``, so
    the uniform and the bucketed kernels consume the same truncated lists.

Under a seq mesh (``EngineConfig.mesh_sp > 1``, ``mesh_axis="seq"``) the
per-(src, dst) pair clamp is folded into the row masks before the lists are
extracted, and ``shd_*`` carries the per-shard partition and exchange
tables (:mod:`repro_torch.distributed.plan_shard`).  Id fields are stored
int16 when block ids fit in 15 bits (the ``shd_*`` ids when the exchange
buffer does) and :meth:`DispatchPlan.widen` restores int32 before launch.
With ``EngineConfig.validate_plans`` (or ``REPRO_VALIDATE_PLANS=1``) every
build ends in the structural validator (:mod:`repro_torch.analysis.plan_check`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import masks as masklib
from repro_torch.core.attention import attention_plan_indices
from repro_torch.core.symbols import active_indices, clamp_mask_topk, slot_positions

__all__ = ["DispatchPlan", "build_dispatch_plan", "empty_plan_like",
           "bucket_geometry", "bucket_slot_layout", "bucket_grid_slots",
           "bucket_row_widths", "bucket_row_offsets", "bucket_layout", "gmo_layout",
           "occupancy_histogram", "OCC_BINS"]

#: Width classes of ``DispatchPlan.occ_hist`` (see :func:`occupancy_histogram`).
OCC_BINS = 8

_BKT_IDS = ("bkt_head", "bkt_q_ids", "bkt_q_src", "bkt_q_slots", "bkt_kv_ids")
_GMO_IDS = ("gmo_rows", "gmo_src", "gmo_head_ids")
_SHD_IDS = ("shd_q_ids", "shd_q_src", "shd_q_slots", "shd_kv_ids", "shd_kv_row_ids",
            "shd_gather_idx", "shd_send_ids")
_ID_FIELDS = ("q_ids", "q_slots", "kv_ids", "kv_row_ids", "row_ids", "head_ids",
              *_BKT_IDS, *_GMO_IDS)


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


def bucket_geometry(cap_q: int, cap_kv: int, heads: int,
                    n_buckets: int) -> tuple[tuple[int, int], ...]:
    """Static occupancy-bucket geometry ``((rows, width), ...)``, widest first.

    Widths halve per bucket (``cap_kv, ⌈cap_kv/2⌉, …``) and the
    ``heads · cap_q`` layout rows are shared inversely to width (equal slot
    area per bucket); the head axis folds into the row pool because the
    occupancy skew the buckets absorb lies across heads."""
    r_total = heads * cap_q
    n_buckets = max(1, min(n_buckets, r_total, cap_kv))
    if n_buckets == 1:
        return ((r_total, cap_kv),)
    widths = [-(-cap_kv // (1 << i)) for i in range(n_buckets)]
    denom = (1 << n_buckets) - 1
    rows = [max(1, (r_total << i) // denom) for i in range(n_buckets)]
    rows[-1] += r_total - sum(rows)
    # Tiny-R edge: the max(1, ·) bumps can overdraw; repay from the
    # narrowest buckets that still have rows to spare.
    for i in range(n_buckets - 1, -1, -1):
        if rows[i] < 1:
            for j in range(n_buckets - 1, -1, -1):
                if rows[j] > 1:
                    take = min(rows[j] - 1, 1 - rows[i])
                    rows[j] -= take
                    rows[i] += take
                    if rows[i] >= 1:
                        break
    assert sum(rows) == r_total and all(r >= 1 for r in rows)
    return tuple(zip(rows, widths))


def bucket_row_widths(geometry) -> np.ndarray:
    """(R,) int32 width of each layout row's bucket."""
    return np.concatenate([np.full(r, w, np.int32) for r, w in geometry])


def bucket_row_offsets(geometry) -> np.ndarray:
    """(R,) int32 start of each layout row's list in the flat ``(B, S)``
    id field (the row's ``soff``); what the CUDA kernels take instead of
    the TPU grid's per-slot decode."""
    widths = bucket_row_widths(geometry).astype(np.int64)
    return (np.cumsum(widths) - widths).astype(np.int32)


def bucket_slot_layout(geometry) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """Per-grid-slot index arrays of a geometry, int32 of length
    ``S = Σ rows·width``: ``(srow, j_of, soff, slast)`` = the layout row of
    each slot, its position in the row's reduction, the slot where the row
    starts, and a last-slot-of-row flag.  Built with array operations: at
    the serving shapes S is about 10⁶ per plan build."""
    widths = bucket_row_widths(geometry)
    srow = np.repeat(np.arange(widths.size, dtype=np.int32), widths)
    soff = np.repeat(bucket_row_offsets(geometry), widths)
    j_of = np.arange(srow.size, dtype=np.int32) - soff
    slast = (j_of == np.repeat(widths, widths) - 1).astype(np.int32)
    return srow, j_of, soff, slast


def bucket_grid_slots(geometry) -> int:
    """Total grid slots the bucketed layout occupies."""
    return int(sum(rows * width for rows, width in geometry))


@functools.lru_cache(maxsize=16)
def _slot_index(geometry, width: int, device) -> torch.Tensor:
    """(S,) flat index of each grid slot's entry in a (R, width) row-list
    array sorted into layout order; built once per geometry and device (a
    plan build at the serving shapes would otherwise spend about 10 ms of
    host time on it per layer)."""
    srow, j_of, _, _ = bucket_slot_layout(geometry)
    return torch.from_numpy(srow.astype(np.int64) * width + j_of).to(device)


def _lex_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting the last axis by ``keys`` lexicographically (first
    key most significant), ties left in index order: stable passes from the
    last key to the first, as the reference's multi-key ``lax.sort`` with a
    trailing position key."""
    order = torch.arange(keys[0].shape[-1], device=keys[0].device).expand(
        keys[0].shape).contiguous()
    for key in reversed(keys):
        idx = torch.argsort(torch.gather(key, -1, order), dim=-1, stable=True)
        order = torch.gather(order, -1, idx)
    return order


def bucket_layout(q_ids, q_cnt, q_slots, kv_row_ids, kv_row_cnt, row_score_q,
                  geometry, t_q: int):
    """Sort the H·Cq (head, q-slot) layout rows into the bucket geometry.

    Index arrays are (B, H, Cq[, Ck]) int32; ``row_score_q`` (B, H, Cq)
    ranks rows.  Order: live first, then descending KV count, descending
    row score, layout position.  Returns ``(bkt, kv_row_cnt')``: the
    ``bkt_*`` fields and the per-row counts with the bucket clamp folded
    back in (padding q slots take the last live row's clamped count)."""
    b_, h_, cq = q_ids.shape
    r_tot = h_ * cq
    dev = q_ids.device
    live = torch.arange(cq, device=dev) < q_cnt[..., None]          # (B,H,Cq)
    cnt = torch.where(live, kv_row_cnt, 0)
    flat2 = lambda a: a.reshape(b_, r_tot)
    order = _lex_order(flat2(~live).to(torch.int32), flat2(-cnt),
                       flat2(-row_score_q.to(torch.float32)))
    g = lambda a: torch.gather(flat2(a), -1, order)
    s_live = g(live)
    bkt_kv_cnt = torch.minimum(g(cnt), torch.from_numpy(bucket_row_widths(geometry)).to(dev))
    new_cnt = torch.zeros_like(flat2(cnt)).scatter_(-1, order, bkt_kv_cnt)
    new_cnt = new_cnt.reshape(b_, h_, cq)
    last_cnt = torch.gather(new_cnt, -1,
                            torch.clamp(q_cnt - 1, min=0).to(torch.int64)[..., None])
    kv_row_cnt = torch.where(live, new_cnt, last_cnt)
    ck = kv_row_ids.shape[-1]
    sorted_kv = torch.gather(kv_row_ids.reshape(b_, r_tot, ck), 1,
                             order[..., None].expand(b_, r_tot, ck))
    bkt = dict(
        bkt_head=(order // cq).to(torch.int32),
        bkt_q_ids=torch.where(s_live, g(q_ids), t_q),
        bkt_q_src=torch.where(s_live, g(q_ids), 0),
        bkt_q_slots=torch.where(s_live, g(q_slots), 0),
        bkt_kv_ids=sorted_kv.reshape(b_, -1)[:, _slot_index(geometry, ck, dev)],  # (B, S)
        bkt_kv_cnt=bkt_kv_cnt,
    )
    return bkt, kv_row_cnt


def gmo_layout(row_ids, row_cnt, head_ids, head_cnt, row_score_r, geometry,
               t_cmp: int):
    """Sort the Cr compact row slots into live-head-count buckets (the GEMM-O
    analogue of :func:`bucket_layout`; ``geometry`` is
    ``bucket_geometry(Cr, H, 1, kv_buckets)``).

    Returns ``(gmo, head_cnt', head_mask')``: the ``gmo_*`` fields and the
    head lists with the bucket clamp folded back in, ``head_mask'`` rebuilt
    from the clamped CSR prefixes."""
    b_, cr = row_ids.shape
    h_ = head_ids.shape[-1]
    dev = row_ids.device
    live = torch.arange(cr, device=dev)[None, :] < row_cnt[:, None]   # (B, Cr)
    cnt = torch.where(live, head_cnt, 0)
    order = _lex_order((~live).to(torch.int32), -cnt,
                       -row_score_r.to(torch.float32))
    g = lambda a: torch.gather(a, -1, order)
    s_live = g(live)
    gmo_head_cnt = torch.minimum(g(cnt), torch.from_numpy(bucket_row_widths(geometry)).to(dev))
    new_cnt = torch.zeros_like(cnt).scatter_(-1, order, gmo_head_cnt)
    keep = torch.arange(h_, device=dev) < new_cnt[..., None]          # (B,Cr,H)
    sid = torch.where(keep, head_ids.to(torch.int64), h_)
    new_mask = torch.zeros((b_, cr, h_ + 1), dtype=torch.bool,
                           device=dev).scatter_(-1, sid, True)[..., :h_]
    sorted_heads = torch.gather(head_ids, 1, order[..., None].expand(b_, cr, h_))
    gmo = dict(
        gmo_rows=torch.where(s_live, g(row_ids), t_cmp),
        gmo_src=torch.where(s_live, g(row_ids), 0),
        gmo_head_ids=sorted_heads.reshape(b_, -1)[:, _slot_index(geometry, h_, dev)],
        gmo_head_cnt=gmo_head_cnt,
    )
    return gmo, new_cnt, new_mask


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
    # Occupancy-bucketed attention layout (None unless kv_buckets > 1):
    # R = H·Cq layout rows, S = Σ rows·width slots of bucket_geometry.
    bkt_head: Optional[torch.Tensor] = None      # (B, R) head of each layout row
    bkt_q_ids: Optional[torch.Tensor] = None     # (B, R) output q block (dead -> T_q)
    bkt_q_src: Optional[torch.Tensor] = None     # (B, R) read q block, full layout
    bkt_q_slots: Optional[torch.Tensor] = None   # (B, R) read q block, compact layout
    bkt_kv_ids: Optional[torch.Tensor] = None    # (B, S) per-slot kv-block id
    bkt_kv_cnt: Optional[torch.Tensor] = None    # (B, R) bucket-clamped kv count
    # GEMM-O live-head buckets (None unless kv_buckets > 1): Cr row slots.
    gmo_rows: Optional[torch.Tensor] = None      # (B, Cr) write row id (dead -> T)
    gmo_src: Optional[torch.Tensor] = None       # (B, Cr) read row id (dead -> 0)
    gmo_head_ids: Optional[torch.Tensor] = None  # (B, S_o) per-slot head id
    gmo_head_cnt: Optional[torch.Tensor] = None  # (B, Cr) clamped live-head count
    # Seq-mesh partition (None unless mesh_sp > 1 with mesh_axis "seq"): P
    # indexes the destination shard; Cqs / Cks / pc are ShardGeometry's
    # per-shard row, union and per-pair capacities.
    shd_q_ids: Optional[torch.Tensor] = None       # (B,H,P,Cqs) shard-local q blocks
    shd_q_src: Optional[torch.Tensor] = None       # (B,H,P,Cqs) same, full layout
    shd_q_slots: Optional[torch.Tensor] = None     # (B,H,P,Cqs) same, compact layout
    shd_q_cnt: Optional[torch.Tensor] = None       # (B,H,P)
    shd_kv_ids: Optional[torch.Tensor] = None      # (B,H,P,Cks) union, global ids
    shd_kv_cnt: Optional[torch.Tensor] = None      # (B,H,P)
    shd_kv_row_ids: Optional[torch.Tensor] = None  # (B,H,P,Cqs,Ck) union-slot lists
    shd_kv_row_cnt: Optional[torch.Tensor] = None  # (B,H,P,Cqs)
    shd_gather_idx: Optional[torch.Tensor] = None  # (B,H,P,Cks) buffer placement
    shd_send_ids: Optional[torch.Tensor] = None    # (B,H,Psrc,Pdst,pc) local ids
    shd_send_cnt: Optional[torch.Tensor] = None    # (B,H,Psrc,Pdst)

    def widen(self) -> "DispatchPlan":
        """The plan with every int16 id field widened to contiguous int32;
        the plan itself when every id field is int32 already."""
        narrow = {f: t for f in (*_ID_FIELDS, *_SHD_IDS)
                  if (t := getattr(self, f)) is not None and t.dtype != torch.int32}
        if not narrow:
            return self
        return self._replace(**{f: t.to(torch.int32).contiguous()
                                for f, t in narrow.items()})


def build_dispatch_plan(m_c: torch.Tensor, m_s: torch.Tensor, cfg, n_tokens: int,
                        row_score=None, compact_ids: bool = True) -> DispatchPlan:
    """Derive the full index plan from compressed-granularity masks.

    ``m_c`` (B, H, T) / ``m_s`` (B, H, T, T) bool, True = compute.
    ``row_score`` (B, T) ranks rows for the capacity truncation; when
    ``None`` it falls back to the live-pair count per row.
    """
    spec = cfg.caps(n_tokens)
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
    # Seq-mesh fold: the per-(src, dst) shipped-block clamp applies to the
    # row masks before the lists are extracted, so every backend, sharded or
    # not, reads the same lists (the identity at pair_cap == kv_bps).
    geom = None
    if cfg.mesh_sp > 1 and cfg.mesh_axis == "seq":
        from repro_torch.distributed.plan_shard import mesh_keep_rows, shard_geometry
        geom = shard_geometry(spec, t_q, t_kv, cfg.mesh_sp, cfg.mesh_pair_slack)
        rows = mesh_keep_rows(rows, q_ids, q_cnt, geom)
    kv_row_ids, kv_row_cnt = active_indices(rows, spec.cap_kv)

    # Compact-layout remap: live q block i sits at block
    # slot(i // factor)·factor + i % factor of the compact GEMM-Q output.
    row_slot = slot_positions(row_ids, row_cnt, t_cmp)            # (B, T)
    slot_of = torch.gather(row_slot[:, None, :].expand(*q_ids.shape[:-1], t_cmp),
                           -1, (q_ids // factor).to(torch.int64))
    q_slots = slot_of * factor + q_ids % factor

    # Occupancy-bucketed attention layout: the sort runs here, at Update.
    bkt = {}
    if spec.kv_buckets > 1:
        b_, h_, _ = q_ids.shape
        geometry = bucket_geometry(spec.cap_q, spec.cap_kv, h_, spec.kv_buckets)
        score = torch.gather(row_score[:, None, :].expand(b_, h_, t_cmp), -1,
                             (q_ids // factor).to(torch.int64))
        bkt, kv_row_cnt = bucket_layout(q_ids, q_cnt, q_slots, kv_row_ids,
                                        kv_row_cnt, score, geometry, t_q)

    # The per-shard partition reads the final lists: every truncation (the
    # pair clamp, the bucket clamp) is in kv_row_cnt by now.
    shd = {}
    if geom is not None:
        from repro_torch.distributed.plan_shard import partition_plan
        shd = partition_plan(q_ids, q_cnt, q_slots, kv_row_ids, kv_row_cnt, t_kv, geom)

    # GEMM-O reduction sparsity over the kept rows; padding slots get empty
    # head lists (the kernel's output aliases the bias, so a padded
    # duplicate with live heads would re-accumulate its row).
    m_ch = m_c.transpose(-1, -2)                                   # (B, T, H)
    heads = m_ch.shape[-1]
    head_mask = torch.gather(m_ch, -2, row_ids.to(torch.int64)[..., None].expand(
        *row_ids.shape, heads))
    head_mask = head_mask & (slot < row_cnt[..., None])[..., None]
    head_ids, head_cnt = active_indices(head_mask, heads)

    # GEMM-O live-head buckets; the clamp folds back into head_cnt/head_mask.
    gmo = {}
    if spec.kv_buckets > 1:
        geometry_o = bucket_geometry(cap_rows, heads, 1, spec.kv_buckets)
        score_rows = torch.gather(row_score, -1, row_ids.to(torch.int64))
        gmo, head_cnt, head_mask = gmo_layout(row_ids, row_cnt, head_ids, head_cnt,
                                              score_rows, geometry_o, t_cmp)

    occ_hist = occupancy_histogram(kv_row_cnt, q_cnt, spec.cap_kv)

    if compact_ids and max(t_cmp, t_q + 1, t_kv, heads) < 2 ** 15:
        kv_row_ids, row_ids, q_ids, q_slots, kv_ids, head_ids = (
            a.to(torch.int16) for a in
            (kv_row_ids, row_ids, q_ids, q_slots, kv_ids, head_ids))
        bkt = {k: v.to(torch.int16) if k in _BKT_IDS else v for k, v in bkt.items()}
        gmo = {k: v.to(torch.int16) if k in _GMO_IDS else v for k, v in gmo.items()}
        # shd_gather_idx indexes the exchange buffer (buf_blocks > T_kv
        # entries), so the shd_* ids narrow under a gate of their own.
        if shd and geom.buf_blocks < 2 ** 15:
            shd = {k: v.to(torch.int16) if k in _SHD_IDS else v for k, v in shd.items()}

    plan = DispatchPlan(
        q_ids=q_ids, q_cnt=q_cnt, q_slots=q_slots,
        kv_ids=kv_ids, kv_cnt=kv_cnt, pair_live=pair_live,
        kv_row_ids=kv_row_ids, kv_row_cnt=kv_row_cnt,
        row_ids=row_ids, row_cnt=row_cnt,
        head_ids=head_ids, head_cnt=head_cnt, head_mask=head_mask,
        m_ch=m_ch, row_score=row_score, occ_hist=occ_hist, **bkt, **gmo, **shd)
    # Opt-in check (EngineConfig.validate_plans / REPRO_VALIDATE_PLANS=1):
    # the structural validator on the host, synchronously; raises
    # PlanInvariantError.  Off, nothing is copied and nothing waits.
    from repro_torch.analysis.plan_check import hook_validate, validation_enabled
    if validation_enabled(cfg):
        hook_validate(plan, cfg, n_tokens)
    return plan


def empty_plan_like(batch: int, heads: int, n_tokens: int, cfg,
                    device) -> DispatchPlan:
    """All-live plan matching the all-ones init symbols (warmup state)."""
    t = cfg.mask.n_blocks(n_tokens)
    m_c = torch.ones((batch, heads, t), dtype=torch.bool, device=device)
    m_s = torch.ones((batch, heads, t, t), dtype=torch.bool, device=device)
    return build_dispatch_plan(m_c, m_s, cfg, n_tokens)
