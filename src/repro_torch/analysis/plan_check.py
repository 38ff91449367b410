"""Structural validator for :class:`repro_torch.core.plan.DispatchPlan`,
port of ``repro.analysis.plan_check``.

A host-side (NumPy) checker over any concrete plan: torch tensors on any
device (copied to the host once) or NumPy leaves.  One entry point,
:func:`check_plan`, returns a list of human-readable violation strings
(empty = the plan is well-formed); :func:`validate_plan` raises
:class:`PlanInvariantError` on a non-empty result.  The strings are the
reference's, word for word.

On the card these checks guard more than on the TPU: the Hopper kernels
read K/V blocks, rows and heads at the ids the plan hands them and no
kernel bounds-checks an id, so an id past ``T`` is an out-of-bounds global
read.

Checked invariant families:

* **CSR well-formedness** — every count within its static capacity, every
  id list in range with a strictly ascending live prefix (the
  ``active_indices`` contract: padding slots repeat the last live id),
  GEMM-O padding rows with EMPTY head lists (``head_cnt == 0`` and an
  all-False ``head_mask``: the kernel's output starts as the bias and a
  padded duplicate would add its row twice), and ``head_cnt`` ≡
  ``head_mask`` row sums.
* **Shared-truncation fold-back** — the uniform per-row CSR lists are the
  single source of truth: the ``bkt_*`` and ``gmo_*`` layouts (and the
  mesh's ``shd_*``, when a plan carries them) must re-derive from the SAME
  truncated ``kv_row_cnt``/``head_cnt``.  The checker maps each layout row
  back to its (head, slot) origin and compares counts and id prefixes.
* **``occ_hist`` consistency** — recomputed from the final counts by an
  independent NumPy implementation and compared bit-exactly.
* **``widen()`` completeness** — no int16 leaf may survive ``widen()``.

Plans may carry extra leading axes (layer stacking ``(L, ...)``, serving
lanes ``(W, L, ...)``): every check flattens them into the batch axis.
The ``shd_*`` block runs only when a plan has those fields (a plan built
under a seq mesh, ``EngineConfig.mesh_sp > 1``).

Live hook: ``EngineConfig.validate_plans=True`` or ``REPRO_VALIDATE_PLANS=1``
makes ``build_dispatch_plan`` call :func:`hook_validate` on the host after
every plan build (synchronously: it copies the plan to the host, so it
waits for the card).  Off, it costs nothing.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

__all__ = ["PlanInvariantError", "check_plan", "validate_plan", "hook_validate",
           "validation_enabled"]


class PlanInvariantError(AssertionError):
    """A DispatchPlan violated a structural invariant."""


def validation_enabled(cfg) -> bool:
    """The live-hook gate: config flag OR environment opt-in."""
    if getattr(cfg, "validate_plans", False):
        return True
    return os.environ.get("REPRO_VALIDATE_PLANS", "0") not in ("", "0")


# Trailing (core) rank of every DispatchPlan field; leading axes beyond
# it are lane/layer stacking and get flattened into batch.
_CORE_RANK = {
    "q_ids": 3, "q_cnt": 2, "q_slots": 3, "kv_ids": 3, "kv_cnt": 2,
    "pair_live": 4, "kv_row_ids": 4, "kv_row_cnt": 3,
    "row_ids": 2, "row_cnt": 1, "head_ids": 3, "head_cnt": 2,
    "head_mask": 3, "m_ch": 3, "row_score": 2, "occ_hist": 2,
    "bkt_head": 2, "bkt_q_ids": 2, "bkt_q_src": 2, "bkt_q_slots": 2,
    "bkt_kv_ids": 2, "bkt_kv_cnt": 2,
    "gmo_rows": 2, "gmo_src": 2, "gmo_head_ids": 2, "gmo_head_cnt": 2,
    "shd_q_ids": 4, "shd_q_src": 4, "shd_q_slots": 4, "shd_q_cnt": 3,
    "shd_kv_ids": 4, "shd_kv_cnt": 3, "shd_kv_row_ids": 5,
    "shd_kv_row_cnt": 4, "shd_gather_idx": 4, "shd_send_ids": 5,
    "shd_send_cnt": 4,
}


class _Canon:
    """NumPy view of a plan with extra leading axes folded into batch; a
    field the plan does not have reads as None."""

    def __init__(self, plan):
        self.extra = np.asarray(plan.q_cnt).ndim - _CORE_RANK["q_cnt"]
        self._plan = plan

    def __getattr__(self, name):
        val = getattr(self._plan, name, None)
        if val is None:
            return None
        arr = np.asarray(val)
        core = _CORE_RANK[name]
        want = core + self.extra
        if arr.ndim != want:
            raise PlanInvariantError(
                f"plan.{name}: rank {arr.ndim} != expected {want} "
                f"(core {core} + {self.extra} stacked axes)")
        if core == 0:
            return arr.reshape(-1)[0]
        return arr.reshape(-1, *arr.shape[arr.ndim - core + 1:])


def _prefix_valid(ids: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """(..., C) bool: slot index < count."""
    c = ids.shape[-1]
    return np.arange(c) < cnt[..., None]


def _check_id_list(out: List[str], name: str, ids, cnt, hi: int,
                   ascending: bool = True) -> None:
    """Range + ascending-prefix checks shared by every CSR list."""
    if (cnt < 0).any() or (cnt > ids.shape[-1]).any():
        out.append(f"{name}: count outside [0, {ids.shape[-1]}] "
                   f"(max {int(cnt.max())})")
    if (ids < 0).any() or (ids >= hi).any():
        out.append(f"{name}: id outside [0, {hi}) "
                   f"(range [{int(ids.min())}, {int(ids.max())}])")
        return
    if ascending and ids.shape[-1] > 1:
        valid = _prefix_valid(ids, cnt)
        both = valid[..., 1:] & valid[..., :-1]
        if (both & (ids[..., 1:] <= ids[..., :-1])).any():
            out.append(f"{name}: live prefix not strictly ascending")


def _membership(ids, cnt, hi: int) -> np.ndarray:
    """(..., hi) bool table of the live prefix of an id list."""
    sent = np.where(_prefix_valid(ids, cnt), ids, hi)
    table = np.zeros((*ids.shape[:-1], hi + 1), bool)
    np.put_along_axis(table, sent, True, axis=-1)
    return table[..., :hi]


def _slot_of(ids, cnt, hi: int) -> np.ndarray:
    """(..., hi) int: live id -> its slot in the list, -1 elsewhere."""
    c = ids.shape[-1]
    valid = _prefix_valid(ids, cnt)
    sent = np.where(valid, ids, hi)
    pos = np.full((*ids.shape[:-1], hi + 1), -1, np.int64)
    np.put_along_axis(
        pos, sent, np.where(valid, np.arange(c), -1), axis=-1)
    return pos[..., :hi]


def _occ_hist_np(kv_row_cnt, q_cnt, cap_kv: int) -> np.ndarray:
    """NumPy recompute of :func:`repro_torch.core.plan.occupancy_histogram`:
    an independent implementation (the recompute-and-compare check would be
    vacuous against itself)."""
    from repro_torch.core.plan import OCC_BINS
    live = (np.arange(kv_row_cnt.shape[-1], dtype=np.int32)
            < q_cnt[..., None])
    ths = np.asarray([-(-cap_kv // (1 << (i + 1)))
                      for i in range(OCC_BINS - 1)], np.int32)
    cls = np.sum(kv_row_cnt[..., None] <= ths, axis=-1)
    onehot = (cls[..., None] == np.arange(OCC_BINS, dtype=cls.dtype)) \
        & live[..., None]
    return np.sum(onehot, axis=(1, 2)).astype(np.int32)


def _host(plan):
    """The plan with every leaf a CPU tensor: one copy of each device
    tensor, a view of each NumPy array."""
    def leaf(v):
        if v is None or isinstance(v, torch.Tensor):
            return None if v is None else v.detach().cpu()
        return torch.from_numpy(np.ascontiguousarray(v))
    return plan._replace(**{f: leaf(v) for f, v in zip(plan._fields, plan)})


def check_plan(plan, cfg, n_tokens: int) -> List[str]:
    """Return every invariant violation in ``plan`` (empty = valid)."""
    from repro_torch.core.plan import bucket_geometry, bucket_slot_layout

    plan = _host(plan)
    out: List[str] = []
    m = cfg.mask
    spec = cfg.caps(n_tokens)
    t_cmp = m.n_blocks(n_tokens)
    t_q = -(-n_tokens // m.block_q)
    t_kv = -(-n_tokens // m.block_kv)
    factor = m.pool // m.block_q

    # --- widen() completeness: no int16 survives, and it is idempotent ---
    wide = plan.widen()
    for fname, leaf in zip(wide._fields, wide):
        if leaf is not None and leaf.dtype == torch.int16:
            out.append(f"widen(): field {fname!r} stayed int16 — add it to "
                       f"DispatchPlan.widen()'s _replace call")
    p = _Canon(wide._replace(**{f: None if v is None else v.numpy()
                                for f, v in zip(wide._fields, wide)}))

    heads = p.m_ch.shape[-1]

    # --- CSR well-formedness --------------------------------------------
    _check_id_list(out, "q_ids", p.q_ids, p.q_cnt, t_q)
    _check_id_list(out, "kv_ids", p.kv_ids, p.kv_cnt, t_kv)
    _check_id_list(out, "row_ids", p.row_ids, p.row_cnt, t_cmp)
    _check_id_list(out, "kv_row_ids", p.kv_row_ids, p.kv_row_cnt, t_kv)
    _check_id_list(out, "head_ids", p.head_ids, p.head_cnt, heads)
    if (p.kv_row_cnt > p.kv_row_ids.shape[-1]).any():
        out.append("kv_row_cnt exceeds the per-row CSR capacity")
    # q blocks live only inside live (kept) pool rows
    rows_live = _membership(p.row_ids, p.row_cnt, t_cmp)
    qrow = np.clip(p.q_ids // factor, 0, t_cmp - 1)
    qv = _prefix_valid(p.q_ids, p.q_cnt)
    hit = np.take_along_axis(
        np.broadcast_to(rows_live[:, None, :], (*p.q_ids.shape[:-1], t_cmp)),
        qrow, axis=-1)
    if (qv & ~hit).any():
        out.append("q_ids: live q block outside the kept row set "
                   "(capacity truncation not applied before extraction)")
    # Per-row CSR lists subset of the per-(b, h) KV union, scoped the way
    # the engine consumes them: only rows holding a live q block are read,
    # and only when the union clamp was a no-op (kv_cnt below capacity);
    # under truncation the per-row lists run INSTEAD of the union.
    union = _membership(p.kv_ids, p.kv_cnt, t_kv)          # (B*, H, t_kv)
    rv = _prefix_valid(p.kv_row_ids, p.kv_row_cnt)
    rids = np.clip(p.kv_row_ids, 0, t_kv - 1)
    in_union = np.take_along_axis(
        np.broadcast_to(union[:, :, None, :],
                        (*p.kv_row_ids.shape[:-1], t_kv)), rids, axis=-1)
    n_rows = p.kv_row_ids.shape[-2]
    row_used = np.zeros((*qrow.shape[:-1], n_rows + 1), bool)
    np.put_along_axis(row_used, np.where(qv, np.clip(qrow, 0, n_rows), n_rows),
                      True, axis=-1)
    no_trunc = p.kv_cnt < p.kv_ids.shape[-1]               # clamp was a no-op
    if (rv & ~in_union & row_used[..., :n_rows, None]
            & no_trunc[..., None, None]).any():
        out.append("kv_row_ids: live row's list escapes the untruncated "
                   "KV union")
    del union, rv, rids, in_union
    # GEMM-O padding-slot convention + head_cnt/head_mask agreement
    row_pad = ~_prefix_valid(p.row_ids, p.row_cnt)
    if (p.head_cnt[row_pad] != 0).any():
        out.append("head_cnt: padding row slot with a non-empty head list "
                   "(bias-aliased GEMM-O would re-accumulate it)")
    if p.head_mask[row_pad].any():
        out.append("head_mask: padding row slot with live heads")
    if (p.head_cnt != p.head_mask.sum(-1)).any():
        out.append("head_cnt != head_mask row sums (fold-back missed one "
                   "of the two GEMM-O views)")

    # --- occ_hist: recompute from the final counts ----------------------
    if p.occ_hist is not None:
        want = _occ_hist_np(p.kv_row_cnt, p.q_cnt, spec.cap_kv)
        if p.occ_hist.shape != want.shape or (p.occ_hist != want).any():
            out.append("occ_hist inconsistent with the truncation-folded "
                       "kv_row_cnt/q_cnt (histogram computed before a "
                       "later clamp?)")

    # --- bkt_* fold-back ------------------------------------------------
    if p.bkt_head is not None:
        cq, ck = p.q_ids.shape[-1], p.kv_row_ids.shape[-1]
        geom = bucket_geometry(cq, spec.cap_kv, heads, spec.kv_buckets)
        w_pos = np.concatenate(
            [np.full(r, w, np.int32) for r, w in geom])    # (R,)
        srow, jof, _, _ = bucket_slot_layout(geom)
        live = p.bkt_q_ids < t_q                           # (B*, R)
        if (~live & (p.bkt_kv_cnt != 0)).any():
            out.append("bkt_kv_cnt: dead layout row with live KV slots")
        if (p.bkt_kv_cnt > w_pos).any():
            out.append("bkt_kv_cnt exceeds its bucket width (truncation "
                       "not applied at layout build)")
        slot_q = _slot_of(p.q_ids, p.q_cnt, t_q)           # (B*, H, t_q)
        bi = np.arange(live.shape[0])[:, None]
        s = slot_q[bi, p.bkt_head, np.clip(p.bkt_q_ids, 0, t_q - 1)]
        if (live & (s < 0)).any():
            out.append("bkt layout row maps to no live (head, q-slot) "
                       "origin — bkt_head/bkt_q_ids inconsistent with "
                       "q_ids/q_cnt")
        else:
            sc = np.clip(s, 0, cq - 1)
            back = p.kv_row_cnt[bi, p.bkt_head, sc]
            if (live & (back != p.bkt_kv_cnt)).any():
                out.append("shared-truncation fold-back violated: "
                           "bkt_kv_cnt != kv_row_cnt at the layout row's "
                           "origin (bucket clamp not folded back)")
            # id prefixes agree slot-for-slot with the uniform CSR lists;
            # each slot reads its own id (no (slot, Ck) intermediate, which
            # at 33K tokens would not fit the host)
            want_ids = p.kv_row_ids[bi, p.bkt_head[:, srow], sc[:, srow],
                                    np.minimum(jof, ck - 1)[None, :]]
            jvalid = (jof < p.bkt_kv_cnt[:, srow]) & live[:, srow]
            if (jvalid & (p.bkt_kv_ids != want_ids)).any():
                out.append("bkt_kv_ids prefix diverges from kv_row_ids — "
                           "bucketed and uniform kernels would reduce "
                           "different KV lists")

    # --- gmo_* fold-back ------------------------------------------------
    if p.gmo_rows is not None:
        cr = p.row_ids.shape[-1]
        geom_o = bucket_geometry(cr, heads, 1, spec.kv_buckets)
        w_pos = np.concatenate([np.full(r, w, np.int32) for r, w in geom_o])
        srow, jof, _, _ = bucket_slot_layout(geom_o)
        live = p.gmo_rows < t_cmp
        if (~live & (p.gmo_head_cnt != 0)).any():
            out.append("gmo_head_cnt: dead layout row with live heads")
        if (p.gmo_head_cnt > w_pos).any():
            out.append("gmo_head_cnt exceeds its bucket width")
        slot_r = _slot_of(p.row_ids, p.row_cnt, t_cmp)
        bi = np.arange(live.shape[0])[:, None]
        s = slot_r[bi, np.clip(p.gmo_rows, 0, t_cmp - 1)]
        if (live & (s < 0)).any():
            out.append("gmo layout row maps to no live compact row slot")
        else:
            sc = np.clip(s, 0, cr - 1)
            if (live & (p.head_cnt[bi, sc] != p.gmo_head_cnt)).any():
                out.append("shared-truncation fold-back violated: "
                           "gmo_head_cnt != head_cnt at the layout row's "
                           "origin (head clamp not folded back)")
            jvalid = (jof < p.gmo_head_cnt[:, srow]) & live[:, srow]
            want_ids = p.head_ids[bi, sc[:, srow],
                                  np.minimum(jof, heads - 1)[None, :]]
            if (jvalid & (p.gmo_head_ids != want_ids)).any():
                out.append("gmo_head_ids prefix diverges from head_ids")

    # --- shd_* partition (mesh dispatch, when the plan has it) -----------
    if p.shd_q_ids is not None:
        from repro_torch.distributed.plan_shard import shard_geometry
        g = shard_geometry(spec, t_q, t_kv, getattr(cfg, "mesh_sp", 1),
                           getattr(cfg, "mesh_pair_slack", 1.5))
        g_cap_q, g_cap_kv, pair_cap, buf_blocks = g.cap_q, g.cap_kv, g.pair_cap, g.buf_blocks
        if (p.shd_q_cnt > g_cap_q).any():
            out.append("shd_q_cnt exceeds the per-shard row capacity")
        if (p.shd_kv_cnt > g_cap_kv).any():
            out.append("shd_kv_cnt exceeds the per-shard union capacity")
        if (p.shd_send_cnt > pair_cap).any():
            out.append("shd_send_cnt exceeds pair_cap (the collective "
                       "payload would overflow its run)")
        if (p.shd_gather_idx < 0).any() \
                or (p.shd_gather_idx >= buf_blocks).any():
            out.append("shd_gather_idx outside the KV exchange buffer")
        if (p.shd_q_cnt.sum(-1) != p.q_cnt).any():
            out.append("per-shard row partition does not cover q_cnt "
                       "exactly (rows lost or duplicated across shards)")
        # fold-back: per-shard row counts gather the SAME truncated counts
        slot_q = _slot_of(p.q_ids, p.q_cnt, t_q)           # (B*, H, t_q)
        bsz, h_ = p.shd_q_cnt.shape[:2]
        bi = np.arange(bsz)[:, None, None, None]
        hi_ = np.arange(h_)[None, :, None, None]
        sv = _prefix_valid(p.shd_q_src, p.shd_q_cnt)
        s = slot_q[bi, hi_, np.clip(p.shd_q_src, 0, t_q - 1)]
        if (sv & (s < 0)).any():
            out.append("shd_q_src names a q block absent from the live "
                       "q_ids prefix")
        else:
            back = p.kv_row_cnt[bi, hi_,
                                np.clip(s, 0, p.q_ids.shape[-1] - 1)]
            if (sv & (back != p.shd_kv_row_cnt)).any():
                out.append("shared-truncation fold-back violated: "
                           "shd_kv_row_cnt != kv_row_cnt at the shard "
                           "row's origin (partition re-truncated)")
        # remapped row lists index the per-shard union (only live row
        # slots count: a dead shard's gathered rows are masked padding)
        jv = _prefix_valid(p.shd_kv_row_ids, p.shd_kv_row_cnt) \
            & sv[..., None]
        if (jv & ((p.shd_kv_row_ids < 0)
                  | (p.shd_kv_row_ids
                     >= p.shd_kv_cnt[..., None, None]))).any():
            out.append("shd_kv_row_ids: union-slot index outside the "
                       "per-shard union prefix")

    return out


def validate_plan(plan, cfg, n_tokens: int) -> None:
    """Raise :class:`PlanInvariantError` listing every violation."""
    bad = check_plan(plan, cfg, n_tokens)
    if bad:
        raise PlanInvariantError(
            "DispatchPlan invariant violation(s):\n  - "
            + "\n  - ".join(bad))


def hook_validate(plan, cfg, n_tokens: int) -> None:
    """The check ``build_dispatch_plan`` runs after a build when
    :func:`validation_enabled`; raises on any violation.
    ``hook_validate.calls`` counts the plans it checked."""
    hook_validate.calls += 1
    validate_plan(plan, cfg, n_tokens)


hook_validate.calls = 0
