"""Plan-sharded mesh dispatch over ``torch.distributed``, port of
``repro.distributed.plan_shard``.

A 33K-token video DiT is where serving engines go multi-device, with
sequence parallelism.  Dense sequence parallelism all-gathers every remote
K/V block; the :class:`~repro_torch.core.plan.DispatchPlan` already knows
which KV blocks each row reads, so the exchange here ships **only the
plan-live blocks**, and its volume scales with density.

Mesh model
----------
A ``(data, seq)`` mesh of ranks (:func:`repro_torch.launch.mesh.make_engine_mesh`;
rank ``r`` sits at ``(d, s) = divmod(r, mesh_sp)``).  The batch shards over
``data``.  ``EngineConfig.mesh_axis`` picks what shards over ``seq``:

* ``"head"`` — heads.  Attention is independent per head: no exchange.
  Occupancy buckets fold the head axis into layout rows, so
  ``kv_buckets > 1`` is rejected.
* ``"seq"``  — tokens.  K/V and the attention output live block-contiguously
  on their owner shard; Q stays replicated (it is density-compacted
  already).  Everything below describes this mode.

The plan-aware exchange
-----------------------
Every table is computed at **Update** time inside
:func:`~repro_torch.core.plan.build_dispatch_plan` (:func:`mesh_keep_rows`,
:func:`partition_plan`) and carried in the plan's ``shd_*`` fields; a
Dispatch step reads them as-is.  Per (batch, head, destination shard p):

1. **Row partition** — live q blocks belong to shard ``q_id // q_bps``;
   ``shd_q_ids``/``shd_q_src``/``shd_q_slots``/``shd_q_cnt`` list shard p's
   live rows in its local, the full and the compact layout.
2. **Union and pair clamp** — the union of the rows' KV lists, split by
   owner shard, forms ascending runs.  Each remote run is capped at
   ``pair_cap = ⌈slack · cap_kv / P⌉`` (``EngineConfig.mesh_pair_slack``);
   the blocks the fewest rows need go first, and the clamp is **folded back
   into** ``kv_row_ids``/``kv_row_cnt`` before the bucket layout runs, so
   the single-device run reads the same lists and the sharded output is
   bit-identical to it.  The local run never ships and is never clamped.
3. **Send tables** — ``shd_send_ids[s, p]``: the ascending local blocks
   shard s sends to shard p.  One ``all_to_all_single`` of ``(P, pair_cap)``
   blocks each for K and V moves every pair's run.
4. **Receive placement** — ``shd_gather_idx`` maps each union slot to its
   block in ``cat([local blocks, a2a payload])``; the gathered union plus
   one zero block is the shard's KV buffer, and ``shd_kv_row_ids`` are the
   rows' lists remapped to buffer slots in their order, so each row
   accumulates the same blocks in the same order as on one device.

The payload is ``P · pair_cap`` blocks per shard for K and for V, against
``T_kv`` for a dense all-gather (:func:`exchange_blocks`,
:func:`dense_exchange_blocks`).

Where the port differs: the reference leaves the sharded attention output
to GSPMD.  Here GEMM-Q and GEMM-O run replicated on every rank, so
:func:`mesh_attention` **all-gathers the attention output** over the mesh
back to ``(B, H, N, dh)``: one collective more than the reference's
``shard_map`` body (seq mode: two all-to-alls and this all-gather; head
mode: the all-gather alone).

The exchange is **redundant** in this port: ``dispatch_layer`` projects K/V
for every token on every rank, so the all-to-alls deliver blocks the
receiver already holds.  They are kept because they are the reference's
traffic and build the buffer its parity contract is stated on; they carry
new data only once each rank projects K/V for its own tokens alone.  That
row-sliced projection is not bit-identical to one device's on the H100
(a flux layer at mesh (2, 4), the projection and its RMS norm run on an
eighth of the rows), so it waits (ROADMAP A.8).  The integer tables are host-independent
torch ops and match the reference exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.symbols import active_indices, clamp_mask_topk, slot_positions

__all__ = [
    "ShardGeometry",
    "shard_geometry",
    "mesh_keep_rows",
    "partition_plan",
    "exchange_blocks",
    "dense_exchange_blocks",
    "mesh_attention",
    "head_plan",
    "seq_plan",
]

_I32 = torch.int32


class ShardGeometry(NamedTuple):
    """Static shapes of the per-shard partition (a function of the spec)."""

    mesh_sp: int    # P: shards on the seq axis
    q_bps: int      # q blocks per shard (T_q / P)
    kv_bps: int     # kv blocks per shard (T_kv / P)
    cap_q: int      # per-shard live-row capacity, min(cap_q, q_bps)
    cap_kv: int     # per-shard KV-union capacity, kv_bps + (P - 1) * pair_cap
    pair_cap: int   # per-(src, dst) shipped-block capacity

    @property
    def buf_blocks(self) -> int:
        """KV buffer blocks per shard: the local slice and the whole payload."""
        return self.kv_bps + self.mesh_sp * self.pair_cap


def shard_geometry(spec, t_q: int, t_kv: int, mesh_sp: int,
                   pair_slack: float = 1.5) -> ShardGeometry:
    """The static partition geometry; raises on grids the mesh does not divide."""
    if mesh_sp < 1:
        raise ValueError(f"mesh_sp must be >= 1, got {mesh_sp}")
    if t_q % mesh_sp or t_kv % mesh_sp:
        raise ValueError(
            f"seq mesh needs the block grid divisible by the shard count: "
            f"T_q={t_q}, T_kv={t_kv}, mesh_sp={mesh_sp}")
    q_bps = t_q // mesh_sp
    kv_bps = t_kv // mesh_sp
    # pair_cap scales with cap_kv (about density x T_kv), which is where the
    # exchange's volume scales with sparsity; kv_bps never truncates.
    pair_cap = min(kv_bps, max(1, math.ceil(pair_slack * spec.cap_kv / mesh_sp)))
    # With slack >= 1 the union admits every row list, so the pair clamp is
    # the only truncation the mesh adds.
    cap_kv = min(t_kv, kv_bps + (mesh_sp - 1) * pair_cap)
    return ShardGeometry(mesh_sp=mesh_sp, q_bps=q_bps, kv_bps=kv_bps,
                         cap_q=min(spec.cap_q, q_bps), cap_kv=cap_kv, pair_cap=pair_cap)


def exchange_blocks(geom: ShardGeometry) -> int:
    """All-to-all payload blocks received per shard (K or V), the unused
    self slot included: it pads the payload on the wire."""
    return geom.mesh_sp * geom.pair_cap


def dense_exchange_blocks(t_kv: int) -> int:
    """The dense baseline: all-gather result blocks per shard (K or V)."""
    return t_kv


def _owner(ids: torch.Tensor, blocks_per_shard: int, mesh_sp: int) -> torch.Tensor:
    return torch.clamp(ids // blocks_per_shard, 0, mesh_sp - 1)


def _slot_valid(cnt: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.arange(cap, dtype=_I32, device=cnt.device) < cnt[..., None]


def _per_owner(own: torch.Tensor, valid: torch.Tensor, mesh_sp: int) -> torch.Tensor:
    """(..., C) owners -> (..., C, P) int32 one-hot; invalid slots (owner P)
    give a zero row, as the reference's one-hot of an out-of-range class."""
    idx = torch.where(valid, own, mesh_sp).to(torch.int64)
    hot = torch.zeros((*own.shape, mesh_sp + 1), dtype=_I32, device=own.device)
    return hot.scatter_(-1, idx[..., None], 1)[..., :mesh_sp]


def mesh_keep_rows(rows: torch.Tensor, q_ids: torch.Tensor, q_cnt: torch.Tensor,
                   geom: ShardGeometry) -> torch.Tensor:
    """Fold the per-(dst, src) ``pair_cap`` clamp back into the row masks.

    ``rows``: (B, H, Cq, T_kv) bool per-live-row block mask (padding slots
    repeat the last live row).  For every destination shard each remote
    source slice of its KV union keeps at most ``pair_cap`` blocks, those
    the most rows need (ties: the lower block).  The clamp applies to the
    ROWS, so every backend, sharded or not, reads the folded lists.  At
    ``pair_cap == kv_bps`` it is the identity."""
    p_ = geom.mesh_sp
    b_, h_, cq, t_kv = rows.shape
    own = _owner(q_ids, geom.q_bps, p_)                              # (B,H,Cq)
    dest = torch.where(_slot_valid(q_cnt, cq), own, p_).to(torch.int64)
    need = torch.zeros((b_, h_, p_ + 1, t_kv), dtype=_I32, device=rows.device)
    need.scatter_add_(2, dest[..., None].expand(b_, h_, cq, t_kv), rows.to(_I32))
    need = need[:, :, :p_]                                           # (B,H,P,T_kv)
    um_r = (need > 0).reshape(b_, h_, p_, p_, geom.kv_bps)           # (..,Pd,Ps,kbps)
    keep_r = clamp_mask_topk(um_r, need.reshape(um_r.shape).to(torch.float32),
                             geom.pair_cap)
    # The local slice never ships: it is exempt from the pair clamp.
    eye = torch.eye(p_, dtype=torch.bool, device=rows.device)[:, :, None]
    keep = torch.where(eye, um_r, keep_r).reshape(b_, h_, p_, t_kv)
    keep_q = torch.gather(keep, 2, own.to(torch.int64)[..., None].expand(b_, h_, cq, t_kv))
    return rows & keep_q


def partition_plan(q_ids: torch.Tensor, q_cnt: torch.Tensor, q_slots: torch.Tensor,
                   kv_row_ids: torch.Tensor, kv_row_cnt: torch.Tensor, t_kv: int,
                   geom: ShardGeometry) -> dict:
    """The per-shard CSR partition and exchange tables (the ``shd_*`` fields).

    Inputs are the plan's final attention index fields, after
    :func:`mesh_keep_rows` and the bucket layout folded their truncations
    into ``kv_row_cnt``: every pair run is within ``pair_cap`` already and
    nothing here truncates.  Every field is int32."""
    p_ = geom.mesh_sp
    b_, h_, cq = q_ids.shape
    ck0 = kv_row_ids.shape[-1]
    dev = q_ids.device
    shards = torch.arange(p_, dtype=_I32, device=dev)
    own = _owner(q_ids, geom.q_bps, p_)
    # --- row partition: shard p's live rows, in global slot order ---
    pmask = (own[..., None, :] == shards[:, None]) \
        & _slot_valid(q_cnt, cq)[..., None, :]                       # (B,H,P,Cq)
    sel, shd_q_cnt = active_indices(pmask, geom.cap_q)               # (B,H,P,Cqs)
    sel = sel.to(torch.int64)
    gsel = lambda a: torch.gather(a[..., None, :].expand(b_, h_, p_, cq), -1, sel)
    shd_q_src = gsel(q_ids).to(_I32)
    shd_q_slots = gsel(q_slots).to(_I32)
    shd_q_ids = torch.clamp(shd_q_src - shards[:, None] * geom.q_bps, 0, geom.q_bps - 1)
    rl = torch.gather(kv_row_ids[..., None, :, :].expand(b_, h_, p_, cq, ck0), -2,
                      sel[..., None].expand(b_, h_, p_, geom.cap_q, ck0))  # (B,H,P,Cqs,Ck0)
    rc = gsel(kv_row_cnt).to(_I32)                                   # (B,H,P,Cqs)
    # --- per-shard KV union (membership scatter; ascending ids) ---
    jlive = _slot_valid(rc, ck0) & _slot_valid(shd_q_cnt, geom.cap_q)[..., None]
    ids_m = torch.where(jlive, rl, t_kv).reshape(b_, h_, p_, -1).to(torch.int64)
    um = torch.zeros((b_, h_, p_, t_kv + 1), dtype=torch.bool,
                     device=dev).scatter_(-1, ids_m, True)[..., :t_kv]
    shd_kv_ids, shd_kv_cnt = active_indices(um, geom.cap_kv)         # (B,H,P,Cks)
    # --- row lists remapped to union-buffer slots (order-preserving) ---
    slot_of = slot_positions(shd_kv_ids, shd_kv_cnt, t_kv)           # (B,H,P,T_kv)
    shd_kv_row_ids = torch.gather(slot_of, -1, rl.reshape(b_, h_, p_, -1).to(torch.int64)
                                  ).reshape(rl.shape)
    # --- receive placement: union slot -> cat([local, a2a payload]) ---
    sown = _owner(shd_kv_ids, geom.kv_bps, p_)                       # (B,H,P,Cks)
    cnt_src = _per_owner(sown, _slot_valid(shd_kv_cnt, geom.cap_kv), p_).sum(-2)
    starts = torch.cumsum(cnt_src, -1, dtype=_I32) - cnt_src         # exclusive
    pos = torch.arange(geom.cap_kv, dtype=_I32, device=dev) \
        - torch.gather(starts, -1, sown.to(torch.int64))             # run position
    pself = shards[:, None]
    shd_gather_idx = torch.clamp(
        torch.where(sown == pself, shd_kv_ids - pself * geom.kv_bps,
                    geom.kv_bps + sown * geom.pair_cap + pos),
        0, geom.buf_blocks - 1)
    # --- send tables: ascending local ids per (src, dst) pair run ---
    um_r = um.reshape(b_, h_, p_, p_, geom.kv_bps) \
        & ~torch.eye(p_, dtype=torch.bool, device=dev)[:, :, None]   # no self-ship
    send_ids_d, send_cnt_d = active_indices(um_r, geom.pair_cap)
    out = dict(
        shd_q_ids=shd_q_ids, shd_q_src=shd_q_src, shd_q_slots=shd_q_slots,
        shd_q_cnt=shd_q_cnt, shd_kv_ids=shd_kv_ids, shd_kv_cnt=shd_kv_cnt,
        shd_kv_row_ids=shd_kv_row_ids, shd_kv_row_cnt=rc,
        shd_gather_idx=shd_gather_idx,
        shd_send_ids=send_ids_d.transpose(2, 3),                     # (B,H,Psrc,Pdst,pc)
        shd_send_cnt=send_cnt_d.transpose(2, 3))
    return {k: v.to(_I32).contiguous() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Dispatch: sharded attention across the engine mesh's ranks.
# ---------------------------------------------------------------------------

def _dummy_plan_tail(b_l: int, device) -> dict:
    """GEMM-side plan fields the attention backends never read."""
    z = lambda *s, dt=_I32: torch.zeros(s, dtype=dt, device=device)
    return dict(row_ids=z(b_l, 1), row_cnt=z(b_l), head_ids=z(b_l, 1, 1),
                head_cnt=z(b_l, 1), head_mask=z(b_l, 1, 1, dt=torch.bool),
                m_ch=z(b_l, 1, 1, dt=torch.bool), row_score=z(b_l, 1, dt=torch.float32),
                occ_hist=z(b_l, 1))


def _gather_out(out_l: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's (b_l, ...) attention output, in rank order: (W·b_l, ...)."""
    full = out_l.new_empty((mesh.dp * mesh.sp * out_l.shape[0], *out_l.shape[1:]))
    _all_gather(full, out_l.contiguous(), group=mesh.world)
    return full


# all_gather_single is the newer name of all_gather_into_tensor.
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def mesh_attention(inner, cfg, q, k, v, o_reuse, plan, spec, *,
                   scale: Optional[float] = None,
                   compact_q: bool = False) -> torch.Tensor:
    """Sparse attention across the ``(data, seq)`` mesh; every rank returns
    the whole ``(B, H, N, dh)`` output.

    ``inner`` is the single-device backend (kernels or the twin): the same
    per-row CSR path runs on each shard over its gathered KV buffer, with
    the row lists at their single-device width, which keeps the sharded
    output bit-identical to one device's.  Each rank takes its batch share
    and its token share of K/V/``o_reuse``, sends the plan-live blocks
    (one ``all_to_all_single`` for K, one for V; redundant while K/V are
    projected whole on every rank, see the module docstring), attends, and
    the outputs are all-gathered over the mesh (GEMM-O runs replicated)."""
    from repro_torch.core.attention import SparseAttentionSpec
    from repro_torch.core.plan import DispatchPlan
    from repro_torch.launch.mesh import make_engine_mesh

    plan = plan.widen()
    b, h, _, dh = q.shape
    n = o_reuse.shape[-2]
    if b % cfg.mesh_dp:
        raise ValueError(f"batch {b} not divisible by mesh_dp={cfg.mesh_dp}")
    if cfg.mesh_axis == "head":
        return _head_sharded(inner, cfg, q, k, v, o_reuse, plan, spec,
                             scale=scale, compact_q=compact_q)
    if plan.shd_q_ids is None:
        raise ValueError("seq-mode mesh dispatch needs a plan built with "
                         "mesh_sp > 1 (shd_* fields missing)")
    mesh = make_engine_mesh(cfg.mesh_dp, cfg.mesh_sp)
    p_, bk = cfg.mesh_sp, spec.block_kv
    b_l, n_l = b // cfg.mesh_dp, n // p_
    kv_bps = n_l // bk
    pair_cap = plan.shd_send_ids.shape[-1]
    ck_s = plan.shd_kv_ids.shape[-1]
    cq_s = plan.shd_q_ids.shape[-1]
    ck0 = plan.shd_kv_row_ids.shape[-1]
    # cap_kv keeps the row lists' single-device width ck0, so the per-row
    # math has the single-device shapes.  Zero blocks pad the buffer past
    # ck0 (one, as in the reference, when the slack is >= 1; more where a
    # slack below 1 makes the union narrower than the lists), so the twin
    # always takes its per-row branch.
    inner_spec = SparseAttentionSpec(block_q=spec.block_q, block_kv=bk, cap_q=cq_s,
                                     cap_kv=ck0, kv_buckets=1)
    bs = slice(mesh.d * b_l, (mesh.d + 1) * b_l)
    ts = slice(mesh.s * n_l, (mesh.s + 1) * n_l)
    mine = lambda a: a[bs, :, mesh.s]                     # this shard's plan rows
    send = mine(plan.shd_send_ids).reshape(b_l, h, p_ * pair_cap).long()
    gidx = mine(plan.shd_gather_idx).long()
    n_pad = max(1, ck0 + 1 - ck_s)
    pad = q.new_zeros((b_l, h, n_pad, bk, dh))

    def gather(blocks, ids):                              # (b_l,h,T,bk,dh), (b_l,h,C)
        return torch.gather(blocks, 2, ids[..., None, None].expand(*ids.shape, bk, dh))

    def buffer(x):
        blocks = x[bs, :, ts].reshape(b_l, h, kv_bps, bk, dh)
        payload = gather(blocks, send).reshape(b_l, h, p_, pair_cap, bk, dh)
        sent = payload.permute(2, 0, 1, 3, 4, 5).contiguous()      # by destination
        got = torch.empty_like(sent)
        dist.all_to_all_single(got, sent, group=mesh.seq)          # by source
        recv = got.permute(1, 2, 0, 3, 4, 5).reshape(b_l, h, p_ * pair_cap, bk, dh)
        union = gather(torch.cat([blocks, recv], dim=2), gidx)
        return torch.cat([union, pad], dim=2).reshape(b_l, h, (ck_s + n_pad) * bk, dh)

    kx, vx = buffer(k), buffer(v)
    pv = DispatchPlan(
        q_ids=mine(plan.shd_q_ids), q_cnt=mine(plan.shd_q_cnt),
        q_slots=mine(plan.shd_q_slots if compact_q else plan.shd_q_src),
        kv_ids=q.new_zeros((b_l, h, 1), dtype=_I32),
        kv_cnt=q.new_zeros((b_l, h), dtype=_I32),
        pair_live=q.new_zeros((b_l, h, cq_s, 1), dtype=torch.bool),
        kv_row_ids=mine(plan.shd_kv_row_ids), kv_row_cnt=mine(plan.shd_kv_row_cnt),
        **_dummy_plan_tail(b_l, q.device))
    # compact_q=True always: the read layout (full or compact) is in q_slots
    # above, while q_ids are the shard-local output blocks.
    out_l = inner.attention(q[bs], kx, vx, o_reuse[bs, :, ts].contiguous(), pv, inner_spec,
                            scale=scale, compact_q=True)           # (b_l, h, n_l, dh)
    full = _gather_out(out_l, mesh).reshape(cfg.mesh_dp, p_, b_l, h, n_l, dh)
    return full.permute(0, 2, 3, 1, 4, 5).reshape(b, h, n, dh)


# The plan fields B2 reads, each indexed (B, H, ...).
_HEAD_FIELDS = ("q_ids", "q_cnt", "q_slots", "kv_ids", "kv_cnt", "pair_live", "kv_row_ids",
                "kv_row_cnt")


def head_plan(plan, heads: slice, batch: slice = slice(None)):
    """The attention's share of ``plan`` at ``batch`` and ``heads``: B2's
    head-indexed fields narrowed (contiguous), the GEMM-side fields
    placeholders the attention backends never read, and no bucketed or
    seq-mesh field (the bucketed layout rows fold the heads, so a head
    share runs the uniform layout)."""
    from repro_torch.core.plan import DispatchPlan
    mine = lambda a: a[batch, heads].contiguous()
    b_l = plan.q_ids[batch].shape[0]
    return DispatchPlan(**{f: mine(getattr(plan, f)) for f in _HEAD_FIELDS},
                        **_dummy_plan_tail(b_l, plan.q_ids.device))


def _run_of(ids: torch.Tensor, cnt: torch.Tensor, lo: int, hi: int):
    """``(start, count)``: where the live ids in ``[lo, hi)`` begin in the
    ascending lists ``ids`` (..., C) of ``cnt`` live entries, and how many
    there are (a count, no search)."""
    live = torch.arange(ids.shape[-1], device=ids.device) < cnt[..., None]
    start = ((ids < lo) & live).sum(dim=-1)
    return start, (((ids < hi) & live).sum(dim=-1) - start).to(_I32)


def _take(a: torch.Tensor, start: torch.Tensor, width: int) -> torch.Tensor:
    """``a[..., start + j, ...]`` for ``j < width`` along dim ``start.ndim``
    (``start`` indexes the leading dims of ``a``), clamped to the last entry."""
    d = start.ndim
    idx = (start[..., None] + torch.arange(width, device=a.device)).clamp_(max=a.shape[d] - 1)
    idx = idx.reshape(*idx.shape, *([1] * (a.ndim - d - 1))).expand(
        *a.shape[:d], width, *a.shape[d + 1:])
    return torch.gather(a, d, idx)


def seq_plan(plan, rows: tuple[int, int], factor: int):
    """The share of ``plan`` (ids widened) of the pool rows ``[r0, r1)``,
    renumbered to them, for a rank that computes only those rows of the
    sequence (a DiT step's ``sp`` shard, :class:`~repro_torch.distributed.
    tensor_parallel._SeqShare`): every field a Dispatch stage reads, at
    static capacities ``min(Cr, r1 - r0)`` and ``min(Cq, (r1 - r0) · factor)``
    (``factor`` q blocks a pool row).

    The rank's live rows are a contiguous run of the ascending ``row_ids``
    and its live q blocks one of each ``q_ids`` list, so this counts and
    slices only (no sort, top-k or unpack): GEMM-Q's rows and GEMM-O's
    ``row_ids``/``head_ids``/``head_cnt``/``head_mask`` from the run's first
    slot, the compact ``q_slots`` renumbered from it; B2's ``q_ids`` (local
    q blocks), ``q_cnt``, ``q_slots`` and the query side of
    ``kv_row_ids``/``kv_row_cnt``/``pair_live``, whose KV ids stay global
    (the rank's queries attend over the whole K/V); ``m_ch`` at its rows.
    Slots past a run's count never store (``head_cnt`` 0).  No bucketed or
    seq-mesh field: a sequence shard runs the uniform B2/B3, whose lists
    carry the bucket clamp."""
    from repro_torch.core.plan import DispatchPlan
    r0, r1 = rows
    nr = r1 - r0
    c0, cnt = _run_of(plan.row_ids, plan.row_cnt, r0, r1)
    cr = min(plan.row_ids.shape[-1], nr)
    slot_live = torch.arange(cr, device=cnt.device) < cnt[:, None]                    # (B, cr)
    row_ids = (_take(plan.row_ids, c0, cr) - r0).clamp_(0, max(nr - 1, 0))
    head_cnt = torch.where(slot_live, _take(plan.head_cnt, c0, cr), 0)
    head_mask = _take(plan.head_mask, c0, cr) & slot_live[..., None]
    s0, q_cnt = _run_of(plan.q_ids, plan.q_cnt, r0 * factor, r1 * factor)
    cq = min(plan.q_ids.shape[-1], nr * factor)
    q_live = torch.arange(cq, device=cnt.device) < q_cnt[..., None]                 # (B, H, cq)
    q_ids = (_take(plan.q_ids, s0, cq) - r0 * factor).clamp_(0, max(nr * factor - 1, 0))
    q_slots = (_take(plan.q_slots, s0, cq) - c0[:, None, None] * factor).clamp_(
        0, max(cr * factor - 1, 0)).to(_I32)
    return DispatchPlan(
        q_ids=q_ids, q_cnt=q_cnt, q_slots=q_slots, kv_ids=plan.kv_ids, kv_cnt=plan.kv_cnt,
        pair_live=_take(plan.pair_live, s0, cq) & q_live[..., None],
        kv_row_ids=_take(plan.kv_row_ids, s0, cq),
        kv_row_cnt=torch.where(q_live, _take(plan.kv_row_cnt, s0, cq), 0),
        row_ids=row_ids, row_cnt=cnt, head_ids=_take(plan.head_ids, c0, cr),
        head_cnt=head_cnt, head_mask=head_mask, m_ch=plan.m_ch[:, r0:r1],
        row_score=plan.row_score[:, r0:r1], occ_hist=plan.occ_hist)


def _head_sharded(inner, cfg, q, k, v, o_reuse, plan, spec, *, scale, compact_q):
    """Head-parallel mode: heads shard over ``seq``; nothing is exchanged
    before attention, and the outputs are all-gathered after it."""
    from repro_torch.launch.mesh import make_engine_mesh

    b, h = q.shape[:2]
    if h % cfg.mesh_sp:
        raise ValueError(f"heads {h} not divisible by mesh_sp={cfg.mesh_sp}")
    if spec.kv_buckets > 1:
        raise ValueError("mesh_axis='head' cannot shard the bucketed layout "
                         "(bucket rows fold the head axis); use mesh_axis="
                         "'seq' or kv_buckets=1")
    mesh = make_engine_mesh(cfg.mesh_dp, cfg.mesh_sp)
    b_l, h_l = b // cfg.mesh_dp, h // cfg.mesh_sp
    bs = slice(mesh.d * b_l, (mesh.d + 1) * b_l)
    hs = slice(mesh.s * h_l, (mesh.s + 1) * h_l)
    mine = lambda a: a[bs, hs].contiguous()
    pv = head_plan(plan, hs, bs)
    out_l = inner.attention(mine(q), mine(k), mine(v), mine(o_reuse), pv, spec,
                            scale=scale, compact_q=compact_q)      # (b_l, h_l, n, dh)
    full = _gather_out(out_l, mesh).reshape(cfg.mesh_dp, cfg.mesh_sp, b_l, h_l,
                                            *out_l.shape[2:])
    return full.permute(0, 2, 1, 3, 4, 5).reshape(b, h, *out_l.shape[2:])
