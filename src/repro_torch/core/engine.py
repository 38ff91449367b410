"""FlashOmni Update–Dispatch engine (paper §3.2, Fig. 4), port of
``repro.core.engine``.

  * :func:`update_layer` — full attention; refresh the symbols ``S_c``/``S_s``
    through the strategy registry, the TaylorSeer stack and the GEMM-O bias,
    and build the :class:`~repro_torch.core.plan.DispatchPlan` the next
    Dispatch steps read as-is.
  * :func:`dispatch_layer` — GEMM-Q → CSR attention → GEMM-O through the
    kernel backend over the frozen plan; no unpack, top-k or sort work.

Cache modes: ``"bias"`` caches the GEMM-O bias ``B_c`` in output space
(paper-optimised); ``"o_cache"`` caches per-head attention outputs.  Engine
states are plain tensors updated out of place, so one initial state may be
shared by every layer.  ``kv_buckets`` picks the Dispatch layout: 1 the
uniform CSR grid, 2 or 3 the occupancy-bucketed one, 0 the bucket count the
calibration table predicts for ``strategy`` (:func:`repro_torch.kernels.
tuning.select_kv_buckets`).  ``EngineConfig.backend`` picks the Dispatch
backend: ``"kernels"`` (the Hopper kernels) or ``"torch"`` (the structural
twin), see :mod:`repro_torch.core.backend`.  :func:`refresh_symbols` keeps
the seed §3.3 rule as the oracle of the ``flashomni`` strategy.

Lane states (batched serving): the continuous batcher holds one request
per lane, and a lane's state is the port's state of one request, a list of
:class:`LayerState` per layer with batch-leading tensors.  The lane-stacked
form is a list over lanes of such lists: lanes differ in their Python-int
``k_since`` and ``taylor.n_updates`` counters, which one LayerState cannot
carry per sample.  :func:`gather_lane_states` folds lanes into the batch
axis (a copy) for one ``denoise_step``, :func:`scatter_lane_states` splits
the result back into lanes of their own tensors; :func:`stack_lane_states`,
:func:`merge_lane_states` and :func:`set_lane_state` are the reference's
host-side lane operations.  The reference's ``schedule_cache_stats`` has no
counterpart: :func:`resolve_schedule` keeps no memo, since the port compiles
nothing per schedule.  ``freqs=`` (a :func:`rope_freqs` table) rotates Q and
K with :func:`apply_rope` after their RMSNorm, at Update before the dense
attention and the symbols, at Dispatch before the kernels; the compact
GEMM-Q rows take the phases of their original token positions.  These are
the engine's RoPE, apart from ``models.layers.rope_table``/``apply_rope`` of
the LM families.  ``mesh_dp``/``mesh_sp`` > 1 runs Dispatch attention across a
``(data, seq)`` mesh of ``torch.distributed`` ranks
(:mod:`repro_torch.distributed.plan_shard`): with ``mesh_axis="seq"`` the
plan carries the per-shard partition (``shd_*``) and only plan-live K/V
blocks are exchanged, with ``"head"`` heads shard and nothing is exchanged.

**A split ``model`` row** (a sharded step's tensor-parallel context,
:mod:`repro_torch.distributed.tensor_parallel`): when ``AttnParams`` holds
a rank's columns of ``wq``/``wk``/``wv`` and rows of ``wo`` (its share of
the ``heads`` split as ``torch.tensor_split`` splits them, ``h`` from
``h0`` on: ``H/m`` from ``rank · H/m`` where the row divides them), both
phases compute that rank's heads.  Update: the dense attention and the
strategy on the rank's heads (``StrategyContext.head_lo = h0``), the
output partial and the GEMM-O bias partial summed over the row in one
collective, then ``m_c``, ``m_s`` and ``q_scores`` gathered over the row
(one collective), so every rank packs the same symbols and builds the same
plan from all heads; the TaylorSeer stack takes the summed bias
(``"bias"``) or the gathered output (``"o_cache"``).  Dispatch: B1 on the
rank's ``wq`` columns (its rows are the plan's, the same on every head), B2
on the rank's heads over the plan's head-indexed fields narrowed to them
(:func:`~repro_torch.distributed.plan_shard.head_plan`; the uniform layout,
as bucketed layout rows fold the heads), B3 over the head range
``[h0, h0 + h)`` of the whole plan's lists, with the forecast bias passed
on rank 0 of the row and zeros elsewhere, and the partials summed over the
row in f32.

**A sequence shard** (a DiT step that splits its sequence over ``sp``,
:func:`~repro_torch.distributed.tensor_parallel.seq_share`): ``x`` holds
the rank's own pool rows, and so do the outputs and the TaylorSeer stack.
Update projects Q/K/V on those rows, all-gathers K and V over the group
for the rank's queries' dense attention and Q for the strategy, so every
rank packs the same symbols and builds the same plan over the whole
sequence; the GEMM-O bias is the rank's rows'.  Dispatch runs B1-B3 on the
rank's share of the frozen plan
(:func:`~repro_torch.distributed.plan_shard.seq_plan`, the uniform
layout), B2 over the all-gathered K/V.  Both splits may act at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import masks as masklib
from repro_torch.core import sparse_gemm, taylorseer
from repro_torch.core.attention import SparseAttentionSpec, dense_attention
from repro_torch.core.backend import get_backend
from repro_torch.core.masks import MaskConfig
from repro_torch.core.plan import DispatchPlan, build_dispatch_plan, empty_plan_like
from repro_torch.core.strategy import SparsityStrategy, StrategyContext, get_strategy
from repro_torch.core.symbols import (capacity_for, clamp_mask_topk, pack_bits, packed_len,
                                      unpack_bits)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.tuning import select_kv_buckets
from repro_torch.models.layers import rms_norm

__all__ = [
    "EngineConfig",
    "AttnParams",
    "LayerState",
    "DispatchPlan",
    "init_layer_state",
    "is_update_step",
    "plan_from_state",
    "resolve_schedule",
    "stack_lane_states",
    "gather_lane_states",
    "scatter_lane_states",
    "merge_lane_states",
    "set_lane_state",
    "refresh_symbols",
    "rope_freqs",
    "apply_rope",
    "update_layer",
    "dispatch_layer",
    "rms_norm",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration = paper tuple (τ_q, τ_kv, 𝒩, 𝒟, S_q) + statics."""

    mask: MaskConfig = MaskConfig()
    cache_mode: str = "bias"            # "bias" | "o_cache"
    cap_q_frac: float = 0.75            # static live-Q capacity fraction
    cap_kv_frac: float = 0.9            # static KV capacity fraction
    use_gemm_q: bool = True
    use_gemm_o: bool = True
    cache_dtype: torch.dtype = torch.bfloat16
    backend: str = "kernels"           # "kernels" | "torch" (the structural twin)
    kv_buckets: int = 1                 # 1 uniform, 2/3 bucketed, 0 auto
    strategy: str = "flashomni"
    schedule: Optional[str] = None      # named SparsitySchedule preset
    validate_plans: bool = False        # check every built plan on the host
                                        # (analysis/plan_check.py); or set
                                        # REPRO_VALIDATE_PLANS=1
    # Plan-sharded mesh dispatch (distributed/plan_shard.py); mesh_sp > 1
    # routes attention across the (data, seq) mesh of torch.distributed ranks.
    mesh_dp: int = 1                    # data-parallel shards (batch axis)
    mesh_sp: int = 1                    # sequence- or head-parallel shards
    mesh_axis: str = "seq"              # "seq" (token shards, live-block
                                        # exchange) | "head" (no exchange)
    mesh_pair_slack: float = 1.5        # per-(src, dst) shipped-block capacity
                                        # over cap_kv / mesh_sp (>= 1 keeps the
                                        # per-shard union clamp a no-op)

    def __post_init__(self):
        if self.kv_buckets not in (0, 1, 2, 3):
            raise ValueError(f"kv_buckets must be 0 (auto), 1, 2 or 3, "
                             f"not {self.kv_buckets!r}")
        if self.mesh_dp < 1 or self.mesh_sp < 1:
            raise ValueError(f"mesh ({self.mesh_dp}, {self.mesh_sp}) needs both "
                             "axes >= 1")
        if self.mesh_axis not in ("seq", "head"):
            raise ValueError(f"mesh_axis must be 'seq' or 'head', not {self.mesh_axis!r}")
        if not self.mesh_pair_slack > 0:
            raise ValueError(f"mesh_pair_slack must be > 0, not {self.mesh_pair_slack!r}")

    def cap_q_cmp(self, n_tokens: int) -> int:
        return capacity_for(self.mask.n_blocks(n_tokens), self.cap_q_frac, quantum=1)

    def cap_kv_cmp(self, n_kv: int) -> int:
        return capacity_for(self.mask.n_blocks(n_kv), self.cap_kv_frac, quantum=1)

    def resolved_kv_buckets(self) -> int:
        """``kv_buckets`` with 0 ("auto") resolved from the calibration table's
        occupancy histogram for ``strategy``: a function of the static config
        alone, fixed before any plan is built.  Under a mesh auto is 1: the
        seq-sharded inner spec runs uniform per shard and the head mesh
        rejects buckets."""
        if self.kv_buckets != 0:
            return self.kv_buckets
        if self.mesh_sp > 1:
            return 1
        return select_kv_buckets(self.strategy)

    def caps(self, n_tokens: int, n_kv: Optional[int] = None) -> SparseAttentionSpec:
        """Block-granularity capacities (exact multiples of the compressed ones)."""
        n_kv = n_tokens if n_kv is None else n_kv
        m = self.mask
        t_q = -(-n_tokens // m.block_q)
        t_kv = -(-n_kv // m.block_kv)
        fq, fk = m.pool // m.block_q, m.pool // m.block_kv
        return SparseAttentionSpec(
            block_q=m.block_q, block_kv=m.block_kv,
            cap_q=min(self.cap_q_cmp(n_tokens) * fq, t_q),
            cap_kv=min(self.cap_kv_cmp(n_kv) * fk, t_kv),
            kv_buckets=self.resolved_kv_buckets())


class AttnParams(NamedTuple):
    """Weights of one attention module (MMDiT joint-attention style)."""

    wq: torch.Tensor         # (dm, H*dh)
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor         # (H*dh, dm)
    q_scale: torch.Tensor    # (dh,) RMSNorm scales
    k_scale: torch.Tensor


class LayerState(NamedTuple):
    """Per-layer engine state carried across denoising steps."""

    s_c: torch.Tensor                  # (B, H, cmp_bytes) uint8 caching symbol
    s_s: torch.Tensor                  # (B, H, flat_bytes) uint8 skipping symbol
    taylor: taylorseer.TaylorState     # over B_c (bias) or Õ (o_cache)
    k_since: int                       # Dispatch offset since the last Update
    plan: DispatchPlan


def init_layer_state(batch: int, heads: int, n_tokens: int, d_model: int,
                     head_dim: int, cfg: EngineConfig, device) -> LayerState:
    t = cfg.mask.n_blocks(n_tokens)
    if cfg.cache_mode == "bias":
        feat = (batch, n_tokens, d_model)
    else:
        feat = (batch, heads, n_tokens, head_dim)
    return LayerState(
        s_c=torch.full((batch, heads, packed_len(t)), 255, dtype=torch.uint8, device=device),
        s_s=torch.full((batch, heads, packed_len(t * t)), 255, dtype=torch.uint8,
                       device=device),
        taylor=taylorseer.init_state(feat, cfg.mask.order, cfg.cache_dtype, device),
        k_since=0,
        plan=empty_plan_like(batch, heads, n_tokens, cfg, device))


def _fold(parts: list[LayerState]) -> LayerState:
    """Several requests' states of one layer as one batch (a copy)."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    counters = {(p.k_since, p.taylor.n_updates) for p in parts}
    if len(counters) != 1:
        raise ValueError(f"lanes with different (k_since, n_updates) {sorted(counters)} "
                         "cannot share a batch")
    cat = lambda name, obj: (None if getattr(obj(first), name) is None else
                             torch.cat([getattr(obj(p), name) for p in parts]))
    plan = DispatchPlan(**{f: cat(f, lambda p: p.plan) for f in DispatchPlan._fields})
    derivs = torch.cat([p.taylor.derivs for p in parts], dim=1)      # (order+1, B, ...)
    return LayerState(s_c=cat("s_c", lambda p: p), s_s=cat("s_s", lambda p: p),
                      taylor=taylorseer.TaylorState(derivs, first.taylor.n_updates),
                      k_since=first.k_since, plan=plan)


def _split(state: LayerState, n: int) -> list[LayerState]:
    """``n`` equal batch shares of one layer's state, each its own copy."""
    part = lambda t, dim=0: (None if t is None else
                             [c.clone() for c in t.chunk(n, dim=dim)])
    plan = {f: part(getattr(state.plan, f)) for f in DispatchPlan._fields}
    s_c, s_s, derivs = part(state.s_c), part(state.s_s), part(state.taylor.derivs, 1)
    return [LayerState(s_c=s_c[j], s_s=s_s[j],
                       taylor=taylorseer.TaylorState(derivs[j], state.taylor.n_updates),
                       k_since=state.k_since,
                       plan=DispatchPlan(**{f: None if v is None else v[j]
                                            for f, v in plan.items()}))
            for j in range(n)]


def stack_lane_states(states: list[LayerState], n_lanes: int) -> list[list[LayerState]]:
    """One request's per-layer states as the state of ``n_lanes`` lanes.  The
    lanes share the tensors: states are replaced, never updated in place."""
    return [list(states) for _ in range(n_lanes)]


def gather_lane_states(stacked: list[list[LayerState]], lane_ids) -> list[LayerState]:
    """Lanes ``lane_ids`` folded into the batch axis, in that order: per
    layer, every tensor is the lanes' tensors concatenated on the batch dim
    (a copy; one lane is returned as its own list).  The lanes must agree on
    every shape but the batch and on each layer's ``k_since`` and
    ``taylor.n_updates``."""
    lanes = [stacked[int(w)] for w in lane_ids]
    return [_fold([lane[li] for lane in lanes]) for li in range(len(lanes[0]))]


def scatter_lane_states(stacked: list[list[LayerState]], lane_ids,
                        values: list[LayerState]) -> list[list[LayerState]]:
    """``stacked`` with lanes ``lane_ids`` replaced by equal batch shares of
    the folded ``values``, in that order, each share its own tensors (not a
    view of the fold, so nothing can alias across lanes).  ``values`` is
    consumed: each layer's entry is released once it is split, so a fold and
    its split coexist one layer at a time.  Other lanes keep their state."""
    ids = [int(w) for w in lane_ids]
    per_lane = [[] for _ in ids]
    for li in range(len(values)):
        shares = [values[li]] if len(ids) == 1 else _split(values[li], len(ids))
        values[li] = None
        for j, share in enumerate(shares):
            per_lane[j].append(share)
    out = list(stacked)
    for w, lane in zip(ids, per_lane):
        out[w] = lane
    return out


def merge_lane_states(old: list, new: list, lane_mask) -> list:
    """Per-lane select: lanes where ``lane_mask`` is True take ``new``'s
    state, the others keep ``old``'s.
    Kept for parity with the reference; nothing in the port calls it."""
    return [n if bool(m) else o for o, n, m in zip(old, new, lane_mask)]


def set_lane_state(stacked: list, lane: int, fresh: list[LayerState]) -> list:
    """``stacked`` with lane ``lane`` replaced by ``fresh`` (a lane refill)."""
    out = list(stacked)
    out[int(lane)] = list(fresh)
    return out


def is_update_step(step: int, cfg: EngineConfig) -> bool:
    """Update/Dispatch phase of one step (warmup + every ``interval``)."""
    m = cfg.mask
    if step < m.warmup_steps:
        return True
    return (step - m.warmup_steps) % m.interval == 0


def resolve_schedule(cfg: EngineConfig, num_steps: int, n_layers: int, *,
                     schedule=None, layer_strategies=None, force_dense: bool = False):
    """The (step × layer) :class:`~repro_torch.core.schedule.SparsitySchedule`
    of a run: ``force_dense`` (every step dense, the baseline) wins over
    ``schedule`` (a preset name or a prebuilt schedule), which wins over
    ``layer_strategies``, which wins over ``cfg.schedule`` / ``cfg.strategy``.
    No memo: the port compiles nothing per schedule."""
    from repro_torch.core.schedule import SparsitySchedule, get_schedule
    if schedule is not None and not force_dense:
        return get_schedule(schedule, cfg, num_steps, n_layers)
    return SparsitySchedule.from_config(cfg, num_steps, n_layers,
                                        layer_strategies=layer_strategies,
                                        force_dense=force_dense)


def refresh_symbols(q: torch.Tensor, k: torch.Tensor, cfg: EngineConfig, n_text: int,
                    n_tokens: int):
    """The seed §3.3 rule, kept as the oracle of the ``flashomni`` strategy:
    ``(s_c, s_s, m_c, m_s)``, packed uint8 symbols and the compressed-
    granularity masks (True = compute) after the capacity clamps.
    Kept for parity with the reference; nothing in the port calls it."""
    m = cfg.mask
    m_c = masklib.apply_degradation(masklib.make_caching_mask(q, k, m, n_text), m.degrade)
    # Static-capacity clamp on live blocks, ranked by total column mass.
    p_map = masklib.compressed_attention_map(q, k, m.pool)
    m_c = clamp_mask_topk(m_c, p_map.sum(dim=-2), cfg.cap_q_cmp(n_tokens))
    m_s = masklib.make_skip_mask(q, k, m, n_text)
    cap_kv = cfg.cap_kv_cmp(n_tokens)
    if cap_kv < m_s.shape[-1]:
        m_s = clamp_mask_topk(m_s, p_map, cap_kv)
    return pack_bits(m_c), pack_bits(m_s.reshape(*m_s.shape[:-2], -1)), m_c, m_s


def _unpack(state: LayerState, cfg: EngineConfig, n_tokens: int):
    t = cfg.mask.n_blocks(n_tokens)
    m_c = unpack_bits(state.s_c, t)
    m_s = unpack_bits(state.s_s, t * t).reshape(*state.s_s.shape[:-1], t, t)
    return m_c, m_s


def plan_from_state(state: LayerState, cfg: EngineConfig, n_tokens: int) -> DispatchPlan:
    """Rebuild the DispatchPlan from the packed symbols; the stored
    ``row_score`` re-ranks the truncations, so the rebuilt plan equals the
    frozen one field for field."""
    m_c, m_s = _unpack(state, cfg, n_tokens)
    return build_dispatch_plan(m_c, m_s, cfg, n_tokens, row_score=state.plan.row_score)


def _project_heads(x: torch.Tensor, w: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, dm) @ (dm, H*dh) -> (B, H, N, dh) (a transposed view)."""
    b, n = x.shape[:2]
    return (x @ w).reshape(b, n, heads, w.shape[-1] // heads).transpose(1, 2)


def rope_freqs(n: int, dim: int, theta: float = 10000.0, *, device="cuda") -> torch.Tensor:
    """The (n, dim//2) float32 table of rotation angles ``t · theta^(-2i/dim)``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    return torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (..., N, dh), freqs broadcastable to (..., N, dh//2): rotates the two
    halves of the last axis (not interleaved pairs) in float32 and returns a
    fresh contiguous tensor in ``x``'s dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_positions(row_ids: torch.Tensor, pool: int, n_pos: int) -> torch.Tensor:
    """(B, Cr) row-block ids -> (B, Cr·pool) int64 token positions of the
    compact GEMM-Q rows.  Computed in int64, so the int16 ids of a plan past
    32 767 tokens do not overflow; positions past the table's ``n_pos`` rows
    (the tail of a partial block) clamp to its last, as the reference's
    gather does."""
    pos = row_ids.long()[..., :, None] * pool + torch.arange(pool, device=row_ids.device)
    return pos.reshape(row_ids.shape[0], -1).clamp_(max=n_pos - 1)


def _heads_of(params: AttnParams, heads: int) -> tuple[int, int]:
    """``(h0, h)``: the first of the heads ``params`` holds and their count,
    ``(0, heads)`` unless it holds a rank's share of a split model row
    (:func:`~repro_torch.distributed.tensor_parallel.head_share`: the row's
    heads split as ``torch.tensor_split`` splits them, unevenly where the
    row does not divide them)."""
    h = params.wq.shape[-1] // params.q_scale.shape[-1]
    if h == heads:
        return 0, heads
    share = tp.head_share(heads)
    if share is None or share[1] != h:
        raise ValueError(f"the attention weights hold {h} of {heads} heads on a model row of "
                         f"{tp.size()}")
    return share


def _gather_masks(syms, t: int, heads: int):
    """``(m_c, m_s, q_scores)`` of every head of the row from this rank's
    (one collective: the masks travel as exact 0/1 floats)."""
    b, h = syms.m_c.shape[:2]
    flat = torch.cat([syms.m_c.to(torch.float32), syms.m_s.reshape(b, h, t * t).to(torch.float32),
                      syms.q_scores.to(torch.float32)], dim=-1)
    flat = tp.all_gather(flat, 1, tp.head_sizes(heads))
    return (flat[..., :t] > 0.5, flat[..., t:t + t * t].reshape(b, -1, t, t) > 0.5,
            flat[..., t + t * t:].to(syms.q_scores.dtype))


def _qk(params: AttnParams, x: torch.Tensor, heads: int,
        freqs: Optional[torch.Tensor] = None):
    q = rms_norm(_project_heads(x, params.wq, heads), params.q_scale)
    k = rms_norm(_project_heads(x, params.wk, heads), params.k_scale)
    if freqs is not None:
        q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    return q, k


def _seq_of(freqs: Optional[torch.Tensor]):
    """The active sequence split (``None`` outside one) and ``freqs`` at
    this rank's tokens."""
    share = tp.seq_share()
    if share is None or freqs is None:
        return share, freqs
    lo, hi = share.mine
    return share, freqs[lo:hi]


def update_layer(params: AttnParams, x: torch.Tensor, state: LayerState,
                 cfg: EngineConfig, *, n_text: int = 0, heads: int,
                 freqs: Optional[torch.Tensor] = None,
                 strategy: Optional[str | SparsityStrategy] = None,
                 layer_idx: Optional[int] = None, step_idx: Optional[int] = None,
                 num_steps: Optional[int] = None) -> tuple[torch.Tensor, LayerState]:
    """Full attention + symbol/cache refresh (paper *Update* phase).

    ``strategy`` (a registry name or object) overrides ``cfg.strategy``; the
    schedule passes each layer's entry of its strategy table here.  With
    ``freqs`` the symbols and the plan come from the rotated Q/K."""
    share, freqs_x = _seq_of(freqs)
    n = x.shape[1] if share is None else share.n
    dm = x.shape[-1]
    h0, h = _heads_of(params, heads)
    split = h != heads
    q, k = _qk(params, x, h, freqs_x)
    v = _project_heads(x, params.wv, h)
    q_all = q
    if share is not None:
        # The rank's query rows attend over the whole K/V; the strategy
        # reads the whole Q and K, so every rank builds the same symbols.
        q_all, k, v = share.gather(q, 2), share.gather(k, 2), share.gather(v, 2)
    o = dense_attention(q, k, v)                                   # (B,H,N,dh)
    ctx = StrategyContext(cfg=cfg, n_text=n_text, n_tokens=n, layer_idx=layer_idx,
                          step_idx=step_idx, num_steps=num_steps, head_lo=h0)
    syms = get_strategy(cfg.strategy if strategy is None else strategy).emit(q_all, k, ctx)
    del q_all, k, v

    o_tok = o.transpose(1, 2)                                      # (B,N,H,dh)
    wo_h = params.wo.reshape(h, -1, dm)
    out = torch.einsum("bnhd,hdf->bnf", o_tok, wo_h)
    bias = None
    if cfg.cache_mode == "bias":
        m_ch = syms.m_c.transpose(-1, -2)
        if share is not None:
            m_ch = m_ch[:, share.my_rows[0]:share.my_rows[1]]
        bias = sparse_gemm.gemm_o_update_bias(o_tok, wo_h, m_ch, block=cfg.mask.pool)
    m_c, m_s, q_scores = syms.m_c, syms.m_s, syms.q_scores
    if split:
        if bias is None:
            out = tp.reduce(out)
            o = tp.all_gather(o, 1, tp.head_sizes(heads))
        else:
            out, bias = tp.reduce(torch.stack([out, bias.to(out.dtype)])).unbind(0)
        m_c, m_s, q_scores = _gather_masks(syms, m_c.shape[-1], heads)
        s_c, s_s = pack_bits(m_c), pack_bits(m_s.reshape(*m_s.shape[:-2], -1))
    else:
        s_c, s_s = syms.s_c, syms.s_s
    if bias is not None:
        taylor = taylorseer.update(state.taylor, bias.to(cfg.cache_dtype))
    else:
        taylor = taylorseer.update(state.taylor, o.to(cfg.cache_dtype))
    # Rows are ranked for the plan's capacity truncation by the strategy's
    # clamp scores, summed over the heads where the row is live.
    row_score = torch.where(m_c, q_scores.to(torch.float32), 0.0).sum(dim=-2)
    plan = build_dispatch_plan(m_c, m_s, cfg, n, row_score=row_score)
    return out, LayerState(s_c=s_c, s_s=s_s, taylor=taylor, k_since=0, plan=plan)


def dispatch_layer(params: AttnParams, x: torch.Tensor, state: LayerState,
                   cfg: EngineConfig, *, n_text: int = 0, heads: int,
                   freqs: Optional[torch.Tensor] = None,
                   plan: Optional[DispatchPlan] = None) -> tuple[torch.Tensor, LayerState]:
    """Sparse execution over the frozen DispatchPlan (paper *Dispatch*).

    ``plan`` overrides the stored plan.  ``n_text`` is accepted for call
    symmetry with :func:`update_layer`; the plan already encodes it.
    ``freqs`` (N, dh//2) rotates Q and K before the attention; compact
    GEMM-Q rows are rotated at the positions of the row blocks they hold."""
    b, n_loc, dm = x.shape
    m = cfg.mask
    plan_stored = state.plan if plan is None else plan
    plan = plan_stored.widen()                 # int16 id fields -> int32 for kernels/RoPE
    backend = get_backend(cfg)
    k_since = state.k_since + 1
    share, freqs_x = _seq_of(freqs)
    n = n_loc if share is None else share.n
    spec_c = cfg.caps(n)
    h0, h = _heads_of(params, heads)
    split = h != heads
    row0 = 0
    if share is not None:
        # The rank's pool rows of the frozen plan, renumbered (count and
        # slice only); the KV lists stay global.
        from repro_torch.distributed.plan_shard import seq_plan
        row0 = share.my_rows[0]
        plan = seq_plan(plan, share.my_rows, m.pool // m.block_q)
    run = n_loc > 0                            # a rank with no rows launches nothing

    # --- GEMM-Q: skip row blocks cached in every head (Obs. 2). ---
    if cfg.use_gemm_q and run:
        q_flat = backend.gemm_q(x, params.wq, plan, block=m.pool)  # (B, Cr·pool, H·dh)
        compact = backend.compact_q
    else:
        q_flat = x @ params.wq
        compact = False
    n_q = q_flat.shape[1]
    qh = rms_norm(q_flat.reshape(b, n_q, h, params.q_scale.shape[-1]).transpose(1, 2),
                  params.q_scale)
    k_h = rms_norm(_project_heads(x, params.wk, h), params.k_scale)
    if freqs is not None:
        # The phases of compact rows are gathered as the rows were, and
        # broadcast over the heads: (B, 1, Cr·pool, dh/2).
        q_freqs = (freqs[rope_positions(plan.row_ids + row0, m.pool, len(freqs))][:, None]
                   if compact else freqs_x)
        qh, k_h = apply_rope(qh, q_freqs), apply_rope(k_h, freqs_x)
    v_h = _project_heads(x, params.wv, h)
    if share is not None:
        k_h, v_h = share.gather(k_h, 2), share.gather(v_h, 2)

    # --- Attention over the frozen plan (a split row: the rank's heads). ---
    dh = qh.shape[-1]
    taylor = state.taylor
    if split:
        from repro_torch.distributed.plan_shard import head_plan
        attn_plan = head_plan(plan, slice(h0, h0 + h))
        if cfg.cache_mode != "bias":
            taylor = taylorseer.TaylorState(taylor.derivs[:, :, h0:h0 + h], taylor.n_updates)
    else:
        attn_plan = plan
    if cfg.cache_mode == "bias":
        o_reuse = torch.zeros((b, h, n_loc, dh), dtype=qh.dtype, device=x.device)
    else:
        o_reuse = taylorseer.forecast(taylor, k_since, m.interval).to(qh.dtype)
    o = (backend.attention(qh, k_h, v_h, o_reuse, attn_plan, spec_c, compact_q=compact)
         if run else o_reuse)
    del k_h, v_h

    # --- GEMM-O: live heads + forecast bias (Obs. 3, Eq. 4). ---
    o_tok = o.transpose(1, 2)
    wo_h = params.wo.reshape(h, dh, dm)
    if cfg.cache_mode == "bias":
        if split and tp.rank() != 0:           # the row adds the bias once
            bias_f = torch.zeros((b, n_loc, dm), dtype=x.dtype, device=x.device)
        else:
            bias_f = taylorseer.forecast(state.taylor, k_since, m.interval).to(x.dtype)
        if cfg.use_gemm_o and run:
            out = backend.gemm_o(o_tok, wo_h, plan, bias_f, block=m.pool, spec=spec_c, h_lo=h0)
        else:
            # Dense GEMM over zero-filled cached heads + the forecast bias.
            m_tok = torch.repeat_interleave(plan.m_ch[..., h0:h0 + h], m.pool,
                                            dim=-2)[..., :n_loc, :]
            out = torch.einsum("bnhd,hdf->bnf",
                               torch.where(m_tok[..., None], o_tok, 0), wo_h) + bias_f
    else:
        out = torch.einsum("bnhd,hdf->bnf", o_tok, wo_h)
    if split:
        out = tp.reduce(out)
    return out, LayerState(s_c=state.s_c, s_s=state.s_s, taylor=state.taylor,
                           k_since=k_since, plan=plan_stored)
