"""Cost-certificate passes, the port's counterpart of
``repro.analysis.cost_passes``.

Built on :mod:`repro_torch.analysis.cost_model` over the op records of the
REAL engine entry points at the analyzer geometry (kernel regions billed
at plan capacity by ``kernel_cost``):

* :class:`DispatchCostScaling` (``cost-dispatch-scaling``) — for every
  ``(backend, kv_buckets)`` Dispatch group, record ``dispatch_layer`` at
  three matched-capacity lengths ``n ∈ {128, 256, 384}`` and certify that
  FLOPs and bytes are EXACTLY affine in ``T_kv`` (zero second difference:
  a smuggled dense ``T_kv``-wide product is super-linear), with a per-token
  slope within :data:`KAPPA_TOKEN` (FLOPs) and :data:`KAPPA_TOKEN_BYTES`
  (bytes) of the dense K/V-projection work Dispatch pays for every token
  (recorded from the same cost model).  At fixed ``n``, three plan
  densities certify that FLOPs rise with the plan's slot capacity.  Every
  strategy's Dispatch must cost bit-identically to its group: Dispatch
  never consults the strategy.
* :class:`UpdateAmortization` (``cost-update-amortization``) — Update
  costs at most :data:`KAPPA_UPDATE` × one dense attention layer (FLOPs;
  :data:`KAPPA_UPDATE_BYTES` bytes), and the interval-amortized engine
  ``(update + (interval − 1) · dispatch) / interval`` stays under
  :data:`THETA_AMORTIZED` × dense.  An engine that rebuilds the plan every
  Dispatch pays the Update every step and fails.
* :class:`MemoryFootprint` (``cost-memory-footprint``) — the peak live
  bytes of every Update and Dispatch record stay within
  :data:`PEAK_BUDGETS`, and the batcher's scan tick's peak is affine in
  the lane count (the marginal bytes of lanes 2 → 4 and 4 → 6 agree).
* :class:`CollectiveBytesBudget` (``cost-collective-bytes``) — a seq-mesh
  Dispatch layer's all-to-all payload equals the ``pair_cap`` formula
  (:func:`expected_a2a_payload`), under half the dense K/V all-gather, and
  the only other collective is the named output all-gather
  (:func:`expected_gather_payload`); head mode has the all-gather alone.

The mesh groups (``mesh_dp=1, mesh_sp=2``) run in a ``torch.distributed``
world of two ranks and are noted skips without one
(:func:`~repro_torch.analysis.passes.mesh_skip_reason`).

Thresholds were recalibrated on the port's own op stream at its geometry
(CPU and card give the same costs: a kernel region is billed by rule, not
by what its plain version runs).  Measured on the four groups:

* per-token slope 1.00× (kernels) and 1.02× (twin) the FLOP reference,
  1.47× and 2.52× the byte reference: ``KAPPA_TOKEN = 1.5``,
  ``KAPPA_TOKEN_BYTES = 3.5``; the mesh groups 2.05× and 3.57× the bytes
  (the staged local slice and the output all-gather):
  ``KAPPA_TOKEN_BYTES_MESH = 5.0``, the reference's budget over its mesh
  groups;
* Update 1.13× a dense layer's FLOPs and 1.29× its bytes:
  ``KAPPA_UPDATE = 1.5``, ``KAPPA_UPDATE_BYTES = 2.0``; amortized over an
  interval of 4 at half density 0.65× (kernels) and 0.66× (twin):
  ``THETA_AMORTIZED = 0.95`` (a plan rebuilt every step sits at 1.13×);
* peaks: Update 0.46 MB, Dispatch 0.32 MB (kernels) and 0.71 MB (twin at 3
  buckets); the scan tick 1.04 MB + 0.165 MB a lane, the two marginals
  equal to the byte.

Budgets carry 35–50 % headroom: they catch dense work on the Dispatch
path, plans rebuilt per step and new full-size buffers, not 1 % drift.
The ``*_findings`` helpers are pure functions over
:class:`~repro_torch.analysis.cost_model.CostEstimate` values, so the
CLI fixtures and the tests can feed them poisoned records.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Sequence

import torch

from repro_torch.analysis.cost_model import CostEstimate, cost_of_record, peak_bytes_of
from repro_torch.analysis.op_walk import record_call
from repro_torch.analysis.passes import (_B, _DH, _DM, _H, _N, MESH, _engine_cfg, _params,
                                         _x, mesh_skip_reason, serving_setup, trace_pair)

__all__ = ["DispatchCostScaling", "UpdateAmortization", "MemoryFootprint",
           "CollectiveBytesBudget", "COST_PASSES", "dispatch_groups",
           "token_scaling_findings", "amortization_findings", "footprint_findings",
           "collective_findings", "expected_a2a_payload", "expected_gather_payload",
           "dense_reference_cost", "token_reference_slope", "KAPPA_TOKEN",
           "KAPPA_TOKEN_BYTES", "KAPPA_TOKEN_BYTES_MESH", "KAPPA_UPDATE",
           "KAPPA_UPDATE_BYTES", "THETA_AMORTIZED",
           "PEAK_BUDGETS"]

# Matched-capacity sequence lengths of the T_kv-independence scan.
_NS = (128, 256, 384)

KAPPA_TOKEN = 1.5
KAPPA_TOKEN_BYTES = 3.5
# The mesh groups pay per token besides: the local K/V slice staged into
# the exchange buffer and the output all-gather (measured 2.05x kernels,
# 3.57x twin); the reference's own byte budget, set over its mesh groups.
KAPPA_TOKEN_BYTES_MESH = 5.0
KAPPA_UPDATE = 1.5
KAPPA_UPDATE_BYTES = 2.0
THETA_AMORTIZED = 0.95
PEAK_BUDGETS = {
    "update_layer": 640_000,
    "dispatch_layer": 1_000_000,
    "lane_tick_base": 1_450_000,
    "lane_tick_per_lane": 230_000,
}
# Lane marginals must agree to this relative tolerance.
LANE_MARGINAL_RTOL = 0.02


def matched(cfg, capq_cmp: int, capkv_cmp: int, n: int):
    """``cfg`` with the compressed-granularity capacities pinned to
    ``capq_cmp``/``capkv_cmp`` at ``n`` tokens, so a plan's slots stay fixed
    while ``T_kv`` scales."""
    t = cfg.mask.n_blocks(n)
    out = dataclasses.replace(cfg, cap_q_frac=capq_cmp / t, cap_kv_frac=capkv_cmp / t)
    if (out.cap_q_cmp(n), out.cap_kv_cmp(n)) != (capq_cmp, capkv_cmp):
        raise ValueError(f"capacities ({capq_cmp}, {capkv_cmp}) not representable at "
                         f"n={n}")
    return out


def dispatch_groups(kv_buckets=(1, 3), meshes=(False, True)):
    """The strategy-independent Dispatch grid: ``dispatch_layer`` never
    consults ``cfg.strategy``, so one ``(backend, kv_buckets, mesh)`` cell
    covers every strategy; the mesh cells only where
    :func:`~repro_torch.analysis.passes.mesh_skip_reason` allows them."""
    from repro_torch.core.backend import available_backends
    meshes = [m for m in meshes if not m or mesh_skip_reason() is None]
    for backend, kvb, mesh in itertools.product(available_backends(), kv_buckets, meshes):
        kw = dict(mesh_dp=MESH[0], mesh_sp=MESH[1]) if mesh else {}
        yield (f"{backend}/kv_buckets={kvb}/{'mesh' if mesh else 'single'}",
               _engine_cfg(backend=backend, kv_buckets=kvb, **kw))


@functools.lru_cache(maxsize=128)
def _costs(cfg, n: int, device: str) -> tuple:
    """``(update cost, dispatch cost)`` of ``cfg`` at ``n`` tokens."""
    upd, disp = trace_pair(cfg, n, device)
    return cost_of_record(upd), cost_of_record(disp)


@functools.lru_cache(maxsize=8)
def dense_reference_cost(n: int, device: str) -> CostEstimate:
    """One dense attention layer (projections, dense attention, output
    projection): the UpdateAmortization yardstick."""
    from repro_torch.core.attention import dense_attention
    from repro_torch.core.engine import _project_heads, _qk
    p = _params(device)

    def dense_layer(x):
        q, k = _qk(p, x, _H)
        v = _project_heads(x, p.wv, _H)
        o = dense_attention(q, k, v)
        wo_h = p.wo.reshape(_H, _DH, _DM)
        return torch.einsum("bnhd,hdf->bnf", o.transpose(1, 2), wo_h)

    return cost_of_record(record_call(dense_layer, _x(device, n))[1])


@functools.lru_cache(maxsize=8)
def token_reference_slope(device: str) -> tuple:
    """``(flops, bytes)`` per token of the work Dispatch pays for EVERY
    token whatever the plan: the K/V projections with their RMSNorm, and
    the reuse and bias buffers; recorded from the cost model itself."""
    from repro_torch.core.engine import _project_heads, rms_norm
    p = _params(device)

    def per_token(x):
        k_h = rms_norm(_project_heads(x, p.wk, _H), p.k_scale)
        v_h = _project_heads(x, p.wv, _H)
        o_reuse = torch.zeros((x.shape[0], _H, x.shape[1], _DH), dtype=x.dtype,
                              device=x.device)
        return k_h, v_h, o_reuse, x + torch.zeros_like(x)

    c0, c1 = (cost_of_record(record_call(per_token, _x(device, n))[1]) for n in _NS[:2])
    dn = _NS[1] - _NS[0]
    return (c1.flops - c0.flops) / dn, (c1.hbm_bytes - c0.hbm_bytes) / dn


# ---------------------------------------------------------------------------
# Pure finding helpers (shared with the CLI fixtures and the tests)
# ---------------------------------------------------------------------------

def token_scaling_findings(pass_name: str, where: str, costs: Sequence[CostEstimate],
                           ns: Sequence[int], budget_flops: float,
                           budget_bytes: float) -> List:
    """Certify ``costs`` over matched-capacity lengths ``ns``: exactly
    affine in n (zero curvature) with a slope within the per-token budget."""
    from repro_torch.analysis import Finding
    findings = []
    assert len(costs) == len(ns) == 3 and ns[2] - ns[1] == ns[1] - ns[0]
    dn = ns[1] - ns[0]
    for attr, budget, unit in (("flops", budget_flops, "flops"),
                               ("hbm_bytes", budget_bytes, "bytes")):
        v = [getattr(c, attr) for c in costs]
        d1, d2 = v[1] - v[0], v[2] - v[1]
        if abs(d2 - d1) / max(v[1], 1.0) > 1e-9:
            findings.append(Finding(
                pass_name, "tkv-superlinear", where,
                f"{unit} not affine in T_kv at fixed plan capacity: "
                f"Δ({ns[0]}->{ns[1]})={d1:.0f} vs Δ({ns[1]}->{ns[2]})={d2:.0f} — dense "
                f"T_kv-dependent work on the dispatch path"))
        slope = d1 / dn
        if slope > budget:
            findings.append(Finding(
                pass_name, "token-slope-budget", where,
                f"per-token {unit} slope {slope:.0f} exceeds the dense-projection budget "
                f"{budget:.0f} — dispatch pays more than the legitimate per-token work"))
    return findings


def expected_a2a_payload(cfg, n: int) -> float:
    """The ``pair_cap`` formula: two exchanges (K and V) of
    ``(P, B/dp, H, pair_cap, block_kv, dh)`` f32 blocks per rank."""
    from repro_torch.distributed.plan_shard import shard_geometry
    m = cfg.mask
    t_kv = m.n_blocks(n) * (m.pool // m.block_kv)
    geom = shard_geometry(cfg.caps(n), t_kv, t_kv, cfg.mesh_sp, cfg.mesh_pair_slack)
    return 2.0 * (_B // cfg.mesh_dp * _H * cfg.mesh_sp * geom.pair_cap
                  * m.block_kv * _DH) * 4


def expected_gather_payload(n: int) -> float:
    """The output all-gather: the whole (B, H, N, dh) f32 attention output."""
    return float(_B * _H * n * _DH * 4)


def collective_findings(pass_name: str, where: str, cost: CostEstimate,
                        expected_payload: float, dense_payload: float,
                        gather_payload: float) -> List:
    """Certify a seq-mesh Dispatch cost: exactly two all-to-alls whose
    payload is the ``pair_cap`` formula, under half the dense all-gather,
    and on the wire besides them only the one output all-gather of
    ``gather_payload`` bytes."""
    from repro_torch.analysis import Finding
    findings = []
    a2a = cost.coll_payload.get("all_to_all", 0.0)
    if cost.coll_count.get("all_to_all", 0) != 2:
        findings.append(Finding(
            pass_name, "a2a-count", where,
            f"expected exactly 2 all_to_all (one per K and V), found "
            f"{cost.coll_count.get('all_to_all', 0)}"))
    if a2a != expected_payload:
        findings.append(Finding(
            pass_name, "pair-cap-formula", where,
            f"all_to_all payload {a2a:.0f}B != pair_cap formula {expected_payload:.0f}B "
            f"— the exchange is not shipping exactly the plan-live KV blocks"))
    if (cost.coll_count.get("all_gather", 0),
            cost.coll_payload.get("all_gather", 0.0)) != (1, gather_payload):
        findings.append(Finding(
            pass_name, "output-gather", where,
            f"all_gather {cost.coll_count.get('all_gather', 0)}x, "
            f"{cost.coll_payload.get('all_gather', 0.0):.0f}B != the one output gather "
            f"of {gather_payload:.0f}B — something else is gathered"))
    extra = {k: v for k, v in cost.coll_payload.items()
             if k not in ("all_to_all", "all_gather") and v}
    if extra:
        findings.append(Finding(
            pass_name, "no-extra-collectives", where,
            f"unexpected collective bytes {extra} — mesh dispatch must ship only the "
            f"plan-aware a2a payload and the output"))
    if dense_payload and a2a >= 0.5 * dense_payload:
        findings.append(Finding(
            pass_name, "dense-ratio", where,
            f"plan-aware payload {a2a:.0f}B >= 0.5x the dense KV all-gather "
            f"{dense_payload:.0f}B — O(T_kv) communication"))
    return findings


def amortization_findings(pass_name: str, where: str, update_cost: CostEstimate,
                          dispatch_cost: CostEstimate, dense_cost: CostEstimate,
                          interval: int) -> List:
    from repro_torch.analysis import Finding
    findings = []
    if update_cost.flops > KAPPA_UPDATE * dense_cost.flops:
        findings.append(Finding(
            pass_name, "update-cost-bound", where,
            f"Update flops {update_cost.flops:.0f} > {KAPPA_UPDATE}x one dense step "
            f"({dense_cost.flops:.0f}) — plan construction dominates the interval"))
    if update_cost.hbm_bytes > KAPPA_UPDATE_BYTES * dense_cost.hbm_bytes:
        findings.append(Finding(
            pass_name, "update-bytes-bound", where,
            f"Update bytes {update_cost.hbm_bytes:.0f} > {KAPPA_UPDATE_BYTES}x one dense "
            f"step ({dense_cost.hbm_bytes:.0f})"))
    amort = (update_cost.flops + (interval - 1) * dispatch_cost.flops) \
        / (interval * dense_cost.flops)
    if amort > THETA_AMORTIZED:
        findings.append(Finding(
            pass_name, "interval-amortization", where,
            f"amortized interval cost {amort:.3f}x dense exceeds {THETA_AMORTIZED}x — the "
            f"Update is not amortized over the interval (a plan rebuilt every dispatch "
            f"lands here)"))
    return findings


def footprint_findings(pass_name: str, where: str, peak: float, budget: float) -> List:
    from repro_torch.analysis import Finding
    if peak <= budget:
        return []
    return [Finding(
        pass_name, "peak-bytes-budget", where,
        f"estimated peak live bytes {peak:.0f} exceed the declared budget {budget:.0f} — a "
        f"new full-size buffer joined this call")]


# ---------------------------------------------------------------------------
# The passes
# ---------------------------------------------------------------------------

class DispatchCostScaling:
    """Dispatch cost ∝ plan slots, never T_kv (the paper's Fig. 10/11 claim)."""

    name = "cost-dispatch-scaling"

    def run(self, ctx) -> List:
        from repro_torch.analysis import Finding
        from repro_torch.core.strategy import available_strategies
        dev = str(ctx.device)
        findings = []
        ref_f, ref_b = token_reference_slope(dev)
        for label, cfg0 in dispatch_groups():
            # 1. T_kv-independence: matched caps, three lengths.
            costs = [_costs(matched(cfg0, 2, 2, n), n, dev)[1] for n in _NS]
            kappa_bytes = KAPPA_TOKEN_BYTES_MESH if cfg0.mesh_sp > 1 else KAPPA_TOKEN_BYTES
            findings += token_scaling_findings(
                self.name, f"dispatch_layer[{label}]", costs, _NS,
                budget_flops=KAPPA_TOKEN * ref_f, budget_bytes=kappa_bytes * ref_b)
            # 2. Live-slot slope: density scan at fixed n.
            n0 = _NS[0]
            dens = [(1, 1), (2, 2), (3, 4)]
            dcosts = [_costs(matched(cfg0, cq, ck, n0), n0, dev)[1] for cq, ck in dens]
            slots = [cq * ck for cq, ck in dens]
            for i in range(1, len(dcosts)):
                if dcosts[i].flops <= dcosts[i - 1].flops:
                    findings.append(Finding(
                        self.name, "slot-slope", f"dispatch_layer[{label}]",
                        f"dispatch flops not increasing with live plan slots "
                        f"({slots[i - 1]}->{slots[i]}): {dcosts[i - 1].flops:.0f} -> "
                        f"{dcosts[i].flops:.0f} — cost is not plan-proportional"))
            dn = _NS[1] - _NS[0]
            ctx.note(f"{self.name}: {label} token slope "
                     f"{(costs[1].flops - costs[0].flops) / dn / ref_f:.2f}x flops, "
                     f"{(costs[1].hbm_bytes - costs[0].hbm_bytes) / dn / ref_b:.2f}x bytes "
                     f"of the dense-projection reference")
        # 3. Strategy leak: every strategy must cost its group's baseline.
        for label, cfg0 in dispatch_groups():
            base = _costs(cfg0, _N, dev)[1]
            for strat in available_strategies():
                c = _costs(dataclasses.replace(cfg0, strategy=strat), _N, dev)[1]
                if (c.flops, c.hbm_bytes) != (base.flops, base.hbm_bytes):
                    findings.append(Finding(
                        self.name, "strategy-leak", f"dispatch_layer[{strat}/{label}]",
                        f"dispatch cost ({c.flops:.0f} flops, {c.hbm_bytes:.0f}B) differs "
                        f"from the group baseline ({base.flops:.0f}, {base.hbm_bytes:.0f}B) "
                        f"— strategy content reached the Dispatch step"))
        return findings


class CollectiveBytesBudget:
    """Mesh all-to-all bytes ≡ the ``pair_cap`` formula, never O(T_kv)."""

    name = "cost-collective-bytes"
    DENSITY_CMP = 2            # compressed-granularity caps: 25 % at n = 256
    N = 256

    def run(self, ctx) -> List:
        from repro_torch.analysis import Finding
        if mesh_skip_reason() is not None:
            ctx.note(f"{self.name}: skipped ({mesh_skip_reason()})")
            return []
        dev = str(ctx.device)
        cfg = matched(_engine_cfg(mesh_dp=MESH[0], mesh_sp=MESH[1]), self.DENSITY_CMP,
                      self.DENSITY_CMP, self.N)
        cost = _costs(cfg, self.N, dev)[1]
        dense_payload = 2.0 * (_B * _H * self.N * _DH) * 4   # all-gather of K and V
        findings = collective_findings(
            self.name, f"dispatch_layer[mesh seq, n={self.N}, cap_cmp={self.DENSITY_CMP}]",
            cost, expected_a2a_payload(cfg, self.N), dense_payload,
            expected_gather_payload(self.N))
        a2a = cost.coll_payload.get("all_to_all", 0.0)
        ctx.note(f"{self.name}: a2a payload {a2a:.0f}B = pair_cap formula, "
                 f"{a2a / dense_payload:.3f}x the dense K/V all-gather")
        # head mode: the output all-gather and nothing else.
        cost_h = _costs(_engine_cfg(mesh_dp=MESH[0], mesh_sp=MESH[1], mesh_axis="head"),
                        _N, dev)[1]
        if cost_h.coll_payload != {"all_gather": expected_gather_payload(_N)}:
            findings.append(Finding(
                self.name, "head-mode-collectives", "dispatch_layer[mesh head]",
                f"head-mode dispatch spends collectives {cost_h.coll_payload} — it must "
                f"spend only the output all-gather"))
        return findings


class UpdateAmortization:
    """Update ≤ κ × dense; the interval's amortized cost beats θ × dense."""

    name = "cost-update-amortization"

    def run(self, ctx) -> List:
        dev = str(ctx.device)
        findings = []
        dense = dense_reference_cost(_N, dev)
        for label, cfg in dispatch_groups(kv_buckets=(1,)):
            cfg = matched(cfg, 2, 2, _N)                   # half density
            u, d = _costs(cfg, _N, dev)
            interval = cfg.mask.interval
            findings += amortization_findings(self.name, f"update/dispatch[{label}]", u, d,
                                              dense, interval)
            ctx.note(f"{self.name}: {label} update {u.flops / dense.flops:.2f}x dense "
                     f"({u.hbm_bytes / dense.hbm_bytes:.2f}x bytes), dispatch "
                     f"{d.flops / dense.flops:.2f}x, amortized "
                     f"{(u.flops + (interval - 1) * d.flops) / (interval * dense.flops):.2f}x")
        return findings


def lane_tick_peak(device: str, lanes: int) -> float:
    """Peak live bytes of the batcher's scan tick over ``lanes`` lanes at
    an Update step (smoke config)."""
    from repro_torch.diffusion.pipeline import make_lane_tick
    cfg, ecfg, scfg, strategies, a = serving_setup(device, lanes=lanes,
                                                   latent_dtype=torch.float32)
    tick = make_lane_tick(cfg, ecfg, scfg, strategies)
    _, rec = record_call(tick, a["params"], a["patch_embed"], list(a["x"]),
                         [list(s) for s in a["states"]], a["text_emb"], a["step"],
                         a["mode_tab"], a["id_tab"], a["nsteps"], a["active"])
    return peak_bytes_of(rec)


class MemoryFootprint:
    """Peak live bytes of each record within the declared budget table."""

    name = "cost-memory-footprint"
    LANES = (2, 4, 6)

    def run(self, ctx) -> List:
        from repro_torch.analysis import Finding
        dev = str(ctx.device)
        findings = []
        for label, cfg in dispatch_groups():
            upd, disp = trace_pair(cfg, _N, dev)
            findings += footprint_findings(self.name, f"update_layer[{label}]",
                                           peak_bytes_of(upd), PEAK_BUDGETS["update_layer"])
            findings += footprint_findings(self.name, f"dispatch_layer[{label}]",
                                           peak_bytes_of(disp), PEAK_BUDGETS["dispatch_layer"])
        peaks = {lanes: lane_tick_peak(dev, lanes) for lanes in self.LANES}
        l0, l1, l2 = self.LANES
        m1 = (peaks[l1] - peaks[l0]) / (l1 - l0)
        m2 = (peaks[l2] - peaks[l1]) / (l2 - l1)
        if abs(m2 - m1) > LANE_MARGINAL_RTOL * max(m1, 1.0):
            findings.append(Finding(
                self.name, "lane-bytes-affinity", "lane tick[scan]",
                f"per-lane marginal peak bytes changed with the lane count: {m1:.0f}B/lane "
                f"(lanes {l0}->{l1}) vs {m2:.0f}B/lane (lanes {l1}->{l2}) — a buffer scales "
                f"super-linearly in lanes"))
        budget = PEAK_BUDGETS["lane_tick_base"] + PEAK_BUDGETS["lane_tick_per_lane"] * l2
        findings += footprint_findings(self.name, f"lane tick[scan, lanes={l2}]", peaks[l2],
                                       budget)
        ctx.note(f"{self.name}: lane tick peak {peaks[l2] / 1e6:.2f}MB at {l2} lanes, "
                 f"marginal {m1:.0f}B/lane")
        return findings


COST_PASSES = (DispatchCostScaling, CollectiveBytesBudget, UpdateAmortization,
               MemoryFootprint)
