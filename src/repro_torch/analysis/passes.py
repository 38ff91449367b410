"""The op-stream passes of the analyzer, the port's counterpart of
``repro.analysis.passes``.

Each pass runs REAL engine entry points (never copies of them) at the
analyzer geometry on ``ctx.device`` and walks their op streams with
:mod:`repro_torch.analysis.op_walk`:

* :class:`DispatchPurity` — every registered strategy × backend
  (``kernels``, ``torch``) × ``kv_buckets ∈ {1, 3}`` × {single device,
  seq mesh ``(1, 2)``}: the
  ``dispatch_layer`` record holds no index-decode work (sort / top-k
  family, uint8 symbol unpack), kernel regions included.  The matching
  ``update_layer`` record is the positive control: it MUST show the decode
  ops.  On the ``kernels`` backend the Dispatch record must hold the
  regions of its three kernels (B1–B3, or B1/B4/B5 with buckets); on the
  twin none.
* :class:`PromotionCheck` — the continuous batcher's grouped ticks (one
  per mode) and its scan tick keep bf16 latents bf16 and every engine-state
  tensor's dtype (a promotion would change the next tick's inputs).
* :class:`ExecutableBudget` — N/A, recorded as a note: the port compiles
  nothing per configuration (ROADMAP A.4).
* :class:`CollectiveBudget` — a mesh Dispatch layer spends exactly two
  all-to-alls (K and V) and the one output all-gather in seq mode, and the
  all-gather alone in head mode.

The mesh combos run ``mesh_dp=1, mesh_sp=2`` and need a
``torch.distributed`` world of exactly two ranks (``torchrun
--nproc-per-node 2 -m repro_torch.analysis``, or
:func:`repro_torch.launch.mesh.run_local_mesh`); every rank runs the same
passes in the same order.  Without such a world they are noted skips, as
the reference's are on a one-device host.

Unlike the reference's abstract traces, a record runs the call, so the
analyzer geometry must be one the built kernels accept (head_dim
32/64/128, blocks 16/32/64/128): ``B, H, N = 1, 2, 128``, head_dim 32,
d_model 64, blocks 16/16, pool 32.  The same geometry runs on the CPU
(plain versions) and on the card (the kernels).
"""

from __future__ import annotations

import functools
import itertools
from typing import List

import torch

from repro_torch.analysis.op_walk import index_decode_ops, kernel_regions, record_call

__all__ = ["DispatchPurity", "PromotionCheck", "ExecutableBudget", "CollectiveBudget",
           "OP_PASSES", "trace_pair", "sweep_configs", "promotion_findings",
           "expected_regions", "mesh_capacity", "mesh_skip_reason", "MESH"]

# The analyzer geometry: batch, heads, tokens, d_model, head_dim.
_B, _H, _N, _DM, _DH = 1, 2, 128, 64, 32
_N_TEXT = 32


def _mask_cfg():
    from repro_torch.core.masks import MaskConfig
    return MaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.0,
                      block_q=16, block_kv=16, pool=32, warmup_steps=1)


def _engine_cfg(**kw):
    from repro_torch.core.engine import EngineConfig
    return EngineConfig(mask=_mask_cfg(), cache_dtype=torch.float32, cap_q_frac=0.75,
                        cap_kv_frac=0.9, **kw)


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _params(device, seed: int = 0):
    from repro_torch.core.engine import AttnParams
    g = _gen(seed, device)
    f = _H * _DH
    rnd = lambda *s: torch.randn(s, generator=g, device=device) * 0.05
    return AttnParams(wq=rnd(_DM, f), wk=rnd(_DM, f), wv=rnd(_DM, f), wo=rnd(f, _DM),
                      q_scale=torch.ones(_DH, device=device),
                      k_scale=torch.ones(_DH, device=device))


def _x(device, n: int = _N, seed: int = 3) -> torch.Tensor:
    return torch.randn((_B, n, _DM), generator=_gen(seed, device), device=device) * 0.3


# The mesh of the analyzer's mesh combos: (mesh_dp, mesh_sp).
MESH = (1, 2)


def mesh_capacity() -> int:
    """Ranks of the initialised ``torch.distributed`` world (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def mesh_skip_reason():
    """Why the mesh combos cannot run here, or None when they can."""
    if mesh_capacity() != MESH[0] * MESH[1]:
        return (f"needs a torch.distributed world of {MESH[0] * MESH[1]} ranks, have "
                f"{mesh_capacity()} (torchrun --nproc-per-node 2 -m repro_torch.analysis)")
    return None


def sweep_configs(kv_buckets=(1, 3), meshes=(False, True)):
    """``(label, cfg)`` over every strategy × backend × ``kv_buckets`` ×
    {single device, seq mesh}; the mesh combos only where
    :func:`mesh_skip_reason` allows them."""
    from repro_torch.core.backend import available_backends
    from repro_torch.core.strategy import available_strategies
    meshes = [m for m in meshes if not m or mesh_skip_reason() is None]
    for strat, backend, kvb, mesh in itertools.product(
            available_strategies(), available_backends(), kv_buckets, meshes):
        kw = dict(mesh_dp=MESH[0], mesh_sp=MESH[1]) if mesh else {}
        yield (f"{strat}/{backend}/kv_buckets={kvb}/{'mesh' if mesh else 'single'}",
               _engine_cfg(strategy=strat, backend=backend, kv_buckets=kvb, **kw))


def expected_regions(cfg) -> tuple:
    """The kernel regions a Dispatch step of ``cfg`` runs, in order.  A seq
    mesh runs the uniform attention on each shard (its inner spec has one
    bucket) beside the bucketed GEMM-O."""
    if cfg.backend != "kernels":
        return ()
    buckets = cfg.resolved_kv_buckets() > 1
    mesh = cfg.mesh_sp > 1
    return ("gemm_q_sparse_kernel",
            "flashomni_attention_csr_bucketed" if buckets and not mesh
            else "flashomni_attention_csr",
            "gemm_o_sparse_bucketed_kernel" if buckets else "gemm_o_sparse_kernel")


@functools.lru_cache(maxsize=64)
def trace_pair(cfg, n: int = _N, device: str = "cpu"):
    """``(update_record, dispatch_record)`` of one attention layer of
    ``cfg`` at ``n`` tokens on ``device``: an Update on seeded inputs, then
    a Dispatch on the state it made.  Memoized per ``(cfg, n, device)``:
    the purity and the cost passes read the same records."""
    from repro_torch.core.engine import dispatch_layer, init_layer_state, update_layer
    p, x = _params(device), _x(device, n)
    state = init_layer_state(_B, _H, n, _DM, _DH, cfg, device)
    (_, st), upd = record_call(update_layer, p, x, state, cfg, n_text=_N_TEXT, heads=_H,
                               step_idx=2, num_steps=8)
    _, disp = record_call(dispatch_layer, p, x, st, cfg, n_text=_N_TEXT, heads=_H)
    return upd, disp


class DispatchPurity:
    """No index-decode op in any Dispatch record; every kernel of the path
    present as a region."""

    name = "dispatch-purity"

    def run(self, ctx) -> List:
        findings = []
        for label, cfg in sweep_configs():
            findings += self.check(label, cfg, ctx.device)
        if mesh_skip_reason() is not None:
            ctx.note(f"{self.name}: mesh combos skipped ({mesh_skip_reason()})")
        return findings

    def check(self, label: str, cfg, device) -> List:
        from repro_torch.analysis import Finding
        findings = []
        upd, disp = trace_pair(cfg, _N, str(device))
        for path, node in index_decode_ops(disp):
            findings.append(Finding(
                self.name, "no-index-decode-in-dispatch", f"dispatch_layer[{label}]",
                f"{node.overload} at {'/'.join(path) or '<top>'} — Dispatch is "
                f"rebuilding plan indices"))
        if not index_decode_ops(upd):
            findings.append(Finding(
                self.name, "walker-vacuous", f"update_layer[{label}]",
                "positive control failed: the Update record shows no sort/top-k — the "
                "walker is not seeing the real engine ops"))
        regions = tuple(kernel_regions(disp))
        want = expected_regions(cfg)
        for name in want:
            if name not in regions:
                findings.append(Finding(
                    self.name, "walker-vacuous", f"dispatch_layer[{label}]",
                    f"kernel region {name} missing from the Dispatch record (regions "
                    f"seen: {list(regions)}) — the walker cannot vouch for that kernel"))
        extra = [r for r in regions if r not in want]
        if extra:
            findings.append(Finding(
                self.name, "unexpected-kernel", f"dispatch_layer[{label}]",
                f"kernel regions {extra} outside the path's {list(want)}"))
        return findings


class CollectiveBudget:
    """Mesh Dispatch's collectives: two all-to-alls (K and V) in seq mode,
    none in head mode, and in both the one all-gather of the attention
    output (GEMM-O runs replicated)."""

    name = "collective-budget"

    def run(self, ctx) -> List:
        from repro_torch.analysis import Finding
        from repro_torch.analysis.op_walk import collective_counts
        if mesh_skip_reason() is not None:
            ctx.note(f"{self.name}: skipped ({mesh_skip_reason()})")
            return []
        findings = []
        for mode, want_a2a in (("seq", 2), ("head", 0)):
            cfg = _engine_cfg(mesh_dp=MESH[0], mesh_sp=MESH[1], mesh_axis=mode)
            where = f"dispatch_layer[mesh_axis={mode}]"
            cc = collective_counts(trace_pair(cfg, _N, str(ctx.device))[1])
            a2a, gather = cc.pop("all_to_all", 0), cc.pop("all_gather", 0)
            if a2a != want_a2a:
                findings.append(Finding(
                    self.name, "all-to-all-budget", where,
                    f"expected exactly {want_a2a} all_to_all (one per K and V in seq "
                    f"mode), found {a2a}"))
            if gather != 1:
                findings.append(Finding(
                    self.name, "output-gather", where,
                    f"expected exactly 1 all_gather (the attention output), found {gather}"))
            if cc:
                findings.append(Finding(
                    self.name, "no-extra-collectives", where,
                    f"unexpected collectives {dict(cc)} — mesh dispatch must ship only "
                    f"the plan-live KV blocks and the output"))
        return findings


class ExecutableBudget:
    """The reference's ≤ 4 executables per lane shape: N/A here."""

    name = "executable-budget"

    def run(self, ctx) -> List:
        ctx.note(f"{self.name}: N/A (the port compiles nothing per configuration: "
                 "ROADMAP A.4)")
        return []


# --- serving-tick passes ----------------------------------------------------

def serving_setup(device, lanes: int = 2, nv: int = 64, latent_dtype=torch.bfloat16):
    """The continuous batcher's tick inputs at smoke size: ``(cfg, ecfg,
    scfg, strategies, args)``, ``args`` a dict of the tick operands for
    ``lanes`` fresh lanes at step 0 (an Update step) of an 8-step
    schedule."""
    import numpy as np

    from repro_torch.configs.registry import get_smoke
    from repro_torch.core.engine import resolve_schedule, stack_lane_states
    from repro_torch.diffusion.pipeline import SamplerConfig
    from repro_torch.models import dit
    cfg = get_smoke("flux-mmdit")
    ecfg = _engine_cfg(kv_buckets=1)
    scfg = SamplerConfig(num_steps=8, dtype=torch.float32)
    sched = resolve_schedule(ecfg, 8, cfg.n_layers)
    g = _gen(0, device)
    nt = cfg.n_text_tokens
    args = dict(
        params=dit.init_params(cfg, g, device),
        # The patch embedding in the latents' dtype: a bf16 latent times an
        # f32 matrix does not promote in torch, it raises.
        patch_embed=(torch.randn((cfg.patch_dim, cfg.d_model), generator=g, device=device)
                     * 0.2).to(latent_dtype),
        x=[torch.randn((1, nv, cfg.patch_dim), generator=g, device=device).to(latent_dtype)
           for _ in range(lanes)],
        states=stack_lane_states(dit.init_engine_states(cfg, ecfg, 1, nv + nt, device),
                                 lanes),
        text_emb=[torch.randn((1, nt, cfg.d_model), generator=g, device=device)
                  for _ in range(lanes)],
        step=np.zeros((lanes,), np.int32),
        mode_tab=np.repeat(np.asarray(sched.mode)[None], lanes, 0),
        id_tab=np.repeat(np.asarray(sched.strategy_ids)[None], lanes, 0),
        nsteps=np.full((lanes,), 8, np.int32),
        active=np.ones((lanes,), bool))
    return cfg, ecfg, scfg, sched.strategies, args


def _state_leaves(states) -> list:
    from torch.utils._pytree import tree_flatten
    leaves, _ = tree_flatten(states)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def run_ticks(device, latent_dtype=torch.bfloat16) -> dict:
    """Every tick body of the batcher once on fresh lanes: ``{body: (x_in,
    states_in, x_out, states_out)}`` for the scan tick and the grouped
    ``dense``, ``update`` and ``dispatch`` bodies."""
    import numpy as np

    from repro_torch.diffusion.pipeline import make_grouped_lane_tick, make_lane_tick
    out = {}
    cfg, ecfg, scfg, strategies, a = serving_setup(device, latent_dtype=latent_dtype)
    tick = make_lane_tick(cfg, ecfg, scfg, strategies)
    grouped = make_grouped_lane_tick(cfg, ecfg, scfg, strategies)
    bodies = [("scan", None)] + list(grouped.items())
    for body, fn in bodies:
        x, states = list(a["x"]), [list(s) for s in a["states"]]
        x_in, st_in = list(x), [list(s) for s in states]
        if fn is None:
            x2, st2, _, _ = tick(a["params"], a["patch_embed"], x, states, a["text_emb"],
                                 a["step"], a["mode_tab"], a["id_tab"], a["nsteps"],
                                 a["active"])
        else:
            lanes = len(x)
            id_rows = a["id_tab"][np.arange(lanes), a["step"]]
            x2, st2, _, _ = fn(a["params"], a["patch_embed"], x, states, a["text_emb"],
                               a["step"], id_rows, a["nsteps"], a["active"])
        out[body] = (x_in, st_in, list(x2), [list(s) for s in st2])
    return out


def promotion_findings(pass_name: str, where: str, x_in, states_in, x_out,
                       states_out) -> List:
    """Latents and engine-state tensors must keep their dtypes through a tick."""
    from repro_torch.analysis import Finding
    findings = []
    for a, b in zip(x_in, x_out):
        if a.dtype != b.dtype:
            findings.append(Finding(
                pass_name, "latent-promotion", where,
                f"latents promoted {a.dtype} -> {b.dtype}: the next tick's operands "
                f"change dtype"))
            break
    leaves_in, leaves_out = _state_leaves(states_in), _state_leaves(states_out)
    if len(leaves_in) != len(leaves_out):
        findings.append(Finding(pass_name, "state-structure", where,
                                f"{len(leaves_in)} state tensors in, {len(leaves_out)} out"))
    for i, (a, b) in enumerate(zip(leaves_in, leaves_out)):
        if a.dtype != b.dtype:
            findings.append(Finding(pass_name, "state-promotion", where,
                                    f"engine-state leaf {i} promoted {a.dtype} -> {b.dtype}"))
    return findings


class PromotionCheck:
    """Batcher ticks preserve latent and state dtypes (bf16 stays bf16)."""

    name = "promotion-check"

    def run(self, ctx) -> List:
        findings = []
        for body, (x_in, st_in, x_out, st_out) in run_ticks(ctx.device).items():
            findings += promotion_findings(self.name, f"lane tick[{body}]", x_in, st_in,
                                           x_out, st_out)
        return findings


OP_PASSES = (DispatchPurity, CollectiveBudget, PromotionCheck, ExecutableBudget)
