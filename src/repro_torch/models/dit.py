"""MMDiT — the paper's own model family (FLUX / HunyuanVideo style), port of
``repro.models.dit``.

Single-stream DiT blocks over the concatenated [text; vision] sequence with
adaLN-Zero timestep modulation; joint attention runs through the FlashOmni
Update–Dispatch engine.  The text encoder and patchifier are stubs: inputs
are precomputed text and latent-patch embeddings.  The reference scans the
blocks with ``lax.scan``; here the layers are a Python loop over the stacked
``(L, ...)`` block parameters and a list of per-layer engine states.
``param_specs`` and ``engine_state_specs`` are the reference's logical
sharding specs for this layout: the parameters' are the reference's, and
the engine state's are one :class:`LayerState` of specs that every layer's
state shares, each the reference's without its leading layer entry.
:mod:`repro_torch.launch.steps` lays the state out by them; the
reference's ``constrain`` hints are dropped, since a step runs on each
rank's local tensors.

**Tensor parallelism.**  Inside a sharded step that splits the ``model``
axis (:mod:`~repro_torch.distributed.tensor_parallel`), a block's ``tp``
leaves are the rank's shards: ``wq``/``wk``/``wv`` columns and ``wo`` rows
of its ``H/m`` heads, which the engine computes
(:mod:`repro_torch.core.engine`: Update and Dispatch sum their output
partials over the row; dense mode sums the ``wo`` partial here), and
``mlp_wi`` columns and ``mlp_wo`` rows, the MLP column- then row-parallel
and summed over the row.  Each branch's input passes *f* (``tp.copy``) so
its gradient meets the other ranks'.  What every rank computes whole
takes a gradient over the row's size (``tp.replicated``: the modulations,
``final_norm`` and ``final_proj``), so that it sums over the row as a
partial one does; ``t_mlp2`` (``tp`` on its columns) is gathered whole.  A
head count or ``d_ff`` that the row does not divide is gathered and
computed replicated (``tp.note`` records it).  Outside such a step every
operator is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine as E
from repro_torch.core.attention import dense_attention
from repro_torch.core.engine import AttnParams, EngineConfig, LayerState
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import block, rms_norm

__all__ = ["init_params", "param_specs", "init_engine_states", "engine_state_specs",
           "denoise_step", "timestep_embedding", "train_loss"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("blocks",)


def _canonicalize_layer_strategies(layer_strategies, ecfg: EngineConfig, n_layers: int):
    """Per-layer spec table -> (strategy set, int32 id row)."""
    from repro_torch.core.schedule import strategy_table
    return strategy_table(layer_strategies, ecfg, n_layers)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's shapes and scales (dit.py:44-84).

    ``generator`` lives on ``device``; the block leaves are stacked
    ``(L, ...)`` like the reference's pytree.  The numbers differ from
    ``jax.random``'s: tests pass the reference's weights through
    :func:`repro_torch.convert.params_from_jax` instead."""
    d, h, hd, L = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_layers
    s = d ** -0.5

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device).mul_(std)

    blocks = {
        "wq": normal(L, d, h * hd, std=s),
        "wk": normal(L, d, h * hd, std=s),
        "wv": normal(L, d, h * hd, std=s),
        "wo": normal(L, h * hd, d, std=s),
        "q_scale": torch.ones((L, hd), device=device),
        "k_scale": torch.ones((L, hd), device=device),
        "mlp_wi": normal(L, d, cfg.d_ff, std=s),
        "mlp_wo": normal(L, cfg.d_ff, d, std=cfg.d_ff ** -0.5),
        "adaln": normal(L, d, 6 * d, std=0.02),
        "adaln_b": torch.zeros((L, 6 * d), device=device),
    }
    return {
        "blocks": blocks,
        "t_mlp1": normal(256, d, std=0.02),
        "t_mlp2": normal(d, d, std=0.02),
        "final_mod": normal(d, 2 * d, std=0.02),
        "final_proj": normal(d, cfg.patch_dim, std=0.02),
        "final_norm": torch.ones((d,), device=device),
    }


def _block_specs() -> dict:
    n = (None,)
    return {"wq": (*n, "fsdp", "tp"), "wk": (*n, "fsdp", "tp"),
            "wv": (*n, "fsdp", "tp"), "wo": (*n, "tp", "fsdp"),
            "q_scale": (*n, None), "k_scale": (*n, None),
            "mlp_wi": (*n, "fsdp", "tp"), "mlp_wo": (*n, "tp", "fsdp"),
            "adaln": (*n, "fsdp", None), "adaln_b": (*n, None)}


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    return {"blocks": _block_specs(),
            "t_mlp1": (None, "fsdp"), "t_mlp2": ("fsdp", "tp"),
            "final_mod": ("fsdp", None), "final_proj": ("fsdp", None),
            "final_norm": (None,)}


def init_engine_states(cfg: ArchConfig, ecfg: EngineConfig, batch: int,
                       n_tokens: int, device) -> list[LayerState]:
    """One initial state per layer.  States are updated out of place, so
    every layer shares the same initial tensors."""
    one = E.init_layer_state(batch, cfg.n_heads, n_tokens, cfg.d_model, cfg.hd,
                             ecfg, device)
    return [one] * cfg.n_layers


def engine_state_specs(cfg: ArchConfig, ecfg: EngineConfig) -> LayerState:
    """The logical specs of one layer's state (every entry of
    :func:`init_engine_states`' list): the reference's, each without its
    leading layer entry.  The counters ``k_since`` and ``n_updates`` are
    host ints here, spec ``()``.  Packed symbols replicate their head dim
    (24 heads do not divide a 16-wide model axis); the plan's index fields
    are small and capacity-shaped, so they shard on batch only.  The
    bucketed fields are leaves only when ``resolved_kv_buckets() > 1`` and
    the seq-mesh partition's only when ``mesh_sp > 1`` in seq mode, as the
    plan builder emits them."""
    from repro_torch.core.plan import DispatchPlan
    from repro_torch.core.taylorseer import TaylorState
    if ecfg.cache_mode == "bias":
        taylor_feat = (None, "dp", "sp", "tp")            # (D+1, B, N, dm)
    else:
        taylor_feat = (None, "dp", None, "sp", None)      # (D+1, B, H, N, dh)
    plan = DispatchPlan(
        q_ids=("dp", None, None), q_cnt=("dp", None), q_slots=("dp", None, None),
        kv_ids=("dp", None, None), kv_cnt=("dp", None),
        pair_live=("dp", None, None, None), kv_row_ids=("dp", None, None, None),
        kv_row_cnt=("dp", None, None), row_ids=("dp", None), row_cnt=("dp",),
        head_ids=("dp", None, None), head_cnt=("dp", None), head_mask=("dp", None, None),
        m_ch=("dp", None, None), row_score=("dp", None), occ_hist=("dp", None))
    if ecfg.resolved_kv_buckets() > 1:
        b2 = ("dp", None)
        plan = plan._replace(bkt_head=b2, bkt_q_ids=b2, bkt_q_src=b2, bkt_q_slots=b2,
                             bkt_kv_ids=b2, bkt_kv_cnt=b2, gmo_rows=b2, gmo_src=b2,
                             gmo_head_ids=b2, gmo_head_cnt=b2)
    if ecfg.mesh_sp > 1 and ecfg.mesh_axis == "seq":
        p3, p4 = ("dp", None, None), ("dp", None, None, None)
        p5 = ("dp", None, None, None, None)
        plan = plan._replace(shd_q_ids=p4, shd_q_src=p4, shd_q_slots=p4, shd_q_cnt=p3,
                             shd_kv_ids=p4, shd_kv_cnt=p3, shd_kv_row_ids=p5,
                             shd_kv_row_cnt=p4, shd_gather_idx=p4, shd_send_ids=p5,
                             shd_send_cnt=p4)
    return LayerState(s_c=("dp", None, None), s_s=("dp", None, None),
                      taylor=TaylorState(derivs=taylor_feat, n_updates=()),
                      k_since=(), plan=plan)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _attn_weights(p: dict, cfg: ArchConfig, dtype) -> AttnParams:
    """The block's attention weights as this rank computes with them: its
    heads' shards on a row the head count divides, else whole."""
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    if tp.size() > 1 and not tp.divides(cfg.n_heads, "attention heads"):
        wq, wk, wv, wo = (tp.gather(wq, -1), tp.gather(wk, -1), tp.gather(wv, -1),
                          tp.gather(wo, -2))
    return AttnParams(wq=wq.to(dtype), wk=wk.to(dtype), wv=wv.to(dtype), wo=wo.to(dtype),
                      q_scale=p["q_scale"], k_scale=p["k_scale"])


def _mlp(p: dict, cfg: ArchConfig, xm: torch.Tensor, dtype) -> torch.Tensor:
    """The block's MLP: column-parallel ``mlp_wi``, row-parallel ``mlp_wo``
    summed over the row when the row divides ``d_ff``, else whole."""
    wi, wo = p["mlp_wi"], p["mlp_wo"]
    split = tp.divides(cfg.d_ff, "MLP d_ff")
    if tp.size() > 1 and not split:
        wi, wo = tp.gather(wi, -1), tp.gather(wo, -2)
    y = F.gelu(tp.copy(xm) @ wi.to(dtype), approximate="tanh")   # jax.nn.gelu's default
    y = y @ wo.to(dtype)
    return tp.reduce(y) if split else tp.replicated(y)


def _block(cfg: ArchConfig, ecfg: EngineConfig, p: dict, state: LayerState,
           x: torch.Tensor, t_emb: torch.Tensor, *, mode: str, n_text: int,
           strategy=None, layer_idx=None, step_idx=None, num_steps=None):
    dtype = x.dtype
    ones = torch.ones((cfg.d_model,), device=x.device)
    mod = tp.replicated(F.silu(t_emb) @ p["adaln"].to(dtype) + p["adaln_b"].to(dtype))
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
    xa = tp.copy(_modulate(rms_norm(x, ones, cfg.norm_eps), sh_a, sc_a))
    attn_p = _attn_weights(p, cfg, dtype)
    if mode == "update":
        o, new_state = E.update_layer(attn_p, xa, state, ecfg, n_text=n_text,
                                      heads=cfg.n_heads, strategy=strategy,
                                      layer_idx=layer_idx, step_idx=step_idx,
                                      num_steps=num_steps)
    elif mode == "dispatch":
        o, new_state = E.dispatch_layer(attn_p, xa, state, ecfg, n_text=n_text,
                                        heads=cfg.n_heads)
    elif mode == "dense":   # engine off (baseline)
        h = attn_p.wq.shape[-1] // cfg.hd
        q, k = E._qk(attn_p, xa, h)
        v = E._project_heads(xa, attn_p.wv, h)
        oh = dense_attention(q, k, v)
        o = oh.transpose(1, 2).reshape(*xa.shape[:2], -1) @ attn_p.wo
        o = tp.reduce(o) if h != cfg.n_heads else tp.replicated(o)
        new_state = state
    else:
        raise ValueError(f"unknown denoise mode {mode!r}")
    x = x + g_a[:, None] * o.to(dtype)
    xm = _modulate(rms_norm(x, ones, cfg.norm_eps), sh_m, sc_m)
    return x + g_m[:, None] * _mlp(p, cfg, xm, dtype), new_state


def denoise_step(params: dict, cfg: ArchConfig, ecfg: EngineConfig,
                 states: list[LayerState], x_vision: torch.Tensor,
                 text_emb: torch.Tensor, t: torch.Tensor, *, mode: str,
                 dtype: torch.dtype = torch.bfloat16, layer_strategies=None,
                 strategies: Optional[tuple] = None, strategy_row=None,
                 step_idx: Optional[int] = None, num_steps: Optional[int] = None):
    """One diffusion step: the velocity field for ``x_vision``.

    x_vision (B, N_v, d_model) latent patch embeddings; text_emb
    (B, N_t, d_model); t (B,) diffusion time in [0, 1] (per sample, so
    folded serving lanes may sit at different steps).  ``strategies`` and
    ``strategy_row`` (one id per layer, a schedule's step slice) choose each
    layer's symbol producer at Update steps; ``layer_strategies`` (one spec
    per layer, ``None`` entries falling back to ``ecfg.strategy``) is
    canonicalized into that pair (kept for parity with the reference; no
    caller in the port passes it).  Returns (velocity, new_states).

    ``states`` is consumed: each layer's entry is replaced by its new state
    as soon as the layer has run, so the old one can be freed (at
    hunyuan-video-dit's width two copies of every layer's plan and
    TaylorSeer stack do not fit on the card).  The returned list is
    ``states`` itself.
    """
    if layer_strategies is not None:
        if strategies is not None or strategy_row is not None:
            raise ValueError("pass either layer_strategies or strategies/strategy_row, "
                             "not both")
        strategies, strategy_row = _canonicalize_layer_strategies(layer_strategies, ecfg,
                                                                  cfg.n_layers)
    n_text = text_emb.shape[1]
    x = torch.cat([text_emb.to(dtype), x_vision.to(dtype)], dim=1)
    t_emb = timestep_embedding(t * 1000.0, 256).to(dtype) @ params["t_mlp1"].to(dtype)
    t_emb = (F.silu(t_emb) @ tp.gather(params["t_mlp2"], -1).to(dtype)).to(dtype)

    for li in range(cfg.n_layers):
        strategy = None
        if strategies is not None and mode == "update":
            strategy = strategies[0 if strategy_row is None else int(strategy_row[li])]
        x, st = _block(cfg, ecfg, block(params["blocks"], li), states[li], x, t_emb, mode=mode,
                       n_text=n_text, strategy=strategy, layer_idx=li, step_idx=step_idx,
                       num_steps=num_steps)
        states[li] = st
    mod = tp.replicated(F.silu(t_emb) @ params["final_mod"].to(dtype))
    sh, sc = mod.chunk(2, dim=-1)
    x = _modulate(rms_norm(x, tp.replicated(params["final_norm"]), cfg.norm_eps), sh, sc)
    v = x[:, n_text:] @ tp.replicated(params["final_proj"]).to(dtype)
    return v, states


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Flow-matching training loss (rectified flow): v_θ(x_t, t) ≈ x1 − x0.

    batch: {"latents": (B,N_v,patch_dim) clean targets,
            "patch_emb": (B,N_v,d_model) embedded noisy input,
            "text_emb": (B,N_t,d_model), "t": (B,), "noise": like latents}.
    The engine is off (``mode="dense"``), so the layers never read their
    states and all share one initial state.  With parameters that require
    grad the dense attention takes its differentiable branch.
    """
    ecfg = EngineConfig()
    pe, text = batch["patch_emb"], batch["text_emb"]
    states = init_engine_states(cfg, ecfg, pe.shape[0], text.shape[1] + pe.shape[1],
                                pe.device)
    v, _ = denoise_step(params, cfg, ecfg, states, pe, text, batch["t"], mode="dense",
                        dtype=dtype)
    target = batch["latents"] - batch["noise"]
    return (v.to(torch.float32) - target.to(torch.float32)).square().mean()
