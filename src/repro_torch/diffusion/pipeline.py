"""Text-to-vision diffusion sampler driving the FlashOmni engine, port of
``repro.diffusion.pipeline``.

Rectified-flow Euler sampler: x_{t+dt} = x_t + v_θ(x_t, t)·dt, t: 0 → 1.
The reference compiles the whole loop as one ``lax.scan``; here it is a
Python loop over the schedule's steps, each step one dense / update /
dispatch ``denoise_step``.  The per-step trace reports the paper's density
(Fig. 7) and pair sparsity (Table 1).

The serving ticks of the continuous batcher (:func:`make_lane_tick`,
:func:`make_grouped_lane_tick`) advance lanes by one step each and are
plain eager functions: the reference jits them once per lane shape, the
port compiles nothing.  Lanes are Python lists (latents, text, and the
lane-stacked engine states of :mod:`repro_torch.core.engine`).  A mixed
tick runs each active lane's own single-request step; a grouped tick folds
lanes whose step context is equal into the batch axis and runs one
``denoise_step`` (the reference's ``vmap``; see ``make_grouped_lane_tick``
for what must be equal).  Either way a lane's step is the op sequence of
``sample``'s step on that request.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import (EngineConfig, gather_lane_states, resolve_schedule,
                                     scatter_lane_states)
from repro_torch.core.schedule import MODE_IDLE, MODE_NAMES
from repro_torch.core.strategy import step_strategy_key
from repro_torch.core.symbols import unpack_bits
from repro_torch.models import dit

__all__ = ["SamplerConfig", "sample", "make_lane_tick", "make_grouped_lane_tick",
           "lane_update_key", "step_density", "pair_sparsity"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 50
    dtype: torch.dtype = torch.float32


def _density_device(states, ecfg: EngineConfig, n_tokens: int) -> torch.Tensor:
    """Fig. 7 density as a float64 scalar on the states' device (no host
    sync).  Counted layer by layer, so no stack of every layer's masks is
    formed; the count is exact and the one division is float64's."""
    t = ecfg.mask.n_blocks(n_tokens)
    live = sum(unpack_bits(st.s_c, t).sum(dtype=torch.int64) for st in states)
    return live.double() / (len(states) * states[0].s_c[..., 0].numel() * t)


def _pair_sparsity_device(states, ecfg: EngineConfig, n_tokens: int) -> torch.Tensor:
    t = ecfg.mask.n_blocks(n_tokens)
    live = 0
    for st in states:
        m_s = unpack_bits(st.s_s, t * t).reshape(*st.s_s.shape[:-1], t, t)
        live = live + (m_s & unpack_bits(st.s_c, t)[..., None]).sum(dtype=torch.int64)
    return 1.0 - live.double() / (len(states) * states[0].s_s[..., 0].numel() * t * t)


def step_density(states, ecfg: EngineConfig, n_tokens: int) -> float:
    """Fig. 7 density: fraction of (q-block, head) work still live."""
    return float(_density_device(states, ecfg, n_tokens))


def pair_sparsity(states, ecfg: EngineConfig, n_tokens: int) -> float:
    """Skipped (Q_i K_j, P_ij V_j) pairs / total: feature caching (dead rows)
    and block-sparse skipping together."""
    return float(_pair_sparsity_device(states, ecfg, n_tokens))


def _cat(ts: list) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _step_lanes(params, cfg: ArchConfig, ecfg: EngineConfig, states, xs: list,
                texts: list, patch_embed, *, mode: str, steps: list, num_steps: list,
                strategies, strategy_row, dtype):
    """One Euler step of lanes folded into one batch: ``xs``/``texts`` are the
    lanes' latents and text, ``steps``/``num_steps`` their steps and step
    counts, ``states`` the fold's per-layer states (consumed).  Each lane's
    time, patch embedding and update are formed on its own, as ``sample``
    forms them; the Update strategies see lane 0's step and step count
    (the lanes of an Update fold have one :func:`lane_update_key`, so each
    layer emits the same symbols at every lane's own step).  Returns the lanes' new latents and the
    fold's new states."""
    t = _cat([(torch.full((x.shape[0],), i, dtype=torch.float32, device=x.device)
               * (1.0 / n)).to(dtype) for x, i, n in zip(xs, steps, num_steps)])
    xe = _cat([(x @ patch_embed).to(dtype) for x in xs])
    v, states = dit.denoise_step(params, cfg, ecfg, states, xe, _cat(texts), t, mode=mode,
                                 dtype=dtype, strategies=strategies,
                                 strategy_row=strategy_row, step_idx=steps[0],
                                 num_steps=num_steps[0])
    out, off = [], 0
    for x, n in zip(xs, num_steps):
        out.append(x + v[off:off + x.shape[0]].to(x.dtype) * (1.0 / n))
        off += x.shape[0]
    return out, states


def sample(params: dict, cfg: ArchConfig, ecfg: EngineConfig, *,
           text_emb: torch.Tensor, x0: torch.Tensor, patch_embed: torch.Tensor,
           scfg: SamplerConfig = SamplerConfig(),
           trace: Optional[list] = None, schedule=None,
           layer_strategies: Optional[list] = None,
           force_dense: bool = False, plans: Optional[list] = None) -> torch.Tensor:
    """Run the sampling loop.  x0 (B, N_v, patch_dim) Gaussian noise.

    The schedule is resolved once (:func:`repro_torch.core.engine.
    resolve_schedule`): ``force_dense`` (every step dense: the baseline the
    sparse runs are read against) wins over ``schedule`` (a preset name or a
    prebuilt :class:`~repro_torch.core.schedule.SparsitySchedule`), which
    wins over ``layer_strategies`` (one strategy per layer), which wins over
    ``ecfg.schedule`` / ``ecfg.strategy``.

    ``patch_embed`` (patch_dim, d_model) is the stub patchifier; the
    reference draws its default from a JAX key, so the port takes it as an
    input.  Returns the denoised latents (B, N_v, patch_dim).  ``trace`` (a
    list) receives one ``{step, kind, density, pair_sparsity, seconds}`` dict
    per step (``seconds``: the step's wall time on the host clock);
    ``plans`` (a list) receives each layer's last DispatchPlan.
    """
    b, nv, _ = x0.shape
    n_tokens = nv + text_emb.shape[1]
    n_steps = scfg.num_steps
    sched = resolve_schedule(ecfg, n_steps, cfg.n_layers, schedule=schedule,
                             layer_strategies=layer_strategies,
                             force_dense=force_dense)
    states = dit.init_engine_states(cfg, ecfg, b, n_tokens, x0.device)
    x = x0
    for i in range(n_steps):
        t_step = time.perf_counter()
        mode = MODE_NAMES[int(sched.mode[i])]
        (x,), states = _step_lanes(params, cfg, ecfg, states, [x], [text_emb], patch_embed,
                                   mode=mode, steps=[i], num_steps=[n_steps],
                                   strategies=sched.strategies,
                                   strategy_row=sched.strategy_ids[i], dtype=scfg.dtype)
        if trace is not None:
            entry = {"step": i, "kind": mode,
                     "density": step_density(states, ecfg, n_tokens),
                     "pair_sparsity": pair_sparsity(states, ecfg, n_tokens)}
            # Reading the metrics waited for the device, so this is the step's
            # wall time (its metrics included).
            entry["seconds"] = time.perf_counter() - t_step
            trace.append(entry)
    if plans is not None:
        plans.extend(st.plan for st in states)
    return x


def _lane_metrics(states, ecfg, n_tokens, with_metrics: bool, device):
    """(density, pair sparsity) of one lane as float64 device scalars, or
    exact zeros when metrics are off or the lane did no work."""
    if states is None or not with_metrics:
        zero = torch.zeros((), dtype=torch.float64, device=device)
        return zero, zero
    return (_density_device(states, ecfg, n_tokens),
            _pair_sparsity_device(states, ecfg, n_tokens))


def lane_update_key(strategies: tuple, id_row, step: int, num_steps: int) -> tuple:
    """What an Update step computes beyond the lane's state: per layer, the
    :func:`~repro_torch.core.strategy.step_strategy_key` of the strategy its
    id row picks, at the lane's own step and step count.  Only
    ``step-phased`` strategies read the step, so lanes at different steps
    or step counts share a key unless their phases differ."""
    return tuple(step_strategy_key(strategies[int(i)], int(step), int(num_steps))
                 for i in id_row)


def make_lane_tick(cfg: ArchConfig, ecfg: EngineConfig, scfg: SamplerConfig,
                   strategies: tuple, with_metrics: bool = True):
    """The continuous batcher's mixed tick: every active lane advances by its
    own single-request step, in lane order.

        tick(params, patch_embed, x, states, text_emb, step, mode_tab, id_tab,
             nsteps, active) -> (x', states', density, pair_sparsity)

    ``x``/``text_emb`` are lists over lanes of (B, N_v, patch_dim) latents and
    (B, N_t, d_model) text; ``states`` the lane-stacked engine states.  The
    ``x`` and ``states`` lists are consumed: updated in place and returned,
    so a lane's old state is freed as its new one is made.  ``step``/``nsteps``/
    ``active`` (lanes,) host arrays of each lane's step, step count and
    residency; ``mode_tab`` (lanes, S) / ``id_tab`` (lanes, S, L) the stacked
    schedule tables (:func:`repro_torch.core.schedule.stack_schedules`) over
    ``strategies``.  Inactive lanes and ``MODE_IDLE`` padding pass through and
    report metrics of exactly zero; ``density``/``pair_sparsity`` are (lanes,)
    float64 tensors on the latents' device, read by the caller when it syncs.
    ``with_metrics=False`` skips the reductions (zeros)."""

    def tick(params, patch_embed, x, states, text_emb, step, mode_tab, id_tab, nsteps,
             active):
        dens, ps = [], []
        for w in range(len(x)):
            s_max = mode_tab.shape[1]
            mode = int(mode_tab[w, min(int(step[w]), s_max - 1)]) if active[w] else MODE_IDLE
            done, n_tokens = None, 0
            if mode != MODE_IDLE:
                n_tokens = x[w].shape[1] + text_emb[w].shape[1]
                (x[w],), done = _step_lanes(
                    params, cfg, ecfg, states[w], [x[w]], [text_emb[w]], patch_embed,
                    mode=MODE_NAMES[mode], steps=[int(step[w])], num_steps=[int(nsteps[w])],
                    strategies=strategies, strategy_row=id_tab[w, int(step[w])],
                    dtype=scfg.dtype)
                states[w] = done
            d, p = _lane_metrics(done, ecfg, n_tokens, with_metrics, patch_embed.device)
            dens.append(d)
            ps.append(p)
        return x, states, torch.stack(dens), torch.stack(ps)

    return tick


def make_grouped_lane_tick(cfg: ArchConfig, ecfg: EngineConfig, scfg: SamplerConfig,
                           strategies: tuple, with_metrics: bool = True) -> dict:
    """The batched mode-group bodies: ``{"dense", "update", "dispatch"}`` ->

        body(params, patch_embed, x, states, text_emb, step, id_rows, nsteps,
             lane_mask) -> (x', states', density, pair_sparsity)

    Arguments as :func:`make_lane_tick`'s, with ``id_rows`` (lanes, L) each
    lane's strategy-id row at its own step and ``lane_mask`` (lanes,) bool
    the group.  The group's lanes fold into the batch axis
    (:func:`~repro_torch.core.engine.gather_lane_states`) for ONE
    ``denoise_step`` in the body's mode, then split back into lanes of their
    own tensors; lanes outside the group pass through with metrics of
    exactly zero.

    What must be equal for lanes to fold: the reference ``vmap``s per-lane
    context into the body, but here ``LayerState.k_since`` and
    ``taylor.n_updates`` are one Python int per layer (``taylorseer.
    forecast`` takes ``k_since`` as a scalar) and ``denoise_step`` takes one
    strategy row, one ``step_idx`` and one ``num_steps``.  So the lanes of a
    group must share their shapes and every layer's ``(k_since,
    n_updates)``, and at Update also their :func:`lane_update_key` (each
    layer's strategy as it emits at the lane's own step); a body given lanes
    that differ raises ``ValueError``.  The time ``t`` is per sample and each
    lane's Euler update uses its own ``dt``, so groups may mix steps and
    step counts."""

    def make(mode: str):
        def body(params, patch_embed, x, states, text_emb, step, id_rows, nsteps,
                 lane_mask):
            lanes = [w for w in range(len(x)) if lane_mask[w]]
            if mode == "update" and len({lane_update_key(strategies, id_rows[w], step[w],
                                                         nsteps[w]) for w in lanes}) != 1:
                raise ValueError(f"the lanes {lanes} of an Update group pick different "
                                 f"strategies at their steps {[int(step[w]) for w in lanes]}")
            fold = gather_lane_states(states, lanes)
            for w in lanes:       # the fold holds the lanes' states now: free them
                states[w] = None
            new_x, fold = _step_lanes(
                params, cfg, ecfg, fold, [x[w] for w in lanes], [text_emb[w] for w in lanes],
                patch_embed, mode=mode, steps=[int(step[w]) for w in lanes],
                num_steps=[int(nsteps[w]) for w in lanes], strategies=strategies,
                strategy_row=id_rows[lanes[0]], dtype=scfg.dtype)
            states[:] = scatter_lane_states(states, lanes, fold)
            n_tokens = new_x[0].shape[1] + text_emb[lanes[0]].shape[1]
            dens, ps = [], []
            for w in range(len(x)):
                if lane_mask[w]:
                    x[w] = new_x[lanes.index(w)]
                d, p = _lane_metrics(states[w] if lane_mask[w] else None, ecfg, n_tokens,
                                     with_metrics, patch_embed.device)
                dens.append(d)
                ps.append(p)
            return x, states, torch.stack(dens), torch.stack(ps)

        return body

    return {"dense": make("dense"), "update": make("update"), "dispatch": make("dispatch")}
