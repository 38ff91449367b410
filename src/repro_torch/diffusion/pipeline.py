"""Text-to-vision diffusion sampler driving the FlashOmni engine, port of
``repro.diffusion.pipeline.sample``.

Rectified-flow Euler sampler: x_{t+dt} = x_t + v_θ(x_t, t)·dt, t: 0 → 1.
The reference compiles the whole loop as one ``lax.scan``; here it is a
Python loop over the schedule's steps, each step one dense / update /
dispatch ``denoise_step``.  The per-step trace reports the paper's density
(Fig. 7) and pair sparsity (Table 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import EngineConfig, resolve_schedule
from repro_torch.core.schedule import MODE_NAMES
from repro_torch.core.symbols import unpack_bits
from repro_torch.models import dit

__all__ = ["SamplerConfig", "sample", "step_density", "pair_sparsity"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 50
    dtype: torch.dtype = torch.float32


def step_density(states, ecfg: EngineConfig, n_tokens: int) -> float:
    """Fig. 7 density: fraction of (q-block, head) work still live.  Counted
    layer by layer, so no stack of every layer's masks is formed."""
    t = ecfg.mask.n_blocks(n_tokens)
    live = sum(unpack_bits(st.s_c, t).sum(dtype=torch.int64) for st in states)
    return int(live) / (len(states) * states[0].s_c[..., 0].numel() * t)


def pair_sparsity(states, ecfg: EngineConfig, n_tokens: int) -> float:
    """Skipped (Q_i K_j, P_ij V_j) pairs / total: feature caching (dead rows)
    and block-sparse skipping together.  Counted layer by layer."""
    t = ecfg.mask.n_blocks(n_tokens)
    live = 0
    for st in states:
        m_s = unpack_bits(st.s_s, t * t).reshape(*st.s_s.shape[:-1], t, t)
        live = live + (m_s & unpack_bits(st.s_c, t)[..., None]).sum(dtype=torch.int64)
    return 1.0 - int(live) / (len(states) * states[0].s_s[..., 0].numel() * t * t)


def sample(params: dict, cfg: ArchConfig, ecfg: EngineConfig, *,
           text_emb: torch.Tensor, x0: torch.Tensor, patch_embed: torch.Tensor,
           scfg: SamplerConfig = SamplerConfig(),
           trace: Optional[list] = None, schedule=None,
           layer_strategies: Optional[list] = None,
           force_dense: bool = False) -> torch.Tensor:
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
    per step (``seconds``: the step's wall time on the host clock).
    """
    b, nv, _ = x0.shape
    n_tokens = nv + text_emb.shape[1]
    n_steps = scfg.num_steps
    sched = resolve_schedule(ecfg, n_steps, cfg.n_layers, schedule=schedule,
                             layer_strategies=layer_strategies,
                             force_dense=force_dense)
    states = dit.init_engine_states(cfg, ecfg, b, n_tokens, x0.device)
    dt = 1.0 / n_steps
    x = x0
    for i in range(n_steps):
        t_step = time.perf_counter()
        mode = MODE_NAMES[int(sched.mode[i])]
        t = (torch.full((b,), i, dtype=torch.float32, device=x0.device) * dt).to(scfg.dtype)
        xe = (x @ patch_embed).to(scfg.dtype)
        v, states = dit.denoise_step(params, cfg, ecfg, states, xe, text_emb, t,
                                     mode=mode, dtype=scfg.dtype,
                                     strategies=sched.strategies,
                                     strategy_row=sched.strategy_ids[i],
                                     step_idx=i, num_steps=n_steps)
        x = x + v.to(x.dtype) * dt
        if trace is not None:
            entry = {"step": i, "kind": mode,
                     "density": step_density(states, ecfg, n_tokens),
                     "pair_sparsity": pair_sparsity(states, ecfg, n_tokens)}
            # Reading the metrics waited for the device, so this is the step's
            # wall time (its metrics included).
            entry["seconds"] = time.perf_counter() - t_step
            trace.append(entry)
    return x
