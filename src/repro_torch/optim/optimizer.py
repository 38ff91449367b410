"""AdamW with global-norm clipping and a cosine schedule, port of
``repro.optim.optimizer``.

The state is ``{"mu": tree, "nu": tree, "step": int32 scalar}`` over the
port's nested parameter dicts; :func:`adamw_update` is out of place under
``torch.no_grad`` and runs the reference's float32 operations in the
reference's order.  :func:`adamw_state_specs` lays the moments out like the
parameters (ZeRO falls out of the sharding rules):
:mod:`repro_torch.launch.steps` runs :func:`adamw_update` on each rank's
shards and passes the gradient norm of the whole tree in ``gnorm``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_state_specs", "adamw_update", "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # bf16 moments halve the moments' memory; the update still runs in f32
    # and the moments are rounded back after it.
    moment_dtype: str = "float32"          # "float32" | "bfloat16"


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def adamw_init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> Any:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_state_specs(param_specs: Any) -> Any:
    """The logical specs of :func:`adamw_init`'s state: each moment laid out
    like its parameter, the step count replicated."""
    is_spec = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                                     for e in x)
    ident = tree_map(lambda s: s, param_specs, is_leaf=is_spec)
    return {"mu": ident, "nu": ident, "step": ()}


@torch.no_grad()
def adamw_update(grads: Any, state: Any, params: Any, cfg: AdamWConfig,
                 gnorm: torch.Tensor | None = None):
    """Returns (new_params, new_state, grad_norm).  ``gnorm``: the global
    gradient norm, when ``grads`` are one rank's shards of a larger tree;
    by default the norm of ``grads``."""
    flat_p, tdef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_mu = tree_flatten(state["mu"])[0]
    flat_nu = tree_flatten(state["nu"])[0]
    if gnorm is None:
        gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in flat_g))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu_f = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
        nu_f = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * g.square()
        update = (mu_f / b1c) / (torch.sqrt(nu_f / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        newp = p32 - lr * (update + cfg.weight_decay * p32)
        return newp.to(p.dtype), mu_f.to(mu.dtype), nu_f.to(nu.dtype)

    out = [upd(p, g, m, n) for p, g, m, n in zip(flat_p, flat_g, flat_mu, flat_nu)]
    new_p = tree_unflatten(tdef, [o[0] for o in out])
    new_mu = tree_unflatten(tdef, [o[1] for o in out])
    new_nu = tree_unflatten(tdef, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm
