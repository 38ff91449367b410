"""Request queue serving, port of the sequential baseline of
``repro.launch.batching``.

:func:`run_sequential` serves requests strictly one after another in
arrival order, each through its own ``pipeline.sample`` call.  Stacked and
continuous batching are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.diffusion.pipeline import SamplerConfig, sample

__all__ = ["Request", "run_sequential"]


@dataclasses.dataclass
class Request:
    """One text-to-vision serving request.

    ``x0`` (B, N_v, patch_dim) Gaussian latents; ``text_emb`` (B, N_t,
    d_model); ``schedule`` / ``layer_strategies`` feed
    :func:`repro_torch.core.engine.resolve_schedule` against the server's
    shared ``EngineConfig`` (``None``: the config's own mapping);
    ``arrival`` is seconds since the serving clock's start.
    """

    rid: Any
    x0: torch.Tensor
    text_emb: torch.Tensor
    num_steps: int
    schedule: Any = None
    layer_strategies: Any = None
    arrival: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sequential(params: dict, cfg: ArchConfig, ecfg: EngineConfig, requests, *,
                   patch_embed: torch.Tensor,
                   scfg_dtype: torch.dtype = torch.float32) -> dict:
    """Serve ``requests`` one at a time in ``scfg_dtype`` (float32, the
    reference's serving dtype, or bfloat16).  Returns ``{rid: {out, trace,
    finish, latency}}`` with times in seconds on the host clock, each
    request's end taken after the device finished its work."""
    results: dict = {}
    t0 = time.perf_counter()
    for req in sorted(requests, key=lambda r: r.arrival):
        now = time.perf_counter() - t0
        if now < req.arrival:
            time.sleep(req.arrival - now)
        trace: list = []
        out = sample(params, cfg, ecfg, text_emb=req.text_emb, x0=req.x0,
                     patch_embed=patch_embed,
                     scfg=SamplerConfig(num_steps=req.num_steps, dtype=scfg_dtype),
                     trace=trace, schedule=req.schedule,
                     layer_strategies=req.layer_strategies)
        _sync(out.device)
        finish = time.perf_counter() - t0
        results[req.rid] = {"out": out, "trace": trace, "finish": finish,
                            "latency": finish - req.arrival}
    return results
