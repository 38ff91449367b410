"""Diffusion serving launcher, port of ``repro.launch.serve.serve_diffusion``
(sequential serving).

Text-to-vision requests run through the FlashOmni Update–Dispatch sampler
on one CUDA device; the three Dispatch stages launch the Hopper kernels.
Weights, latents, text embeddings and the stub patchifier are random, drawn
from ``torch.Generator``s seeded from ``seed``.

    python -m repro_torch.launch.serve --arch flux-mmdit --full --steps 8
    python -m repro_torch.launch.serve --full --strategy sliding-window --kv-buckets 0
    python -m repro_torch.launch.serve --schedule hunyuan-1.5x --kv-buckets 3
    python -m repro_torch.launch.serve --arch hunyuan-video-dit --full \
        --n-vision 32768 --batch 1 --requests 1 --steps 8 --schedule hunyuan-1.5x
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.core.engine import EngineConfig
from repro_torch.core.masks import MaskConfig
from repro_torch.core.schedule import available_schedules
from repro_torch.core.strategy import available_strategies
from repro_torch.launch.batching import Request, run_sequential
from repro_torch.models import dit

__all__ = ["serve_diffusion", "serving_engine_config", "serving_inputs", "resolve_device"]


def serving_engine_config(strategy: str = "flashomni", kv_buckets: int = 1) -> EngineConfig:
    """The serving engine config of the reference launcher (serve.py:76-78);
    ``kv_buckets`` 0 (auto), 2 or 3 selects the bucketed Dispatch layout."""
    return EngineConfig(mask=MaskConfig(
        tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
        block_q=16, block_kv=16, pool=32, warmup_steps=2),
        strategy=strategy, kv_buckets=kv_buckets)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain versions on the CPU")
    return device


def serving_inputs(cfg, *, n_vision: int, batch: int, num_requests: int,
                   num_steps: int, schedule: str = None, seed: int = 0, device="cuda"):
    """``(params, patch_embed, requests)`` of :func:`serve_diffusion`: the
    weights and the stub patchifier from ``seed``, request ``i``'s latents
    and text from ``seed + 100 + i``.  A dense baseline run on these inputs
    sees the same weights and noise as the served one."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = dit.init_params(cfg, gen, device)
    patch_embed = torch.randn((cfg.patch_dim, cfg.d_model), generator=gen,
                              device=device).mul_(0.2)
    requests = []
    for req in range(num_requests):
        gen.manual_seed(seed + 100 + req)
        x0 = torch.randn((batch, n_vision, cfg.patch_dim), generator=gen, device=device)
        text = torch.randn((batch, cfg.n_text_tokens, cfg.d_model), generator=gen,
                           device=device)
        requests.append(Request(rid=req, x0=x0, text_emb=text, num_steps=num_steps,
                                schedule=schedule))
    return params, patch_embed, requests


def serve_diffusion(arch: str, *, smoke: bool = True, num_requests: int = 2,
                    batch: int = 2, n_vision: int = 96, num_steps: int = 12,
                    strategy: str = "flashomni", schedule: str = None,
                    kv_buckets: int = 1, serving: str = "sequential",
                    mesh: tuple = (1, 1), seed: int = 0, device="cuda",
                    verbose: bool = True) -> dict:
    """Queue-driven diffusion serving.  ``schedule`` names a SparsitySchedule
    preset (e.g. ``hunyuan-1.5x``) that overrides the per-step mapping of
    ``strategy``; ``kv_buckets`` picks the Dispatch layout (see
    :func:`serving_engine_config`).  Returns the per-request result dict of
    :func:`repro_torch.launch.batching.run_sequential`."""
    if serving != "sequential":
        raise NotImplementedError(f"serving mode {serving!r} is not ported yet; "
                                  "the port serves 'sequential'")
    if tuple(mesh) != (1, 1):
        raise NotImplementedError(f"mesh {mesh} is not ported yet; the port runs on "
                                  "one device")
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    ecfg = serving_engine_config(strategy, kv_buckets)
    params, patch_embed, requests = serving_inputs(
        cfg, n_vision=n_vision, batch=batch, num_requests=num_requests,
        num_steps=num_steps, schedule=schedule, seed=seed, device=device)
    t0 = time.perf_counter()
    results = run_sequential(params, cfg, ecfg, requests, patch_embed=patch_embed)
    wall = time.perf_counter() - t0
    if verbose:
        for req in requests:
            r = results[req.rid]
            dens = [s["density"] for s in r["trace"] if s["kind"] == "dispatch"]
            dtxt = f"mean dispatch density {sum(dens) / len(dens):.3f}  " if dens else ""
            print(f"[serve] req {req.rid} ({schedule or strategy}, {serving}): {req.num_steps} "
                  f"steps, latency {r['latency']:.2f}s  {dtxt}out "
                  f"{tuple(r['out'].shape)} finite={bool(torch.isfinite(r['out']).all())}")
        print(f"[serve] {serving}: {len(requests)} requests in {wall:.2f}s on {device}")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flux-mmdit")
    ap.add_argument("--full", action="store_true", help="full model width")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n-vision", type=int, default=None,
                    help="vision tokens (default: 96 smoke, 4096 full; the paper's "
                         "hunyuan-video-dit cell is 32768)")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--strategy", default="flashomni", choices=available_strategies(),
                    help="sparse-symbol producer")
    ap.add_argument("--schedule", default=None, choices=available_schedules(),
                    help="named SparsitySchedule preset (overrides the --strategy "
                         "per-step mapping)")
    ap.add_argument("--kv-buckets", type=int, default=1, choices=(0, 1, 2, 3),
                    help="Dispatch layout: 1 uniform, 2 or 3 occupancy buckets, "
                         "0 the calibrated choice for --strategy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n_vision = args.n_vision or (4096 if args.full else 96)
    serve_diffusion(args.arch, smoke=not args.full, num_requests=args.requests,
                    batch=args.batch, n_vision=n_vision, num_steps=args.steps,
                    strategy=args.strategy, schedule=args.schedule,
                    kv_buckets=args.kv_buckets, device=args.device)


if __name__ == "__main__":
    main()
