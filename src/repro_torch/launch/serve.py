"""Diffusion serving launcher, port of ``repro.launch.serve.serve_diffusion``.

Text-to-vision requests run through the FlashOmni Update–Dispatch sampler
on one CUDA device; the three Dispatch stages launch the Hopper kernels.
Weights, latents, text embeddings and the stub patchifier are random, drawn
from ``torch.Generator``s seeded from ``seed``.  Three serving modes, from
:mod:`repro_torch.launch.batching`:

  * ``sequential``: one request at a time (the baseline);
  * ``stacked``: requests of one shape, step count and schedule stack on
    the batch axis into one sampler call;
  * ``continuous``: ``--lanes`` requests resident at once, each lane
    advancing one step a tick, retiring and refilling from the queue; ticks
    whose lanes share their step context fold them into one batch.
    ``--shape-buckets`` rounds near-miss ``N_v`` up to canonical lane sizes;
    the lane-bucket map is printed after the run.

``--arrival-interval`` spaces the requests' arrivals (latency counts from
arrival), ``--mixed-steps`` alternates step counts (``steps`` and
``3·steps//4``), ``--mixed-shapes`` vision lengths (``n_vision`` and
``n_vision − pool``).

``--mesh DP,SP`` serves across a ``(data, seq)`` mesh of
``torch.distributed`` ranks (plan-sharded Dispatch,
:mod:`repro_torch.distributed.plan_shard`) and runs under ``torchrun`` with
``DP·SP`` processes; ``--transport`` picks the process groups' backend:
``nccl`` with one card per rank, ``gloo`` where ranks share a card or run
on the CPU.  Every rank serves the same requests and holds the same
latents; rank 0 prints.

    python -m repro_torch.launch.serve --arch flux-mmdit --full --steps 8
    python -m repro_torch.launch.serve --full --batch 1 --requests 6 --steps 8 \
        --serving continuous --lanes 4 --mixed-steps
    python -m repro_torch.launch.serve --serving stacked --device cpu
    python -m repro_torch.launch.serve --full --strategy sliding-window --kv-buckets 0
    python -m repro_torch.launch.serve --schedule hunyuan-1.5x --kv-buckets 3
    python -m repro_torch.launch.serve --arch hunyuan-video-dit --full \
        --n-vision 32768 --batch 1 --requests 1 --steps 8 --schedule hunyuan-1.5x
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1,2 \
        --transport gloo --full --requests 1 --steps 8

``--kind lm`` (the default for every family but ``dit``: dense, MoE, ssm,
hybrid, encdec and vlm) runs :func:`serve_lm`, the reference's LM loop: a
teacher-forced prefill through ``decode_step``, then greedy decode, with
caches and compute in float32.  ``--full`` takes the published config and
refuses, before allocating, an arch whose f32 parameters do not fit the
card's free memory (llama3-405b, mixtral-8x22b on one H100):

    python -m repro_torch.launch.serve --kind lm --arch gemma3-1b --device cpu
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full
    python -m repro_torch.launch.serve --kind lm --arch mamba2-370m --full
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.core.engine import EngineConfig
from repro_torch.core.masks import MaskConfig
from repro_torch.core.schedule import available_schedules
from repro_torch.core.strategy import available_strategies
from repro_torch.launch.batching import (ContinuousBatcher, Request, run_sequential,
                                         run_stacked)
from repro_torch.models import dit
from repro_torch.models.registry import LM_FAMILIES, get_model, param_count

__all__ = ["serve_diffusion", "serve_lm", "serving_engine_config", "serving_inputs",
           "resolve_device", "check_params_fit", "SERVING_MODES"]

SERVING_MODES = ("sequential", "stacked", "continuous")


def serving_engine_config(strategy: str = "flashomni", kv_buckets: int = 1,
                          mesh: tuple = (1, 1)) -> EngineConfig:
    """The serving engine config of the reference launcher (serve.py:76-78);
    ``kv_buckets`` 0 (auto), 2 or 3 selects the bucketed Dispatch layout,
    ``mesh`` ``(dp, sp)`` the plan-sharded Dispatch's mesh."""
    return EngineConfig(mask=MaskConfig(
        tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
        block_q=16, block_kv=16, pool=32, warmup_steps=2),
        strategy=strategy, kv_buckets=kv_buckets, mesh_dp=mesh[0], mesh_sp=mesh[1])


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain versions on the CPU")
    return device


def serving_inputs(cfg, *, n_vision: int, batch: int, num_requests: int,
                   num_steps: int, schedule: str = None, seed: int = 0, device="cuda",
                   arrival_interval: float = 0.0, mixed_steps: bool = False,
                   mixed_shapes: bool = False):
    """``(params, patch_embed, requests)`` of :func:`serve_diffusion`: the
    weights and the stub patchifier from ``seed``, request ``i``'s latents
    and text from ``seed + 100 + i``.  A dense baseline run on these inputs
    sees the same weights and noise as the served one.  Request ``i``
    arrives at ``i · arrival_interval``; with ``mixed_steps`` the odd
    requests take ``max(3·num_steps//4, 1)`` steps, with ``mixed_shapes``
    ``max(n_vision − pool, pool)`` vision tokens (pool of
    :func:`serving_engine_config`)."""
    pool = serving_engine_config().mask.pool
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = dit.init_params(cfg, gen, device)
    patch_embed = torch.randn((cfg.patch_dim, cfg.d_model), generator=gen,
                              device=device).mul_(0.2)
    requests = []
    for req in range(num_requests):
        odd = req % 2 == 1
        nv = max(n_vision - pool, pool) if mixed_shapes and odd else n_vision
        gen.manual_seed(seed + 100 + req)
        x0 = torch.randn((batch, nv, cfg.patch_dim), generator=gen, device=device)
        text = torch.randn((batch, cfg.n_text_tokens, cfg.d_model), generator=gen,
                           device=device)
        requests.append(Request(
            rid=req, x0=x0, text_emb=text, schedule=schedule, arrival=req * arrival_interval,
            num_steps=max(3 * num_steps // 4, 1) if mixed_steps and odd else num_steps))
    return params, patch_embed, requests


def serve_diffusion(arch: str, *, smoke: bool = True, num_requests: int = 2,
                    batch: int = 2, n_vision: int = 96, num_steps: int = 12,
                    strategy: str = "flashomni", schedule: str = None,
                    kv_buckets: int = 1, serving: str = "sequential", lanes: int = 4,
                    arrival_interval: float = 0.0, mixed_steps: bool = False,
                    mixed_shapes: bool = False, shape_buckets=None,
                    mesh: tuple = (1, 1), seed: int = 0, device="cuda",
                    verbose: bool = True, keep_plans: bool = False) -> dict:
    """Queue-driven diffusion serving in one of :data:`SERVING_MODES` (see
    the module docstring).  ``schedule`` names a SparsitySchedule preset
    (e.g. ``hunyuan-1.5x``) that overrides the per-step mapping of
    ``strategy``; ``kv_buckets`` picks the Dispatch layout (see
    :func:`serving_engine_config`); ``arrival_interval``, ``mixed_steps`` and
    ``mixed_shapes`` shape the requests (:func:`serving_inputs`);
    ``lanes`` and ``shape_buckets`` (default with ``mixed_shapes``:
    ``(n_vision,)``, so the near-miss shape folds in) go to the continuous
    batcher.  ``mesh`` ``(dp, sp)`` other than ``(1, 1)`` serves across the
    already initialised ``torch.distributed`` world of ``dp·sp`` ranks
    (raises without one); every rank serves the same requests, and only
    rank 0 prints.  Returns the per-request result dict of
    :mod:`repro_torch.launch.batching` (with ``keep_plans``, each request's
    last DispatchPlan of every layer too)."""
    if serving not in SERVING_MODES:
        raise ValueError(f"unknown serving mode {serving!r}; expected one of "
                         f"{SERVING_MODES}")
    if tuple(mesh) != (1, 1):
        from repro_torch.launch.mesh import make_engine_mesh
        make_engine_mesh(*mesh)                       # the world must be there
        verbose = verbose and dist.get_rank() == 0
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    ecfg = serving_engine_config(strategy, kv_buckets, mesh=tuple(mesh))
    params, patch_embed, requests = serving_inputs(
        cfg, n_vision=n_vision, batch=batch, num_requests=num_requests,
        num_steps=num_steps, schedule=schedule, seed=seed, device=device,
        arrival_interval=arrival_interval, mixed_steps=mixed_steps,
        mixed_shapes=mixed_shapes)
    extra = ""
    t0 = time.perf_counter()
    if serving == "continuous":
        if shape_buckets is None and mixed_shapes:
            shape_buckets = (n_vision,)
        batcher = ContinuousBatcher(params, cfg, ecfg, patch_embed=patch_embed, lanes=lanes,
                                    shape_buckets=shape_buckets, keep_plans=keep_plans)
        batcher.submit_all(requests)
        results = batcher.run()
        st = batcher.stats
        extra = (f"  ticks {st['ticks']} ({st['grouped_ticks']} grouped/"
                 f"{st['scan_ticks']} scan)")
    elif serving == "stacked":
        results = run_stacked(params, cfg, ecfg, requests, patch_embed=patch_embed,
                              keep_plans=keep_plans)
    else:
        results = run_sequential(params, cfg, ecfg, requests, patch_embed=patch_embed,
                                 keep_plans=keep_plans)
    wall = time.perf_counter() - t0
    if verbose:
        if serving == "continuous":
            # Lane-bucket map: which admitted shape folded into which lane shape.
            print(f"[serve] lane shape buckets ({st['shape_partitions']} partition(s)):")
            for orig, canon in sorted(st["shape_buckets"].items()):
                print(f"[serve]   x0 {orig[0]} {'=' if orig == canon else '->'} lane "
                      f"{canon[0]}")
        for req in requests:
            r = results[req.rid]
            dens = [s["density"] for s in (r["trace"] or []) if s["kind"] == "dispatch"]
            dtxt = f"mean dispatch density {sum(dens) / len(dens):.3f}  " if dens else ""
            print(f"[serve] req {req.rid} ({schedule or strategy}, {serving}): {req.num_steps} "
                  f"steps, latency {r['latency']:.2f}s  {dtxt}out "
                  f"{tuple(r['out'].shape)} finite={bool(torch.isfinite(r['out']).all())}")
        print(f"[serve] {serving}: {len(requests)} requests in {wall:.2f}s "
              f"({len(requests) / max(wall, 1e-9):.2f} req/s) on {device}{extra}")
    return results


def check_params_fit(cfg, free_bytes: int) -> None:
    """Raise ``ValueError`` when ``cfg``'s f32 parameters, reckoned from
    their shapes, do not fit in ``free_bytes`` of device memory."""
    need = param_count(cfg) * 4
    if need > free_bytes:
        raise ValueError(
            f"{cfg.name} needs {need} bytes ({need / 1e9:.1f} GB) of f32 parameters "
            f"(4 B x {need // 4} parameters, reckoned from their shapes); the card has "
            f"{free_bytes / 1e9:.1f} GB free")


def serve_lm(arch: "str | ArchConfig", *, smoke: bool = True, batch: int = 2,
             prompt_len: int = 32, gen_len: int = 16, max_len: int = 64, seed: int = 0,
             device="cuda", params: dict = None, prompt: torch.Tensor = None) -> torch.Tensor:
    """The reference's LM serving loop (serve.py:147-173) for every family
    but ``dit``: the prompt goes through ``decode_step`` token by token (a
    teacher-forced prefill), then ``gen_len`` tokens are decoded greedily
    (``argmax``, the first maximum on a tie), with an f32 cache of
    ``max_len`` slots and f32 compute.  As in the reference, encdec and vlm
    decode against cross K/V that nothing fills (zeros; ROADMAP C.11).  The
    weights come from a ``torch.Generator`` seeded ``seed`` and the prompt
    from one seeded ``seed + 1`` unless ``params`` or ``prompt`` (B, S) is
    given.  ``arch`` names an arch (its smoke config, or with ``smoke=False``
    its published one) or is an :class:`ArchConfig` itself (``smoke`` then
    unread).  With ``smoke=False`` on the card, an arch whose f32 parameters
    do not fit the free memory is refused before anything is allocated.
    Returns the generated tokens (B, gen_len) int32 and prints one line."""
    device = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_smoke(arch) if smoke else get_config(arch)
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.name} is a {cfg.family!r} model; serve_lm runs {LM_FAMILIES}")
    if device.type == "cuda" and params is None:
        check_params_fit(cfg, torch.cuda.mem_get_info(device)[0])
    model = get_model(cfg)
    gen = torch.Generator(device=device)
    if params is None:
        gen.manual_seed(seed)
        params = model.init_params(gen, device)
    if prompt is None:
        gen.manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                               device=device, dtype=torch.int32)
    batch, prompt_len = prompt.shape
    cache = model.init_cache(batch, max_len, torch.float32, device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(prompt_len - 1):
            _, cache = model.decode_step(params, cache, prompt[:, i], i, dtype=torch.float32)
        tok, generated = prompt[:, -1], []
        for i in range(gen_len):
            logits, cache = model.decode_step(params, cache, tok, prompt_len - 1 + i,
                                              dtype=torch.float32)
            tok = logits.argmax(dim=-1).to(torch.int32)
            generated.append(tok)
        out = torch.stack(generated, dim=1)
        first = out[0, :8].tolist()                  # waits for the device
    print(f"[serve] {cfg.name}: prefill {prompt_len} + decode {gen_len} in "
          f"{time.perf_counter() - t0:.2f}s on {device} -> tokens {first}...")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flux-mmdit")
    ap.add_argument("--kind", default=None, choices=("lm", "diffusion"),
                    help="lm: serve_lm; diffusion: serve_diffusion (default: the "
                         "kind of --arch's family)")
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
    ap.add_argument("--serving", default="sequential", choices=SERVING_MODES,
                    help="serving mode (see the module docstring)")
    ap.add_argument("--lanes", type=int, default=4,
                    help="continuous batcher: requests resident at once")
    ap.add_argument("--arrival-interval", type=float, default=0.0,
                    help="seconds between request arrivals")
    ap.add_argument("--mixed-steps", action="store_true",
                    help="alternate request step counts (steps and 3*steps//4)")
    ap.add_argument("--mixed-shapes", action="store_true",
                    help="alternate request vision lengths (n_vision and n_vision - pool)")
    ap.add_argument("--shape-buckets", type=int, nargs="*", default=None,
                    help="continuous batcher: canonical N_v lane sizes (near-miss "
                         "shapes round up)")
    ap.add_argument("--mesh", default="1,1",
                    help="DP,SP: plan-sharded Dispatch across DP*SP torchrun ranks")
    ap.add_argument("--transport", default=None, choices=("nccl", "gloo"),
                    help="the mesh's process-group backend (default: nccl on the "
                         "card, gloo on the CPU); ranks sharing a card need gloo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kind = args.kind or ("lm" if get_config(args.arch).family in LM_FAMILIES else "diffusion")
    if kind == "lm":
        if args.mesh != "1,1":
            ap.error("--mesh serves --kind diffusion only")
        serve_lm(args.arch, smoke=not args.full, batch=args.batch, device=args.device)
        return
    n_vision = args.n_vision or (4096 if args.full else 96)
    mesh = tuple(int(a) for a in args.mesh.split(","))
    device = args.device
    if mesh != (1, 1):
        transport = args.transport or ("nccl" if device == "cuda" else "gloo")
        if transport == "nccl" and device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        dist.init_process_group(transport)           # torchrun's env:// variables
    try:
        serve_diffusion(args.arch, smoke=not args.full, num_requests=args.requests,
                        batch=args.batch, n_vision=n_vision, num_steps=args.steps,
                        strategy=args.strategy, schedule=args.schedule,
                        kv_buckets=args.kv_buckets, serving=args.serving, lanes=args.lanes,
                        arrival_interval=args.arrival_interval, mixed_steps=args.mixed_steps,
                        mixed_shapes=args.mixed_shapes,
                        shape_buckets=tuple(args.shape_buckets) if args.shape_buckets else None,
                        mesh=mesh, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
