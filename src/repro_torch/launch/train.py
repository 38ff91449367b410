"""Training launcher, port of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch flux-mmdit [--steps N] [--full]
        [--batch B] [--seq-len N] [--compress int8|topk] [--device cpu]

The loop: a train step (the loss and its gradients through autograd, the
optional gradient compression round trip, AdamW), async checkpointing, a
straggler watchdog and restart on failure.  The engine is off in training:
``models.dit.train_loss`` runs the dense mode, so no Hopper kernel
launches.  Without ``--full`` it trains the arch's smoke config; ``--full``
takes the published one, and refuses before allocating when the f32
training state (parameters, gradients and AdamW's two moments, 16 bytes a
parameter, counted from the parameter tensors' shapes) and the blocks'
activations (a constant measured on the H100 for each kind of block: the
DiT's, and the LM's with and without remat) do not fit on the card:
flux-mmdit's 38 blocks hold 6 485 041 664 parameters, ≈ 103.8 GB of state
before any activation, more than one H100 holds: full depth needs the
sharded train step (:func:`repro_torch.launch.steps.build_train_step`) on
several cards (ROADMAP A.10.1).  :func:`train` also takes an ``ArchConfig``, e.g.
flux-mmdit cut to 2 blocks, and initial ``params``.  It trains every LM
family too (dense, MoE, ssm, hybrid, encdec and vlm; ``data/synthetic``
adds the ``frames`` and ``patches`` stubs), at smoke width.

Runs on the card unless ``device="cpu"`` is asked for; without a card it
raises.  The loop here trains on one device; the FSDP step over a mesh is
:mod:`repro_torch.launch.steps`.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.distributed import compression
from repro_torch.launch.serve import resolve_device
from repro_torch.models.registry import get_model, param_count
from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.fault_tolerance import (FailureInjector, RestartableLoop,
                                                 StepWatchdog)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["make_step_fn", "train", "check_state_fits", "STATE_BYTES_PER_PARAM",
           "ACT_BYTES_PER_BLOCK_ELEM", "LM_ACT_BYTES_PER_BLOCK_ELEM", "act_bytes_per_block_elem"]

# f32 parameters, gradients and AdamW's mu and nu.
STATE_BYTES_PER_PARAM = 16
# Activation bytes a block holds per element of its (batch, tokens,
# d_model) input during a step, from T1's measured peak on the H100
# (flux-mmdit, 2 blocks, batch 1, 4608 tokens: 14.51 GB, of which
# 16 B x 369 073 664 is state): (14.51e9 - 5.905e9) / (2 x 4608 x 3072).
ACT_BYTES_PER_BLOCK_ELEM = (14.51e9 - STATE_BYTES_PER_PARAM * 369_073_664) / (2 * 4608 * 3072)
# The same for an LM block, with cfg.remat and without, from L-train's
# measured peaks on the H100 (gemma3-1b, 26 layers, batch 1, 4096 tokens,
# 999 826 048 parameters: 41.63 GB with remat, 53.26 GB without).  What the
# step holds beside the 16 B a parameter (the 262 144-word head's logits,
# the new state while the old one lives) is billed to the blocks with the
# rest: (peak - 16 B x parameters) / (26 x 4096 x 1152).
LM_ACT_BYTES_PER_BLOCK_ELEM = {
    remat: (peak - STATE_BYTES_PER_PARAM * 999_826_048) / (26 * 4096 * 1152)
    for remat, peak in ((True, 41.629705216e9), (False, 53.260346368e9))}


def act_bytes_per_block_elem(cfg: ArchConfig) -> float:
    """The activation bytes ``cfg``'s blocks hold per element of a (batch,
    tokens, d_model) activation: the DiT's constant, or the LM's for its
    ``remat``."""
    if cfg.family == "dit":
        return ACT_BYTES_PER_BLOCK_ELEM
    return LM_ACT_BYTES_PER_BLOCK_ELEM[bool(cfg.remat)]


def check_state_fits(cfg: ArchConfig, free_bytes: int, *, batch: int = 1,
                     tokens: int = 4608) -> None:
    """Raise ``ValueError`` when ``cfg``'s training step does not fit in
    ``free_bytes`` of device memory: its f32 state (16 B a parameter, the
    parameters counted from their shapes) and, for each block,
    :func:`act_bytes_per_block_elem` per element of a ``(batch, tokens,
    d_model)`` activation."""
    n = param_count(cfg)
    state = n * STATE_BYTES_PER_PARAM
    act = int(cfg.n_layers * act_bytes_per_block_elem(cfg) * batch * tokens * cfg.d_model)
    if state + act > free_bytes:
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} blocks needs {(state + act) / 1e9:.1f} GB: "
            f"{state / 1e9:.1f} GB of f32 training state (parameters, gradients, AdamW mu "
            f"and nu: {STATE_BYTES_PER_PARAM} B x {n} parameters) and {act / 1e9:.1f} GB "
            f"of activations (batch {batch}, {tokens} tokens); the card has "
            f"{free_bytes / 1e9:.1f} GB free.  Full depth needs the training state "
            f"sharded across cards: the sharded train step "
            f"(launch/steps.build_train_step) on several cards (ROADMAP A.10.1); pass a "
            f"config with fewer blocks")


def make_step_fn(model, opt_cfg: AdamWConfig, dcfg: DataConfig, cfg: ArchConfig, *,
                 compress: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 device="cuda"):
    """``step_fn(state, step) -> (state, metrics)`` for ``RestartableLoop``.

    Each step takes fresh leaf tensors that require grad, so no gradient
    outlives its step.  The metrics hold the loss, the gradient norm and the
    seconds of the loss and its gradients (``grad_s``) and of the
    compression and AdamW (``update_s``); each ends where a value is read
    back, which waits for the device."""
    err_state = {"e": None}

    def step_fn(state, step):
        params, opt_state = state
        if compress and err_state["e"] is None:
            err_state["e"] = compression.init_error_state(params)
        batch = make_batch(cfg, dcfg, step, device=device)
        t0 = time.perf_counter()
        leaves, tdef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.train_loss(tree_unflatten(tdef, leaves), batch, dtype=dtype)
        grads = tree_unflatten(tdef, torch.autograd.grad(loss, leaves))
        loss = float(loss.detach())
        t1 = time.perf_counter()
        if compress:
            comp, err_state["e"] = compression.compress_tree(grads, err_state["e"], compress)
            grads = compression.decompress_tree(comp)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        gnorm = float(gnorm)
        return (params, opt_state), {"loss": loss, "grad_norm": gnorm,
                                     "grad_s": t1 - t0, "update_s": time.perf_counter() - t1}

    return step_fn


def train(arch: str | ArchConfig, *, smoke: bool = True, steps: int = 50,
          ckpt_dir: str = "artifacts/ckpt", batch: int = 4, seq_len: int = 128,
          compress: Optional[str] = None, fail_at: tuple[int, ...] = (),
          ckpt_every: int = 10, keep: int = 2, params: Optional[dict] = None,
          device="cuda"):
    """The reference's ``train`` (AdamW at lr 1e-3, warm-up 10, cosine over
    ``steps``; weights from seed 0 unless ``params`` is given).  ``arch`` is
    an arch id (its smoke config unless ``smoke=False``) or an ``ArchConfig``.
    Returns ``(state, LoopResult)``."""
    device = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_smoke(arch) if smoke else get_config(arch)
    if device.type == "cuda":
        check_state_fits(cfg, torch.cuda.mem_get_info(device)[0], batch=batch,
                         tokens=seq_len + cfg.n_text_tokens)
    model = get_model(cfg)
    dcfg = DataConfig(seed=0, batch=batch, seq_len=seq_len)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)

    step_fn = make_step_fn(model, opt_cfg, dcfg, cfg, compress=compress, device=device)
    ckpt = Checkpointer(f"{ckpt_dir}/{cfg.name}", keep=keep)
    loop = RestartableLoop(ckpt, ckpt_every=ckpt_every)
    injector = FailureInjector(fail_at) if fail_at else None
    t0 = time.time()
    # The initial state is built in the call, so that no name here keeps it
    # alive beside the loop's current state.
    state, result = loop.run(_initial_state(model, params, device), step_fn, steps,
                             injector=injector, watchdog=StepWatchdog())
    dt = time.time() - t0
    losses = [m["loss"] for m in result.metrics]
    print(f"[train] {cfg.name}: {result.final_step} steps in {dt:.1f}s  "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
          f"restarts={result.restarts} stragglers={len(result.stragglers)}")
    return state, result


def _initial_state(model, params: Optional[dict], device) -> tuple:
    """``(params, adamw_init(params))``: the weights from seed 0 unless given."""
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init_params(gen, device)
    else:
        params = tree_map(lambda x: x.to(device), params)
    return params, adamw_init(params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--compress", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train(args.arch, smoke=not args.full, steps=args.steps, batch=args.batch,
          seq_len=args.seq_len, compress=args.compress, ckpt_dir=args.ckpt_dir,
          device=args.device)


if __name__ == "__main__":
    main()
