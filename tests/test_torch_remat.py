"""``cfg.remat`` in the port's LM families (``models/transformer.remat``):
for each family's smoke config with ``remat=True`` (dense, MoE, ssm,
hybrid, encdec, vlm), the loss and every gradient are the same bits as the
port's with ``remat=False``, within 1e-4 of ``jax.value_and_grad`` of the
reference's ``train_loss`` with ``remat=True``, and the backward holds
fewer bytes.

The bytes a backward holds are counted three ways at once: every tensor
autograd saves outside a checkpoint (``saved_tensors_hooks``), the weight
products the remat policy keeps (its ``MUST_SAVE`` outputs) and the tensor
inputs each checkpoint keeps for its recompute."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from _lm_parity import F32, batch, check_grads, torch_batch
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models.registry import get_model as j_get_model
from repro_torch.configs.registry import get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# One arch of each LM family kind, and a length that puts the windowed
# configs' local layers on the banded path (> 2 x 32).
FAMILIES = {"dense": "gemma3-1b", "moe": "granite-moe-3b-a800m", "ssm": "mamba2-370m",
            "hybrid": "recurrentgemma-2b", "encdec": "whisper-large-v3",
            "vlm": "llama-3.2-vision-11b"}
SEQ = 80


def seeded_params(cfg) -> dict:
    """The port's smoke weights from a seeded ``torch.Generator``."""
    return get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def loss_grads_bytes(cfg, params: dict, b: dict, monkeypatch):
    """The port's f32 loss, its gradients and the bytes its backward holds."""
    held = {"saved": 0, "policy": 0, "inputs": 0}
    policy, ckpt = T.remat_policy, T.checkpoint

    def counting_policy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, w = args[-2:]                           # mm(a, w) or addmm(bias, a, w)
            held["policy"] += a.shape[0] * w.shape[1] * a.element_size()
        return out

    def counting_checkpoint(fn, *args, **kwargs):
        held["inputs"] += sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
        return ckpt(fn, *args, **kwargs)

    def pack(t):
        held["saved"] += _nbytes(t)
        return t

    monkeypatch.setattr(T, "remat_policy", counting_policy)
    monkeypatch.setattr(T, "checkpoint", counting_checkpoint)
    leaves, tdef = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = get_model(cfg).train_loss(tree_unflatten(tdef, leaves), torch_batch(b),
                                         dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    monkeypatch.undo()
    return loss.detach(), grads, held


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_keeps_the_bits_and_holds_fewer_bytes(family, monkeypatch):
    arch = FAMILIES[family]
    cfg = get_smoke(arch)
    assert cfg.family == family and not cfg.remat
    params = seeded_params(cfg)
    b = batch(cfg, 2, SEQ)
    loss_off, grads_off, off = loss_grads_bytes(cfg, params, b, monkeypatch)
    loss_on, grads_on, on = loss_grads_bytes(dataclasses.replace(cfg, remat=True), params, b,
                                             monkeypatch)
    assert torch.equal(loss_on, loss_off)
    assert len(grads_on) == len(grads_off)
    for i, (a, w) in enumerate(zip(grads_on, grads_off)):
        assert torch.equal(a, w), f"leaf {i}"
    assert off["policy"] == off["inputs"] == 0          # no checkpoint without remat
    assert on["policy"] > 0 and on["inputs"] > 0
    assert sum(on.values()) < off["saved"], (on, off)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_matches_the_reference_with_remat(family):
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(j_get_smoke(arch), remat=True)
    cfg = dataclasses.replace(get_smoke(arch), remat=True)
    b = batch(cfg, 2, SEQ)
    check_grads(lambda p: j_get_model(jcfg).train_loss(p, b, **F32),
                lambda p: get_model(cfg).train_loss(p, torch_batch(b), dtype=torch.float32),
                tree_map(lambda t: t.numpy(), seeded_params(cfg)))


def test_remat_leaves_no_grad_paths_alone(monkeypatch):
    """Prefill and decode run without grad: no checkpoint is taken, and the
    logits are those of ``remat=False``."""
    arch = FAMILIES["dense"]
    cfg = dataclasses.replace(get_smoke(arch), remat=True)
    params = seeded_params(cfg)
    calls = []
    ckpt = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(1) or ckpt(*a, **k))
    toks = torch.from_numpy(batch(cfg, 2, SEQ)["tokens"])
    model, plain = get_model(cfg), get_model(dataclasses.replace(cfg, remat=False))
    with torch.no_grad():
        got = model.prefill(params, {"tokens": toks}, dtype=torch.float32)
        cache = model.init_cache(2, 16, torch.float32, device="cpu")
        step, _ = model.decode_step(params, cache, toks[:, 0], 0, dtype=torch.float32)
        want = plain.prefill(params, {"tokens": toks}, dtype=torch.float32)
    assert calls == [] and torch.equal(got, want) and np.isfinite(step.numpy()).all()
    loss = model.train_loss(params, torch_batch(batch(cfg, 2, SEQ)), dtype=torch.float32)
    assert len(calls) == cfg.n_layers and torch.isfinite(loss)


def test_dit_has_no_remat():
    """The reference's DiT never reads ``cfg.remat``; the port's neither."""
    import inspect
    from repro_torch.models import dit
    assert "remat" not in inspect.getsource(dit)
