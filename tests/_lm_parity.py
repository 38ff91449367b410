"""Helpers shared by the port's parity tests of the ssm, hybrid, encdec and
vlm families (``test_torch_ssm_hybrid.py``, ``test_torch_encdec_vlm.py``):
the reference's smoke weights carried across with ``params_from_jax``,
seeded inputs, and the comparisons every family runs (structure, gradients,
decode steps, ``serve_lm``'s greedy tokens)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.launch.serve import serve_lm as j_serve_lm
from repro.models.registry import get_model as j_get_model
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as TS
from repro_torch.models.registry import get_model, param_count
from repro_torch.tree import tree_flatten, tree_unflatten

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(dtype=jnp.float32)
# The batch keys beyond tokens and labels each family's forward reads.
EXTRA = {"encdec": ("frames", "encoder_len"), "vlm": ("patches", "num_image_tokens")}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **{**TOL, **kw})


@functools.lru_cache(maxsize=None)
def j_params(arch):
    return np_tree(j_get_model(j_get_smoke(arch)).init_params(jax.random.PRNGKey(0)))


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def batch(cfg, b, s, seed=0) -> dict:
    """Tokens, labels and, for encdec and vlm, the stub ``frames`` or
    ``patches`` (numpy, f32)."""
    out = {"tokens": tokens(cfg, b, s, seed), "labels": tokens(cfg, b, s, seed + 1)}
    if cfg.family in EXTRA:
        key, n = EXTRA[cfg.family]
        rng = np.random.default_rng(seed + 2)
        out[key] = rng.standard_normal((b, getattr(cfg, n), cfg.d_model)).astype(np.float32)
    return out


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_configs(arch):
    for pick, j_pick in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        got, want = pick(arch), j_pick(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.vocab_padded == want.vocab_padded
        assert got.n_params() == want.n_params()
    assert arch in ARCH_IDS


def check_published_shapes(arch):
    """``init_params``' nesting and shapes at the published config: the port
    on ``meta``, the reference by ``jax.eval_shape``."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    want = jax.eval_shape(lambda: j_get_model(jcfg).init_params(jax.random.PRNGKey(0)))
    got = get_model(cfg).init_params(None, "meta")
    got_leaves, got_def = tree_flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert str(got_def) == str(want_def)
    assert [tuple(t.shape) for t in got_leaves] == [tuple(t.shape) for t in want_leaves]
    assert all(t.dtype == torch.float32 and t.is_meta for t in got_leaves)
    assert param_count(cfg) == sum(int(np.prod(t.shape)) for t in want_leaves)


def check_grads(j_loss, t_loss, jp):
    """``j_loss(params)`` and ``t_loss(params)``, and every gradient leaf,
    at 1e-4."""
    loss_j, grads_j = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves, tdef = tree_flatten(params_from_jax(jp))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss = t_loss(tree_unflatten(tdef, leaves))
    grads = torch.autograd.grad(loss, leaves)
    close(loss, loss_j)
    want = jax.tree.leaves(np_tree(grads_j))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert np.isfinite(w).all(), f"leaf {i}: the reference's gradient is not finite"
        close(g, w, err_msg=f"leaf {i}")


def check_model_loss_grads(arch, s, seed=0):
    """The registry's ``train_loss`` of both and its gradients."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    b = batch(cfg, 2, s, seed)
    check_grads(lambda p: j_get_model(jcfg).train_loss(p, b, **F32),
                lambda p: get_model(cfg).train_loss(p, torch_batch(b), dtype=torch.float32),
                j_params(arch))


def decode_both(arch, steps, max_len=64, b=2):
    """``steps`` decode steps of the reference and the port from the same
    weights and tokens, each step's logits checked at 1e-4; returns both
    final caches."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = j_params(arch)
    p = params_from_jax(jp)
    toks = tokens(cfg, b, steps, seed=2)
    jmodel, model = j_get_model(jcfg), get_model(cfg)
    jcache = jmodel.init_cache(b, max_len, dtype=jnp.float32)
    cache = model.init_cache(b, max_len, torch.float32, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, **F32))
    for i in range(steps):
        jl, jcache = dec(jp, jcache, toks[:, i], jnp.int32(i))
        tl, cache = model.decode_step(p, cache, torch.from_numpy(toks[:, i]), i,
                                      dtype=torch.float32)
        assert tl.shape == (b, cfg.vocab)
        close(tl, jl, err_msg=f"step {i}")
    return jcache, cache


def check_caches(jcache, cache):
    want, wdef = jax.tree.flatten(np_tree(jcache))
    got, gdef = tree_flatten(cache)
    assert str(gdef) == str(wdef)
    for a, w in zip(got, want):
        close(a, w)


def _gap_at(jcfg, jp, prompt, gen, t):
    """The reference's top-2 logit gap at generated position ``t``."""
    model = j_get_model(jcfg)
    cache = model.init_cache(prompt.shape[0], 64, dtype=jnp.float32)
    dec = jax.jit(lambda p, c, tok, pos: model.decode_step(p, c, tok, pos, **F32))
    seq = np.concatenate([prompt, gen[:, :t]], axis=1)
    for i in range(seq.shape[1]):
        logits, cache = dec(jp, cache, seq[:, i], jnp.int32(i))
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def check_serve_lm(arch, capsys):
    """``serve_lm`` on the reference's weights and prompt gives its greedy
    tokens; where one differs, the reference's top-2 gap there is below the
    float tolerance."""
    jcfg = j_get_smoke(arch)
    jp = j_params(arch)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, jcfg.vocab))
    want = np.asarray(j_serve_lm(arch))
    got = TS.serve_lm(arch, params=params_from_jax(jp), prompt=torch.tensor(prompt),
                      device="cpu")
    assert f"[serve] {get_smoke(arch).name}: prefill 32 + decode 16" in capsys.readouterr().out
    assert got.shape == want.shape == (2, 16) and got.dtype == torch.int32
    diff = np.nonzero((got.numpy() != want).any(axis=0))[0]
    if len(diff):          # a near-tie may flip across frameworks; nothing else may
        assert _gap_at(jcfg, jp, prompt, want, int(diff[0])) < 1e-4
        assert np.array_equal(got.numpy()[:, :diff[0]], want[:, :diff[0]])
    else:
        assert np.array_equal(got.numpy(), want)
