"""Port parity: the ``ssm`` (mamba2-370m, ``repro_torch.models.ssm``) and
``hybrid`` (recurrentgemma-2b, ``repro_torch.models.rglru``) families
against the reference.

On the reference's smoke weights, carried across with ``params_from_jax``:
the configs field for field; ``init_params``' nesting and shapes at the
published configs; ``forward`` logits, ``train_loss`` and every gradient
leaf, and ``prefill`` (rtol = atol = 1e-4); 40 ``decode_step``s, each
step's logits and the final caches (recurrentgemma's 32-slot ring wraps);
``serve_lm``'s greedy tokens; and ``launch.train`` for 2 steps.  Mamba2
runs 64 tokens in chunks of 32, so the inter-chunk recurrence runs.  In the
port, ``ssd_chunked`` equals a loop of ``ssd_recurrent_step`` and
``rg_lru`` a loop of ``rg_lru_step``, and decode equals ``forward``.
ROADMAP C.10: at 128 tokens the reference's mamba2 gradients are NaN; the
port's are finite and equal those through its recurrent form.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (F32, batch, check_caches, check_configs, check_grads,
                        check_model_loss_grads, check_published_shapes, check_serve_lm, close,
                        decode_both, j_params, tokens)
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import train
from repro_torch.models import layers as L
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_flatten, tree_unflatten

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
MOD = {"mamba2-370m": (JS, TS), "recurrentgemma-2b": (JR, TR)}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- configs and structure ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_published(arch):
    check_published_shapes(arch)


def test_n_cycles_and_its_assert_match():
    for cfg, jcfg in ((get_config("recurrentgemma-2b"), j_get_config("recurrentgemma-2b")),
                      (get_smoke("recurrentgemma-2b"), j_get_smoke("recurrentgemma-2b"))):
        assert TR.n_cycles(cfg) == JR.n_cycles(jcfg)
    assert TR.n_cycles(get_config("recurrentgemma-2b")) == 8           # + a tail of 2
    bad = dataclasses.replace(get_smoke("recurrentgemma-2b"), n_layers=7)
    with pytest.raises(AssertionError):
        TR.n_cycles(bad)
    with pytest.raises(AssertionError):
        JR.n_cycles(bad)


# --- the scans -----------------------------------------------------------------------

def _ssd_inputs(seed, b=2, s=64, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    x = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h)))                   # softplus, > 0
    return x, dt.astype(np.float32), _rand(rng, h, scale=0.5), _rand(rng, b, s, n), \
        _rand(rng, b, s, n)


def _ssd_loop(x, dt, a_log, b, c):
    """The SSD through ``ssd_recurrent_step``, token by token."""
    st = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        y, st = TS.ssd_recurrent_step(st, x[:, t], dt[:, t], a_log, b[:, t], c[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_its_recurrence_and_the_reference(chunk):
    args = _ssd_inputs(chunk)
    got = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    close(got, _ssd_loop(*map(torch.from_numpy, args)).numpy())
    close(got, JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk))
    with pytest.raises(AssertionError, match="not divisible"):
        TS.ssd_chunked(*(torch.from_numpy(a[:, :40]) if a.ndim > 1 else torch.from_numpy(a)
                         for a in args), chunk=16)


def test_rg_lru_matches_its_steps_and_the_reference():
    rng = np.random.default_rng(4)
    x, gx, ga = (_rand(rng, 2, 77, 6) for _ in range(3))          # 77: not a power of 2
    lam = _rand(rng, 6)
    targs = [torch.from_numpy(a) for a in (x, gx, ga, lam)]
    got = TR.rg_lru(*targs)
    st, steps = torch.zeros((2, 1, 6)), []
    for t in range(77):
        h, st = TR.rg_lru_step(st, targs[0][:, t:t + 1], targs[1][:, t:t + 1],
                               targs[2][:, t:t + 1], targs[3])
        steps.append(h)
    close(got, torch.cat(steps, dim=1).numpy())
    close(got, JR.rg_lru(*map(jnp.asarray, (x, gx, ga, lam))))
    h0 = np.full((2, 6), 0.3, np.float32)
    jh, jst = JR.rg_lru_step(jnp.asarray(h0), *(jnp.asarray(a[:, 0]) for a in (x, gx, ga)),
                             jnp.asarray(lam))
    th, tst = TR.rg_lru_step(torch.from_numpy(h0), *(t[:, 0] for t in targs[:3]), targs[3])
    close(th, jh)
    close(tst, jst)


# --- forward, train_loss, prefill --------------------------------------------------

@pytest.mark.parametrize("arch, s, chunk", [("mamba2-370m", 64, 32), ("mamba2-370m", 64, 128),
                                            ("recurrentgemma-2b", 48, None),
                                            ("recurrentgemma-2b", 80, None)])
def test_forward_and_prefill(arch, s, chunk):
    """recurrentgemma at 48 tokens takes ``gqa_attention(window=32)``, at 80
    (> 2 x 32) the banded path."""
    jmod, tmod = MOD[arch]
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = j_params(arch)
    p = params_from_jax(jp)
    toks = tokens(cfg, 2, s)
    kw = {} if chunk is None else {"chunk": chunk}
    jl, ja = jax.jit(lambda p, t: jmod.forward(p, jcfg, t, **F32, **kw))(jp, toks)
    tl, ta = tmod.forward(p, cfg, torch.from_numpy(toks), dtype=torch.float32, **kw)
    assert tl.shape == (2, s, cfg.vocab)
    close(tl, jl)
    close(ta, ja)
    close(tmod.prefill(p, cfg, torch.from_numpy(toks), dtype=torch.float32),
          jax.jit(lambda p, t: jmod.prefill(p, jcfg, t, **F32))(jp, toks))
    assert get_model(cfg).mod is tmod


@pytest.mark.parametrize("arch, s", [("mamba2-370m", 64), ("recurrentgemma-2b", 80)])
def test_train_loss_and_every_gradient(arch, s):
    check_model_loss_grads(arch, s)


def test_mamba2_gradients_across_chunks():
    """64 tokens in chunks of 32: the inter-chunk recurrence's gradients."""
    jcfg, cfg = j_get_smoke("mamba2-370m"), get_smoke("mamba2-370m")
    b = batch(cfg, 2, 64, seed=5)
    tl = {k: torch.from_numpy(v) for k, v in b.items()}
    check_grads(
        lambda p: JL.softmax_xent(JS.forward(p, jcfg, b["tokens"], chunk=32, **F32)[0],
                                  b["labels"]),
        lambda p: L.softmax_xent(TS.forward(p, cfg, tl["tokens"], chunk=32,
                                            dtype=torch.float32)[0], tl["labels"]),
        j_params("mamba2-370m"))


def test_c10_mamba2_gradients_are_finite_at_128_tokens(monkeypatch):
    """ROADMAP C.10: at 128 tokens (one chunk of 128) the reference's
    gradients hold NaN; the port's are finite and equal, within 1e-4, the
    gradients through its recurrent form (``ssd_chunked`` replaced by a loop
    of ``ssd_recurrent_step``)."""
    jcfg, cfg = j_get_smoke("mamba2-370m"), get_smoke("mamba2-370m")
    jp = j_params("mamba2-370m")
    b = batch(cfg, 2, 128, seed=6)
    _, jg = jax.jit(jax.value_and_grad(lambda p: JS.train_loss(p, jcfg, b, **F32)))(jp)
    assert sum(int(np.isnan(np.asarray(g)).sum()) for g in jax.tree.leaves(jg)) > 0

    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def grads():
        leaves, tdef = tree_flatten(params_from_jax(jp))
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = TS.train_loss(tree_unflatten(tdef, leaves), cfg, tb, dtype=torch.float32)
        return loss, torch.autograd.grad(loss, leaves)

    loss, chunked = grads()
    assert all(bool(torch.isfinite(g).all()) for g in chunked)
    monkeypatch.setattr(TS, "ssd_chunked",
                        lambda x, dt, a_log, b_, c, chunk: _ssd_loop(x, dt, a_log, b_, c))
    loss_r, recurrent = grads()
    close(loss, loss_r.detach().numpy())
    for i, (g, w) in enumerate(zip(chunked, recurrent)):
        close(g, w.numpy(), err_msg=f"leaf {i}")


# --- decode ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forty_decode_steps_match(arch):
    jcache, cache = decode_both(arch, 40)
    if arch == "recurrentgemma-2b":
        assert cache["attn"]["k"].shape[2] == get_smoke(arch).window < 40       # it wrapped
    assert int(cache["len"][0]) == 40
    check_caches(jcache, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode gives ``forward``'s logits at every position
    (the port alone; recurrentgemma's ring wraps past 32)."""
    _, tmod = MOD[arch]
    cfg = get_smoke(arch)
    p = params_from_jax(j_params(arch))
    toks = torch.from_numpy(tokens(cfg, 2, 40, seed=3))
    logits, _ = tmod.forward(p, cfg, toks, dtype=torch.float32)
    cache = tmod.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    for i in range(40):
        lg, cache = tmod.decode_step(p, cfg, cache, toks[:, i], i, dtype=torch.float32)
        close(lg, logits[:, i].numpy(), err_msg=f"position {i}")


# --- serving and training ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_greedy_tokens_match_the_reference(arch, capsys):
    check_serve_lm(arch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_the_smoke_config(arch, tmp_path):
    _, res = train(arch, steps=2, batch=2, seq_len=64, ckpt_dir=str(tmp_path), device="cpu")
    assert res.final_step == 2 and all(np.isfinite(m["loss"]) for m in res.metrics)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_serves_the_family_as_lm(arch, capsys, monkeypatch):
    """``--kind`` defaults to ``lm`` for every family but ``dit``."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--device", "cpu"])
    serve.main()
    assert f"[serve] {get_smoke(arch).name}: prefill 32 + decode 16" in capsys.readouterr().out
