"""Port parity: the decoder-only LM family (``repro_torch.models.transformer``,
its registry entry and ``launch.serve.serve_lm``) against the reference.

For each of the six LM smoke configs, on the reference's weights moved
across with ``params_from_jax``: ``forward`` logits and aux (80 tokens, so
the local layers of the windowed configs take the banded path), the
reference's ``train_loss`` and every gradient leaf (rtol = atol = 1e-4),
``prefill``, and 40 ``decode_step``s that wrap the 32-slot ring buffers
(each step's logits and the final caches at 1e-4).  The global layers'
overwrite of the last slot past ``max_len`` is reproduced; decode agrees
with ``forward`` (dense configs); ``layer_groups`` and ``init_params``'
nesting and shapes equal the reference's for all six published configs;
``serve_lm`` gives the reference's greedy tokens on its own weights and
prompt (where a token differs, the reference's top-2 gap there is below the
float tolerance); and ``serve_lm --full`` refuses, before allocating, the
archs whose f32 parameters do not fit an 80 GB card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.launch.serve import serve_lm as j_serve_lm
from repro.models import transformer as JT
from repro.models.registry import get_model as j_get_model
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as TS
from repro_torch.launch.train import train
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model, param_count
from repro_torch.tree import tree_flatten, tree_unflatten

LM_ARCHS = ["gemma3-1b", "gemma3-12b", "granite-8b", "llama3-405b", "mixtral-8x22b",
            "granite-moe-3b-a800m"]
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(dtype=jnp.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    return _np(JT.init_params(j_get_smoke(arch), jax.random.PRNGKey(0)))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


# --- configs and structure -------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_field_for_field(arch):
    for pick, j_pick in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        got, want = pick(arch), j_pick(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.vocab_padded == want.vocab_padded
        assert got.n_params() == want.n_params()
    assert arch in ARCH_IDS


def test_arch_ids_keep_the_reference_order():
    from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
    assert ARCH_IDS == [a for a in J_ARCH_IDS if a in ARCH_IDS]
    assert get_config("granite-moe-3b-a800m").vocab_padded == 49408


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_layer_groups_and_param_shapes_match_published(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert TT.layer_groups(cfg) == JT.layer_groups(jcfg)
    want = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    got = TT.init_params(cfg, None, "meta")
    got_leaves, got_def = tree_flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert str(got_def) == str(want_def)
    assert [tuple(t.shape) for t in got_leaves] == [tuple(t.shape) for t in want_leaves]
    assert all(t.dtype == torch.float32 for t in got_leaves)
    assert param_count(cfg) == sum(int(np.prod(t.shape)) for t in want_leaves)


def test_params_from_jax_carries_a_transformer_tree_unchanged():
    jp = _j_params("gemma3-1b")
    p = params_from_jax(jp)
    leaves, tdef = tree_flatten(p)
    want, wdef = jax.tree.flatten(jp)
    assert str(tdef) == str(wdef)
    assert sorted(p["locals"]) == ["attn", "ln1", "ln2", "mlp"]
    for a, w in zip(leaves, want):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), w)


# --- forward, train_loss, prefill ---------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_grads_and_prefill(arch):
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = _j_params(arch)
    p = params_from_jax(jp)
    toks = _tokens(cfg, 2, 80)
    labels = _tokens(cfg, 2, 80, seed=1)
    jl, ja = jax.jit(lambda p, t: JT.forward(p, jcfg, t, **F32))(jp, toks)
    tl, ta = TT.forward(p, cfg, torch.from_numpy(toks), dtype=torch.float32)
    assert tl.shape == (2, 80, cfg.vocab)
    _close(tl, jl)
    _close(ta, ja)
    _close(TT.prefill(p, cfg, torch.from_numpy(toks), dtype=torch.float32),
           jax.jit(lambda p, t: JT.prefill(p, jcfg, t, **F32))(jp, toks))

    batch = {"tokens": toks, "labels": labels}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: j_get_model(jcfg).train_loss(p, batch, **F32)))(jp)
    leaves, tdef = tree_flatten(p)
    leaves = [x.requires_grad_(True) for x in leaves]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = get_model(cfg).train_loss(tree_unflatten(tdef, leaves), tbatch,
                                     dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, loss_j)
    want = jax.tree.leaves(_np(grads_j))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"leaf {i}")


# --- decode ------------------------------------------------------------------------

def _decode_both(arch, steps, max_len, batch=2):
    """``steps`` decode steps of the reference and the port from the same
    weights and tokens: the largest logit difference over the steps (each
    checked at 1e-4) and both final caches."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = _j_params(arch)
    p = params_from_jax(jp)
    toks = _tokens(cfg, batch, steps, seed=2)
    jmodel, model = j_get_model(jcfg), get_model(cfg)
    jcache = jmodel.init_cache(batch, max_len, dtype=jnp.float32)
    cache = model.init_cache(batch, max_len, torch.float32, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, **F32))
    for i in range(steps):
        jl, jcache = dec(jp, jcache, toks[:, i], jnp.int32(i))
        tl, cache = model.decode_step(p, cache, torch.from_numpy(toks[:, i]), i,
                                      dtype=torch.float32)
        assert tl.shape == (batch, cfg.vocab)
        _close(tl, jl, err_msg=f"step {i}")
    return jcache, cache


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forty_decode_steps_wrap_the_ring_buffer(arch):
    jcache, cache = _decode_both(arch, 40, 64)
    cfg = get_smoke(arch)
    if cfg.window:
        ring = "tail" if "tail" in cache else "locals"
        assert cache[ring]["k"].shape[-3] == cfg.window < 40          # it wrapped
    assert int(cache["len"][0]) == 40
    want, wdef = jax.tree.flatten(_np(jcache))
    got, gdef = tree_flatten(cache)
    assert str(gdef) == str(wdef)
    for a, w in zip(got, want):
        _close(a, w)


def test_global_layers_overwrite_the_last_slot_past_max_len():
    """gemma3-1b smoke at max_len 24: past 24 tokens the global layers write
    slot 23 again, the local rings hold 24 slots; the reference does the same."""
    jcache, cache = _decode_both("gemma3-1b", 30, 24)
    assert cache["globals"]["k"].shape[-3] == cache["locals"]["k"].shape[-3] == 24
    _close(cache["globals"]["k"], jcache["globals"]["k"])


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-8b"])
def test_decode_matches_forward_across_the_wrap(arch):
    """Teacher-forced decode gives ``forward``'s logits at every position,
    also after the local layers' ring buffers wrap (the port alone)."""
    cfg = get_smoke(arch)
    p = params_from_jax(_j_params(arch))
    toks = torch.from_numpy(_tokens(cfg, 2, 40, seed=3))
    logits, _ = TT.forward(p, cfg, toks, dtype=torch.float32)
    cache = TT.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    for i in range(40):
        lg, cache = TT.decode_step(p, cfg, cache, toks[:, i], i, dtype=torch.float32)
        _close(lg, logits[:, i].numpy(), err_msg=f"position {i}")


# --- serving -------------------------------------------------------------------------

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


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m"])
def test_serve_lm_greedy_tokens_match_the_reference(arch, capsys):
    jcfg = j_get_smoke(arch)
    jp = _np(j_get_model(jcfg).init_params(jax.random.PRNGKey(0)))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, jcfg.vocab))
    want = np.asarray(j_serve_lm(arch))
    got = TS.serve_lm(arch, params=params_from_jax(jp), prompt=torch.tensor(prompt),
                      device="cpu")
    out = capsys.readouterr().out
    assert f"[serve] {get_smoke(arch).name}: prefill 32 + decode 16" in out
    assert got.shape == want.shape == (2, 16) and got.dtype == torch.int32
    diff = np.nonzero((got.numpy() != want).any(axis=0))[0]
    if len(diff):          # a near-tie may flip across frameworks; nothing else may
        assert _gap_at(jcfg, jp, prompt, want, int(diff[0])) < 1e-4
        assert np.array_equal(got.numpy()[:, :diff[0]], want[:, :diff[0]])
    else:
        assert np.array_equal(got.numpy(), want)


def test_serve_lm_draws_from_its_seed_and_the_cli_picks_the_kind(capsys, monkeypatch):
    a = TS.serve_lm("mixtral-8x22b", seed=3, device="cpu")
    b = TS.serve_lm(get_smoke("mixtral-8x22b"), seed=3, device="cpu")   # a config itself
    assert torch.equal(a, b) and a.shape == (2, 16)
    for argv in (["--arch", "gemma3-1b"], ["--kind", "lm", "--arch", "gemma3-1b"]):
        monkeypatch.setattr("sys.argv", ["serve", *argv, "--device", "cpu"])
        capsys.readouterr()
        TS.main()
        assert "[serve] gemma3-1b-smoke: prefill 32 + decode 16" in capsys.readouterr().out
    with pytest.raises(ValueError, match="serve_lm runs"):
        TS.serve_lm("flux-mmdit", device="cpu")


@pytest.mark.parametrize("arch", ["llama3-405b", "mixtral-8x22b"])
def test_serve_lm_full_refuses_what_does_not_fit(arch):
    cfg = get_config(arch)
    need = param_count(cfg) * 4
    with pytest.raises(ValueError, match=f"needs {need} bytes"):
        TS.check_params_fit(cfg, 80 * 10 ** 9)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m", "granite-8b",
                                  "gemma3-12b", "mamba2-370m", "recurrentgemma-2b",
                                  "whisper-large-v3", "llama-3.2-vision-11b"])
def test_serve_lm_full_admits_what_fits(arch):
    TS.check_params_fit(get_config(arch), 80 * 10 ** 9)


def test_registry_serves_the_lm_families():
    cfg = get_smoke("granite-moe-3b-a800m")
    model = get_model(cfg)
    assert model.mod is TT
    p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12))
    last = model.prefill(p, {"tokens": toks}, dtype=torch.float32)
    logits, _ = TT.forward(p, cfg, toks, dtype=torch.float32)
    _close(last, logits[:, -1].numpy())
    cache = model.init_cache(2, 16, torch.float32, device="cpu")
    lg, cache = model.decode_step(p, cache, toks[:, 0], 0, dtype=torch.float32)
    assert lg.shape == (2, cfg.vocab) and int(cache["len"][1]) == 1


def test_train_runs_an_lm_smoke_config(tmp_path):
    """``launch.train`` trains a dense LM through ``transformer.train_loss``."""
    _, res = train("gemma3-1b", steps=2, batch=2, seq_len=16, ckpt_dir=str(tmp_path),
                   device="cpu")
    assert res.final_step == 2 and all(np.isfinite(m["loss"]) for m in res.metrics)
