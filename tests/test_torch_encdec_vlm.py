"""Port parity: the ``encdec`` (whisper-large-v3, ``repro_torch.models.encdec``)
and ``vlm`` (llama-3.2-vision-11b, ``repro_torch.models.vision``) families
against the reference, and the registry that now resolves every family.

On the reference's smoke weights, carried across with ``params_from_jax``,
with seeded stub ``frames`` / ``patches``: the configs field for field;
``init_params``' nesting and shapes at the published configs; ``forward``
logits, ``train_loss`` and every gradient leaf, and ``prefill`` (rtol =
atol = 1e-4); 40 ``decode_step``s, each step's logits and the final caches;
``serve_lm``'s greedy tokens; and ``launch.train`` for 2 steps.  ROADMAP
C.11: decode reads cross K/V that nothing writes, so whisper's decode is
not its forward, while the vlm's is only because the gate is 0 at init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (F32, batch, check_caches, check_configs, check_grads,
                        check_model_loss_grads, check_published_shapes, check_serve_lm, close,
                        decode_both, j_params, torch_batch)
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import encdec as JE
from repro.models import vision as JV
from repro.models.registry import get_model as j_get_model
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import train
from repro_torch.models import encdec as TE
from repro_torch.models import vision as TV
from repro_torch.models.registry import LM_FAMILIES, get_model, param_count

ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b"]
MOD = {"whisper-large-v3": (JE, TE), "llama-3.2-vision-11b": (JV, TV)}


# --- configs, structure and the registry -----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_published(arch):
    check_published_shapes(arch)


def test_registry_resolves_all_twelve_archs():
    """``ARCH_IDS`` is the reference's, in its order; every arch's config
    builds its model, and ``param_count`` counts it on ``meta``."""
    assert ARCH_IDS == J_ARCH_IDS
    families = set()
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_smoke(arch)):
            assert get_model(cfg).cfg is cfg and param_count(cfg) > 0
        families.add(cfg.family)
        assert (cfg.family in LM_FAMILIES) == (cfg.family != "dit")
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm", "dit"}
    assert param_count(get_config("llama-3.2-vision-11b")) == 8_365_848_584


# --- forward, train_loss, prefill ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill(arch):
    jmod, tmod = MOD[arch]
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = j_params(arch)
    p = params_from_jax(jp)
    b = batch(cfg, 2, 40)
    jl, ja = jax.jit(lambda p, b: jmod.forward(p, jcfg, b, **F32))(jp, b)
    tl, ta = tmod.forward(p, cfg, torch_batch(b), dtype=torch.float32)
    assert tl.shape == (2, 40, cfg.vocab)
    close(tl, jl)
    close(ta, ja)
    want = jax.jit(lambda p, b: jmod.prefill(p, jcfg, b, **F32))(jp, b)
    close(tmod.prefill(p, cfg, torch_batch(b), dtype=torch.float32), want)
    close(get_model(cfg).prefill(p, torch_batch(b), dtype=torch.float32), want)


def test_encoder_output_matches():
    jcfg, cfg = j_get_smoke("whisper-large-v3"), get_smoke("whisper-large-v3")
    jp = j_params("whisper-large-v3")
    frames = batch(cfg, 2, 8)["frames"]
    close(TE.encode(params_from_jax(jp), cfg, torch.from_numpy(frames), dtype=torch.float32),
          jax.jit(lambda p, f: JE.encode(p, jcfg, f, **F32))(jp, frames))
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    sc, bi = np.full(7, 1.5, np.float32), np.full(7, 0.25, np.float32)
    close(TE.layer_norm(*map(torch.from_numpy, (x, sc, bi))),
          JE.layer_norm(*map(jnp.asarray, (x, sc, bi))))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient(arch):
    check_model_loss_grads(arch, 40)


def test_vlm_gradients_with_an_open_gate():
    """At init the cross layers' gates are 0, and so are the gradients of
    everything before them; open them to hold those gradients too."""
    arch = "llama-3.2-vision-11b"
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = dict(j_params(arch))
    jp["cross"] = dict(jp["cross"], gate=np.asarray([0.7, -0.4], np.float32))
    b = batch(cfg, 2, 24, seed=7)
    check_grads(lambda p: j_get_model(jcfg).train_loss(p, b, **F32),
                lambda p: get_model(cfg).train_loss(p, torch_batch(b), dtype=torch.float32),
                jp)


# --- decode ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forty_decode_steps_match(arch):
    jcache, cache = decode_both(arch, 40)
    assert int(cache["len"][0]) == 40
    check_caches(jcache, cache)


def test_whisper_self_cache_overwrites_its_last_slot_past_max_len():
    """At ``max_len`` 24 the decoder's self K/V past 24 tokens go to slot 23
    again, as in the reference."""
    jcache, cache = decode_both("whisper-large-v3", 30, max_len=24)
    assert cache["self"]["k"].shape[2] == 24
    check_caches(jcache, cache)


def test_c11_decode_reads_cross_kv_that_nothing_writes():
    """ROADMAP C.11: the cross K/V stay zero through decode.  Whisper's
    decode is then not its forward; the vlm's equals its forward only
    because ``tanh(gate)`` is 0, and stops doing so once the gate opens."""
    for arch in ARCHS:
        _, tmod = MOD[arch]
        cfg = get_smoke(arch)
        p = params_from_jax(j_params(arch))
        b = torch_batch(batch(cfg, 2, 12, seed=3))
        cache = tmod.init_cache(cfg, 2, 64, torch.float32, device="cpu")
        logits, _ = tmod.forward(p, cfg, b, dtype=torch.float32)
        dec = []
        for i in range(12):
            lg, cache = tmod.decode_step(p, cfg, cache, b["tokens"][:, i], i, dtype=torch.float32)
            dec.append(lg)
        dec = torch.stack(dec, dim=1)
        assert not cache["cross"]["k"].any() and not cache["cross"]["v"].any()
        if arch == "whisper-large-v3":
            assert (dec - logits).abs().max() > 1e-2
            continue
        close(dec, logits.numpy())
        p["cross"]["gate"] = torch.full_like(p["cross"]["gate"], 0.5)
        opened, _ = tmod.forward(p, cfg, b, dtype=torch.float32)
        cache = tmod.init_cache(cfg, 2, 64, torch.float32, device="cpu")
        lg, _ = tmod.decode_step(p, cfg, cache, b["tokens"][:, 0], 0, dtype=torch.float32)
        assert (lg - opened[:, 0]).abs().max() > 1e-3


# --- serving and training ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_greedy_tokens_match_the_reference(arch, capsys):
    check_serve_lm(arch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_the_smoke_config(arch, tmp_path):
    _, res = train(arch, steps=2, batch=2, seq_len=32, ckpt_dir=str(tmp_path), device="cpu")
    assert res.final_step == 2 and all(np.isfinite(m["loss"]) for m in res.metrics)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_serves_the_family_as_lm(arch, capsys, monkeypatch):
    """``--kind`` defaults to ``lm`` for every family but ``dit``."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--device", "cpu"])
    serve.main()
    assert f"[serve] {get_smoke(arch).name}: prefill 32 + decode 16" in capsys.readouterr().out
