"""Port parity: the dense baseline (``force_dense``), the chunked dense
attention and the ``hunyuan-video-dit`` configuration (repro_torch vs the JAX
reference on the same inputs).

Schedules must give the same mode array, id table and strategy names
exactly.  Samplers run with the serving launcher's MaskConfig (block 16,
pool 32, interval 4, warmup 2) and 96 vision tokens over 8 steps; the
weights are the reference's ``dit.init_params`` moved across through
``repro_torch.convert.params_from_jax``, the latents, text and stub
patchifier numpy draws handed to both.  Tolerances: latents f32 rtol 1e-3 /
atol 1e-4; per-step density and pair sparsity 1e-6; dense attention f32
rtol = atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hunyuan_video as j_hunyuan
from repro.configs.registry import get_smoke as j_get_smoke
from repro.core import attention as JA
from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import schedule as JSch
from repro.diffusion.pipeline import SamplerConfig as JSamplerConfig
from repro.diffusion.pipeline import sample as j_sample
from repro.models import dit as jdit
from repro_torch.configs import hunyuan_video
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import attention as TA
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import schedule as TSch
from repro_torch.diffusion.pipeline import SamplerConfig, sample
from repro_torch.launch.serve import serve_diffusion, serving_engine_config

SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)
STEPS, N_VISION = 8, 96


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw))


def _same_schedule(want, got):
    np.testing.assert_array_equal(got.mode, np.asarray(want.mode))
    np.testing.assert_array_equal(got.strategy_ids, np.asarray(want.strategy_ids))
    assert got.mode.dtype == np.asarray(want.mode).dtype
    assert got.strategy_ids.dtype == np.asarray(want.strategy_ids).dtype
    assert [s.name for s in got.strategies] == [s.name for s in want.strategies]
    assert [getattr(s, "head_assign", None) for s in got.strategies] == \
        [getattr(s, "head_assign", None) for s in want.strategies]
    assert got.kinds() == want.kinds()


# --- (a) the dense schedule ---------------------------------------------------

@pytest.mark.parametrize("steps,layers", [(8, 3), (50, 48)])
@pytest.mark.parametrize("how", ["from_config", "resolve", "resolve_over_schedule",
                                 "resolve_over_layer_table", "resolve_over_cfg_schedule"])
def test_force_dense_schedule_matches(how, steps, layers):
    kw = dict(strategy="sliding-window")
    if how == "resolve_over_cfg_schedule":
        kw["schedule"] = "hunyuan-1.5x"
    jcfg, tcfg = _cfgs(**kw)
    args = {"resolve_over_schedule": dict(schedule="hunyuan-1.5x"),
            "resolve_over_layer_table": dict(
                layer_strategies=["skip-only"] * (layers - 1) + [None])}.get(how, {})
    if how == "from_config":
        want = JSch.SparsitySchedule.from_config(jcfg, steps, layers, force_dense=True)
        got = TSch.SparsitySchedule.from_config(tcfg, steps, layers, force_dense=True)
    else:
        want = JE.resolve_schedule(jcfg, steps, layers, force_dense=True, **args)
        got = TE.resolve_schedule(tcfg, steps, layers, force_dense=True, **args)
    _same_schedule(want, got)
    assert set(got.mode.tolist()) == {TSch.MODE_DENSE}
    assert not got.strategy_ids.any()
    assert [s.name for s in got.strategies] == ["sliding-window"]


# --- (b) the paper's HunyuanVideo table at its own size -------------------------

@pytest.mark.parametrize("how", ["preset", "cfg_schedule", "explicit_over_table"])
def test_hunyuan_schedule_matches_at_50_steps_48_layers(how):
    steps, layers = 50, 48
    jcfg, tcfg = _cfgs(**({"schedule": "hunyuan-1.5x"} if how == "cfg_schedule" else {}))
    if how == "preset":
        want = JSch.get_schedule("hunyuan-1.5x", jcfg, steps, layers)
        got = TSch.get_schedule("hunyuan-1.5x", tcfg, steps, layers)
    else:
        args = {} if how == "cfg_schedule" else dict(
            schedule="hunyuan-1.5x", layer_strategies=["skip-only"] * layers)
        want = JE.resolve_schedule(jcfg, steps, layers, **args)
        got = TE.resolve_schedule(tcfg, steps, layers, **args)
    _same_schedule(want, got)
    assert int((got.mode == TSch.MODE_DISPATCH).sum()) == 36   # 14 Update, 36 Dispatch


@pytest.mark.parametrize("strategy,schedule", [("flashomni", None),
                                               ("sliding-window", None),
                                               ("flashomni", "hunyuan-1.5x")])
def test_served_schedule_matches_at_8_steps(strategy, schedule):
    """The schedules of chip_smoke's served paths (P1, P2 at 38 layers; H1 on
    hunyuan-1.5x at 48): the reference's tables, with steps 3-5 and 7
    Dispatch."""
    layers = 48 if schedule else 38
    jcfg, tcfg = _cfgs(strategy=strategy)
    want = JE.resolve_schedule(jcfg, STEPS, layers, schedule=schedule)
    got = TE.resolve_schedule(tcfg, STEPS, layers, schedule=schedule)
    _same_schedule(want, got)
    assert np.flatnonzero(got.mode == TSch.MODE_DISPATCH).tolist() == [3, 4, 5, 7]


# --- (d) the configuration ------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_hunyuan_config_matches_field_for_field(which):
    want = dataclasses.asdict(getattr(j_hunyuan, which))
    got = dataclasses.asdict(getattr(hunyuan_video, which))
    assert got == want
    assert "hunyuan-video-dit" in ARCH_IDS
    pick = get_config if which == "CONFIG" else get_smoke
    assert pick("hunyuan-video-dit") is getattr(hunyuan_video, which)
    assert pick("hunyuan_video_dit") is getattr(hunyuan_video, which)


def test_registry_refuses_an_unported_arch():
    """Every arch is ported now: an unknown one raises ``KeyError``, and all
    twelve of the reference's ids resolve (also with ``_`` for ``-``)."""
    from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
    from repro.configs.registry import get_config as j_get_config
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-370m")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke("no-such-arch")
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 12
    for arch in J_ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
        assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(j_get_smoke(arch))
    assert get_config("mamba2_370m") is get_config("mamba2-370m")


# --- (c), (e) samplers ------------------------------------------------------------

def _sampler_pair(arch, seed, **run):
    """The reference and the port through ``sample`` on the same inputs."""
    jarch = j_get_smoke(arch)
    jcfg, _ = _cfgs()
    jparams = jdit.init_params(jarch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    pe = (rng.standard_normal((jarch.patch_dim, jarch.d_model)) * 0.2).astype(np.float32)
    x0 = rng.standard_normal((2, N_VISION, jarch.patch_dim)).astype(np.float32)
    text = rng.standard_normal((2, jarch.n_text_tokens, jarch.d_model)).astype(np.float32)
    want_trace, trace = [], []
    want = j_sample(jparams, jarch, jcfg, text_emb=jnp.asarray(text), x0=jnp.asarray(x0),
                    scfg=JSamplerConfig(num_steps=STEPS), patch_embed=jnp.asarray(pe),
                    trace=want_trace, **run)
    got = sample(params_from_jax(jax.tree.map(np.asarray, jparams)), get_smoke(arch),
                 serving_engine_config(), text_emb=torch.from_numpy(text),
                 x0=torch.from_numpy(x0), patch_embed=torch.from_numpy(pe),
                 scfg=SamplerConfig(num_steps=STEPS), trace=trace, **run)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert [s["kind"] for s in trace] == [s["kind"] for s in want_trace]
    for a, c in zip(trace, want_trace):
        assert abs(a["density"] - c["density"]) <= 1e-6, (a, c)
        assert abs(a["pair_sparsity"] - c["pair_sparsity"]) <= 1e-6, (a, c)
        assert a["seconds"] >= 0
    return trace


@pytest.mark.parametrize("arch", ["flux-mmdit", "hunyuan-video-dit"])
def test_force_dense_sampler_matches_reference(arch):
    trace = _sampler_pair(arch, 31, force_dense=True)
    assert {s["kind"] for s in trace} == {"dense"}
    assert all(s["density"] == 1.0 and s["pair_sparsity"] == 0.0 for s in trace)


def test_force_dense_wins_over_an_explicit_schedule_in_the_sampler():
    trace = _sampler_pair("flux-mmdit", 32, force_dense=True, schedule="hunyuan-1.5x")
    assert {s["kind"] for s in trace} == {"dense"}


def test_hunyuan_smoke_sampler_matches_reference_under_its_schedule():
    trace = _sampler_pair("hunyuan-video-dit", 33, schedule="hunyuan-1.5x")
    assert [s["kind"] for s in trace].count("dispatch") == 4
    assert min(s["density"] for s in trace) < 1.0          # the engine went sparse


def test_serve_diffusion_serves_hunyuan_by_name():
    out = serve_diffusion("hunyuan-video-dit", smoke=True, num_requests=1, batch=1,
                          n_vision=N_VISION, num_steps=4, schedule="hunyuan-1.5x",
                          device="cpu", verbose=False)
    r = out[0]
    assert tuple(r["out"].shape) == (1, N_VISION, get_smoke("hunyuan-video-dit").patch_dim)
    assert bool(torch.isfinite(r["out"]).all())
    assert [s["kind"] for s in r["trace"]] == ["update", "update", "update", "dispatch"]


# --- (f) the chunked dense attention ----------------------------------------------

def _qkv(seed, lead, n, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((*lead, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lead,n", [((2, 3), 40), ((1, 4), 130), ((3,), 17)])
def test_dense_attention_matches_reference(lead, n, masked):
    q, k, v = _qkv(n, lead, n)
    mask = None
    if masked:
        mask = np.random.default_rng(n + 1).random((lead[0], *([1] * (len(lead) - 1)), n, n)) > 0.4
    want = jax.jit(lambda q, k, v, m: JA.dense_attention(q, k, v, mask=m, scale=0.3))(
        q, k, v, mask)
    got = TA.dense_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3,
                             mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (*lead, n, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget", [1, 7 * 130, 130 * 130, 2 * 130 * 130])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_dense_attention_equals_one_chunk(monkeypatch, budget, masked):
    """Chunks that divide neither N = 130 rows nor H = 3 heads give the
    one-chunk result; the row-chunk and head-chunk budgets both leave
    remainders."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (2, 3), 130))
    v = v.transpose(-1, -2).contiguous().transpose(-1, -2)     # a strided view
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(6).random((2, 1, 130, 130)) > 0.5)
    whole = TA.dense_attention(q, k, v, mask=mask)
    monkeypatch.setattr(TA, "_SCORE_ELEMS", budget)
    chunked = TA.dense_attention(q, k, v, mask=mask)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_dense_attention_keeps_the_input_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(8, (1, 2), 48))
    out = TA.dense_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 48, 32)
    want = TA.dense_attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


def test_denoise_step_replaces_the_callers_states():
    """A step hands back the caller's list with every layer's entry replaced
    (so an old state is freed as soon as its layer has run); a dense step
    leaves the entries as they are."""
    from repro_torch.models import dit
    cfg = get_smoke("hunyuan-video-dit")
    ecfg = serving_engine_config()
    g = torch.Generator()
    g.manual_seed(3)
    params = dit.init_params(cfg, g, "cpu")
    xe = torch.randn((1, N_VISION, cfg.d_model), generator=g)
    text = torch.randn((1, cfg.n_text_tokens, cfg.d_model), generator=g)
    t = torch.full((1,), 0.25)
    states = dit.init_engine_states(cfg, ecfg, 1, N_VISION + cfg.n_text_tokens, "cpu")
    before = list(states)
    _, out = dit.denoise_step(params, cfg, ecfg, states, xe, text, t, mode="dense",
                              dtype=torch.float32)
    assert out is states and all(a is b for a, b in zip(out, before))
    _, out = dit.denoise_step(params, cfg, ecfg, states, xe, text, t, mode="update",
                              dtype=torch.float32)
    assert out is states and not any(a is b for a, b in zip(out, before))
    assert all(st.k_since == 0 for st in out)
    _, out = dit.denoise_step(params, cfg, ecfg, states, xe, text, t, mode="dispatch",
                              dtype=torch.float32)
    assert out is states and all(st.k_since == 1 for st in out)
