"""Port parity: the ``cache-all``, ``skip-only``, ``sliding-window``,
``multi-granularity``, ``step-phased`` and ``hunyuan-1.5x`` strategies, the
schedule resolution with its ``hunyuan-1.5x`` and ``step-ramp`` presets, a
smoke-size sampler under ``step-ramp``, and the bucket-count auto-tuner
(repro_torch vs the JAX reference on the same inputs).

Symbols and masks must match exactly (the float-threshold masks carry the
caveat of ROADMAP C.3: a mismatch there would be counted and reported); the
clamp-ranking scores to f32 rtol 1e-5 / atol 1e-6.  Schedules must give the
same mode array, id table and strategy names; the tuner the same bucket
counts and predicted clamp fractions; the sampler the same latents to rtol
1e-3 / atol 1e-4 (as tests/test_torch_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import schedule as JSch
from repro.core import strategy as JS
from repro.kernels import tuning as JT
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import schedule as TSch
from repro_torch.core import strategy as TS
from repro_torch.kernels import tuning as TT

SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw))


def _same(name, want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape, (name, got.dtype, got.shape)
    bad = int(np.sum(want != got))
    assert bad == 0, f"{name}: {bad} of {want.size} entries differ"


def _qk(seed, b, h, n, d=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, h, n, d)).astype(np.float32))


def _emit_both(jstrat, tstrat, q, k, n, n_text, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jctx = JS.StrategyContext(cfg=jcfg, n_text=n_text, n_tokens=n)
    want = jax.jit(lambda q, k: jstrat.emit(q, k, jctx))(jnp.asarray(q), jnp.asarray(k))
    got = tstrat.emit(torch.from_numpy(q), torch.from_numpy(k),
                      TS.StrategyContext(cfg=tcfg, n_text=n_text, n_tokens=n))
    return want, got


def _same_symbols(want, got):
    for f in ("s_c", "s_s", "m_c", "m_s"):
        _same(f, getattr(want, f), getattr(got, f))
    for f in ("q_scores", "kv_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["skip-only", "sliding-window", "multi-granularity",
                                  "hunyuan-1.5x", "cache-all"])
@pytest.mark.parametrize("seed,n,n_text,heads,kw", [
    (0, 256, 32, 4, {}),
    (1, 512, 64, 6, dict(cap_q_frac=0.5, cap_kv_frac=0.4)),   # clamping caps
    (2, 256, 0, 3, {}),                                        # no text tokens
])
def test_strategy_symbols_match(name, seed, n, n_text, heads, kw):
    q, k = _qk(seed, 2, heads, n)
    want, got = _emit_both(JS.get_strategy(name), TS.get_strategy(name), q, k, n, n_text, **kw)
    _same_symbols(want, got)


@pytest.mark.parametrize("window", [1, 2, 6])
def test_sliding_window_width_matches(window):
    q, k = _qk(3, 1, 2, 512)
    want, got = _emit_both(JS.SlidingWindowStrategy(window), TS.SlidingWindowStrategy(window),
                           q, k, 512, 64, cap_kv_frac=0.3)
    _same_symbols(want, got)


def test_multi_granularity_tables_match():
    """An explicit head template and the per-layer variants of a layer table."""
    kw = dict(children=("skip-only", "sliding-window", "flashomni"), head_assign=(2, 0, 1, 1),
              layer_assign={0: 1, 2: (0, 2)})
    jm, tm = JS.MultiGranularityStrategy(**kw), TS.MultiGranularityStrategy(**kw)
    q, k = _qk(4, 2, 5, 256)
    for js, ts in [(jm, tm), *zip(jm.per_layer(3), tm.per_layer(3))]:
        assert ts.name == js.name and ts.head_assign == js.head_assign
        _same_symbols(*_emit_both(js, ts, q, k, 256, 32))


def _same_schedule(want, got):
    np.testing.assert_array_equal(got.mode, np.asarray(want.mode))
    np.testing.assert_array_equal(got.strategy_ids, np.asarray(want.strategy_ids))
    assert got.strategy_ids.dtype == np.asarray(want.strategy_ids).dtype
    assert [s.name for s in got.strategies] == [s.name for s in want.strategies]
    assert [getattr(s, "head_assign", None) for s in got.strategies] == \
        [getattr(s, "head_assign", None) for s in want.strategies]
    assert got.kinds() == want.kinds()


@pytest.mark.parametrize("steps,layers", [(8, 3), (12, 38)])
def test_hunyuan_schedule_matches(steps, layers):
    jcfg, tcfg = _cfgs()
    want = JSch.get_schedule("hunyuan-1.5x", jcfg, steps, layers)
    got = TSch.get_schedule("hunyuan-1.5x", tcfg, steps, layers)
    _same_schedule(want, got)
    assert got.strategies[0].head_assign == (1,)            # skip-only boundary layers
    assert got.strategies[1].head_assign == (0, 0, 2)       # striped interior
    assert list(got.strategy_ids[0]) == [0, 0] + [1] * (layers - 2)


@pytest.mark.parametrize("how", ["strategy", "preset", "layer_table", "explicit"])
def test_schedule_resolution_order_matches(how):
    steps, layers = 8, 4
    table = ["skip-only", None, "hunyuan-1.5x", "sliding-window"]
    kw = dict(strategy="multi-granularity", schedule="hunyuan-1.5x") if how != "strategy" \
        else dict(strategy="hunyuan-1.5x")
    jcfg, tcfg = _cfgs(**kw)
    args = {"strategy": {}, "preset": {}, "layer_table": dict(layer_strategies=table),
            "explicit": dict(schedule="hunyuan-1.5x", layer_strategies=table)}[how]
    want = JE.resolve_schedule(jcfg, steps, layers, **args)
    got = TE.resolve_schedule(tcfg, steps, layers, **args)
    _same_schedule(want, got)


def test_schedule_registry_and_refusals():
    assert TSch.available_schedules() == JSch.available_schedules()
    assert TSch.schedule_summaries() == JSch.schedule_summaries()
    assert TS.available_strategies() == JS.available_strategies()
    assert TS.strategy_summaries() == JS.strategy_summaries()
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="unknown"):
        TSch.get_schedule("no-such-schedule", tcfg, 8, 3)
    with pytest.raises(ValueError, match="unknown"):
        TS.get_strategy("no-such-strategy")
    sched = TSch.get_schedule("hunyuan-1.5x", tcfg, 8, 3)
    assert TSch.get_schedule(sched, tcfg, 8, 3) is sched
    with pytest.raises(ValueError, match="steps"):
        TSch.get_schedule(sched, tcfg, 9, 3)
    for name in TS.available_strategies():
        assert TS.get_strategy(name).name == JS.get_strategy(name).name


@pytest.mark.parametrize("steps,layers", [(8, 3), (12, 38), (2, 4), (1, 2)])
def test_step_ramp_schedule_matches(steps, layers):
    jcfg, tcfg = _cfgs()
    want = JSch.get_schedule("step-ramp", jcfg, steps, layers)
    got = TSch.get_schedule("step-ramp", tcfg, steps, layers)
    _same_schedule(want, got)
    assert got.mode.dtype == np.int32 and got.strategy_ids.dtype == np.int32


def test_cache_all_is_pure_forecast():
    """The port through the reference's own check (tests/test_strategy.py):
    with every vision block cached, a Dispatch step on the Update's input
    reproduces the Update output; text rows stay live, vision rows cached."""
    rng = np.random.default_rng(0)
    b, h, n, dm, dh, n_text = 1, 3, 256, 64, 32, 64
    cfg = TE.EngineConfig(mask=TM.MaskConfig(pool=32, block_q=16, block_kv=16, interval=4,
                                             order=1, warmup_steps=1, tau_kv=0.15, tau_q=0.5),
                          cap_q_frac=1.0, cap_kv_frac=1.0, cache_dtype=torch.float32,
                          strategy="cache-all")
    w = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
    p = TE.AttnParams(wq=w(dm, h * dh), wk=w(dm, h * dh), wv=w(dm, h * dh), wo=w(h * dh, dm),
                      q_scale=torch.ones(dh), k_scale=torch.ones(dh))
    x = torch.from_numpy(rng.standard_normal((b, n, dm)).astype(np.float32))
    state = TE.init_layer_state(b, h, n, dm, dh, cfg, "cpu")
    out_u, st = TE.update_layer(p, x, state, cfg, n_text=n_text, heads=h)
    out_d, _ = TE.dispatch_layer(p, x, st, cfg, n_text=n_text, heads=h)
    assert float(torch.linalg.norm(out_d - out_u) / torch.linalg.norm(out_u)) < 1e-5
    t, n_t = cfg.mask.n_blocks(n), n_text // cfg.mask.pool
    from repro_torch.core.symbols import unpack_bits
    m_c = unpack_bits(st.s_c, t)
    assert bool(m_c[..., :n_t].all()) and not bool(m_c[..., n_t:].any())


def _phased_pair(**kw):
    return JS.StepPhasedStrategy(**kw), TS.StepPhasedStrategy(**kw)


@pytest.mark.parametrize("step", [None, 0, 1, 2, 4])
def test_step_phased_near_half_boundary_matches(step):
    """0.3·5 = 1.5000001 in float32 (1.4999999 in float64): both packages
    flip to the second phase at step 2."""
    js, ts = _phased_pair(phases=("flashomni", "cache-all"), boundaries=(0.3,))
    assert ts._boundary_steps(5) == [2] == [int(s) for s in js._boundary_steps(5)]
    q, k = _qk(20, 2, 3, 256)
    jcfg, tcfg = _cfgs()
    jstep = None if step is None else jnp.int32(step)
    jctx = JS.StrategyContext(cfg=jcfg, n_text=32, n_tokens=256, step_idx=jstep, num_steps=5)
    want = jax.jit(lambda q, k: js.emit(q, k, jctx))(jnp.asarray(q), jnp.asarray(k))
    got = ts.emit(torch.from_numpy(q), torch.from_numpy(k),
                  TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=256, step_idx=step,
                                     num_steps=5))
    _same_symbols(want, got)
    phase = 1 if step is not None and step >= 2 else 0
    alone = ts.phases[phase].emit(torch.from_numpy(q), torch.from_numpy(k),
                                  TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=256))
    assert torch.equal(got.s_c, alone.s_c) and torch.equal(got.s_s, alone.s_s)


def test_step_phased_head_reclassification():
    """The reference's check (tests/test_schedule.py): the head -> class
    table flips at the boundary, Update -> Dispatch runs on both sides and
    the rebuilt plan equals the frozen one."""
    kids = ("cache-all", "skip-only")
    phase_a = TS.MultiGranularityStrategy(children=kids, head_assign=(0, 1), name="phase-a")
    phase_b = TS.MultiGranularityStrategy(children=kids, head_assign=(1, 0), name="phase-b")
    sp = TS.StepPhasedStrategy(phases=(phase_a, phase_b), boundaries=(2,))
    rng = np.random.default_rng(1)
    b, h, n, dm, dh = 1, 2, 256, 64, 32
    cfg = TE.EngineConfig(mask=TM.MaskConfig(pool=32, block_q=16, block_kv=16, interval=4,
                                             order=1, warmup_steps=1, tau_kv=0.15, tau_q=0.5),
                          cap_q_frac=1.0, cap_kv_frac=1.0, cache_dtype=torch.float32)
    w = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
    p = TE.AttnParams(wq=w(dm, h * dh), wk=w(dm, h * dh), wv=w(dm, h * dh), wo=w(h * dh, dm),
                      q_scale=torch.ones(dh), k_scale=torch.ones(dh))
    x = torch.from_numpy(rng.standard_normal((b, n, dm)).astype(np.float32))
    q, k = TE._qk(p, x, h)
    ctx = TS.StrategyContext(cfg=cfg, n_text=32, n_tokens=n)
    want_a, want_b = phase_a.emit(q, k, ctx), phase_b.emit(q, k, ctx)
    assert not torch.equal(want_a.s_c, want_b.s_c)
    for step, want in [(None, want_a), (0, want_a), (1, want_a), (2, want_b), (3, want_b)]:
        got = sp.emit(q, k, ctx._replace(step_idx=step, num_steps=4))
        assert torch.equal(got.s_c, want.s_c) and torch.equal(got.s_s, want.s_s), step
    for step in (1, 3):
        state = TE.init_layer_state(b, h, n, dm, dh, cfg, "cpu")
        out_u, st = TE.update_layer(p, x, state, cfg, n_text=32, heads=h, strategy=sp,
                                    step_idx=step, num_steps=4)
        assert torch.equal(st.s_c, (want_a if step < 2 else want_b).s_c)
        out_d, st2 = TE.dispatch_layer(p, x, st, cfg, n_text=32, heads=h)
        assert bool(torch.isfinite(out_u).all() and torch.isfinite(out_d).all())
        rebuilt = TE.plan_from_state(st2, cfg, n)
        for f in rebuilt._fields:
            a, c = getattr(rebuilt, f), getattr(st2.plan, f)
            assert (a is None and c is None) or torch.equal(a, c), (step, f)


def test_step_phased_validation():
    with pytest.raises(ValueError, match="phases need"):
        TS.StepPhasedStrategy(phases=("flashomni",), boundaries=(0.5,))
    sp = TS.StepPhasedStrategy(phases=("flashomni", "cache-all"), boundaries=(0.5,))
    q, k = (torch.from_numpy(a) for a in _qk(2, 1, 2, 256))
    _, tcfg = _cfgs()
    ctx = TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=256, step_idx=1, num_steps=None)
    with pytest.raises(ValueError, match="num_steps"):
        sp.emit(q, k, ctx)
    down = TS.StepPhasedStrategy(phases=("flashomni", "cache-all", "skip-only"),
                                 boundaries=(0.6, 2))
    with pytest.raises(ValueError, match="ascend"):
        down.emit(q, k, ctx._replace(num_steps=10))


def test_step_ramp_sampler_matches_reference():
    """A smoke-size flux-mmdit sampler under ``step-ramp`` (skip-only,
    flashomni and cache-all steps) against the reference's ``sample``."""
    from repro.configs.registry import get_smoke as j_get_smoke
    from repro.diffusion.pipeline import SamplerConfig as JSamplerConfig
    from repro.diffusion.pipeline import sample as j_sample
    from repro.models import dit as jdit
    from repro_torch.configs.registry import get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    steps = 8
    jcfg, tcfg = _cfgs()
    arch = j_get_smoke("flux-mmdit")
    jparams = jdit.init_params(arch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(77)
    pe = (rng.standard_normal((arch.patch_dim, arch.d_model)) * 0.2).astype(np.float32)
    x0 = rng.standard_normal((2, 96, arch.patch_dim)).astype(np.float32)
    text = rng.standard_normal((2, arch.n_text_tokens, arch.d_model)).astype(np.float32)
    want_trace, trace = [], []
    want = j_sample(jparams, arch, jcfg, text_emb=jnp.asarray(text), x0=jnp.asarray(x0),
                    scfg=JSamplerConfig(num_steps=steps), patch_embed=jnp.asarray(pe),
                    trace=want_trace, schedule="step-ramp")
    got = sample(params_from_jax(jax.tree.map(np.asarray, jparams)), get_smoke("flux-mmdit"),
                 tcfg, text_emb=torch.from_numpy(text), x0=torch.from_numpy(x0),
                 patch_embed=torch.from_numpy(pe), scfg=SamplerConfig(num_steps=steps),
                 trace=trace, schedule="step-ramp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert [s["kind"] for s in trace] == [s["kind"] for s in want_trace]
    for a, c in zip(trace, want_trace):
        assert abs(a["density"] - c["density"]) <= 1e-6, (a, c)
        assert abs(a["pair_sparsity"] - c["pair_sparsity"]) <= 1e-6, (a, c)


def test_select_kv_buckets_matches_for_every_strategy():
    assert TT.CANDIDATE_BUCKETS == JT.CANDIDATE_BUCKETS
    jtab, ttab = JT.load_table(), TT.load_table()
    assert ttab["strategies"] == jtab["strategies"]
    assert ttab["bucket_model"] == jtab["bucket_model"]
    for name in TS.available_strategies():
        assert TT.select_kv_buckets(name) == JT.select_kv_buckets(name), name
        hist = ttab["strategies"][name]["occ_hist"]
        for nb in (1, 2, 3):
            assert TT.bucket_clamp_frac(hist, nb) == JT.bucket_clamp_frac(hist, nb)
            assert TT.bucket_slot_frac(nb) == JT.bucket_slot_frac(nb)
        jcfg, tcfg = _cfgs(strategy=name, kv_buckets=0)
        assert tcfg.resolved_kv_buckets() == jcfg.resolved_kv_buckets()
        assert tcfg.caps(512) == tuple(jcfg.caps(512))
    assert TE.EngineConfig(kv_buckets=0, strategy="sliding-window").resolved_kv_buckets() == 2
    assert TT.select_kv_buckets("uncalibrated") == 1


@pytest.mark.parametrize("table", [
    {"version": 2, "strategies": {}},
    {"version": 1, "bucket_model": {"max_clamp_frac": 1.5}},
    {"version": 1, "strategies": {"x": {"occ_hist": [-1.0]}}},
])
def test_invalid_calibration_table_falls_back(tmp_path, table):
    import json
    path = tmp_path / "table.json"
    path.write_text(json.dumps(table))
    with pytest.raises(ValueError):
        TT.validate_table(table)
    assert TT.load_table(str(path))["strategies"] == {}
    assert TT.select_kv_buckets("sliding-window", TT.load_table(str(path))) == 1
