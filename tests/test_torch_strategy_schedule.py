"""Port parity: the ``skip-only``, ``sliding-window``, ``multi-granularity``
and ``hunyuan-1.5x`` strategies, the schedule resolution with its
``hunyuan-1.5x`` preset, and the bucket-count auto-tuner (repro_torch vs the
JAX reference on the same inputs).

Symbols and masks must match exactly (the float-threshold masks carry the
caveat of ROADMAP C.3: a mismatch there would be counted and reported); the
clamp-ranking scores to f32 rtol 1e-5 / atol 1e-6.  Schedules must give the
same mode array, id table and strategy names; the tuner the same bucket
counts and predicted clamp fractions.
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
PORTED = ("flashomni", "skip-only", "sliding-window", "multi-granularity", "hunyuan-1.5x")


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
                                  "hunyuan-1.5x"])
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
    assert "hunyuan-1.5x" in TSch.available_schedules()
    assert set(TSch.available_schedules()) <= set(JSch.available_schedules())
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        TSch.get_schedule("step-ramp", tcfg, 8, 3)
    with pytest.raises(ValueError, match="unknown"):
        TSch.get_schedule("no-such-schedule", tcfg, 8, 3)
    sched = TSch.get_schedule("hunyuan-1.5x", tcfg, 8, 3)
    assert TSch.get_schedule(sched, tcfg, 8, 3) is sched
    with pytest.raises(ValueError, match="steps"):
        TSch.get_schedule(sched, tcfg, 9, 3)
    with pytest.raises(NotImplementedError):
        TS.get_strategy("step-phased")
    assert set(TS.available_strategies()) == set(PORTED)


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
