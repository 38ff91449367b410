"""Port parity: batched serving (``launch.batching``) and the leftovers it
runs on (``strategy_key``, ``emit_switch``, ``refresh_symbols``, the lane
tables of ``core/schedule``, the lane-state helpers of ``core/engine``).

  * ``strategy_key`` gives the reference's equality classes (and keys);
    ``step_strategy_key`` keys a ``step-phased`` strategy as the phase it
    emits at a step, and the batcher folds Update lanes on those keys;
    ``emit_switch`` and ``refresh_symbols`` the reference's packed symbols;
  * ``merge_strategies``, ``schedule_lane_rows``, ``stack_schedules`` and
    ``tick_mode_groups`` give the reference's integer tables exactly, and
    refuse what it refuses;
  * the lane-state helpers round-trip, and a split hands each lane tensors
    of its own;
  * ``RequestQueue`` keeps (arrival, submission) order over many inserts;
  * ``run_stacked`` and every ``ContinuousBatcher`` case hold each request
    to a single-request ``sample`` of it: latents within f32 1e-5, every
    integer field of the last plans and the trace modes exactly, densities
    to 1e-12 (the reference's batchers are not ground truth: their own
    bit-parity tests fail on this tree, ROADMAP C.1); ``run_stacked`` also
    to the reference's ``pipeline.sample`` on converted parameters (rtol
    1e-3 / atol 1e-4, as tests/test_torch_pipeline.py);
  * empty lanes report metrics of exactly zero;
  * ``serve_diffusion`` serves ``stacked`` and ``continuous`` on the CPU and
    refuses an unknown mode.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import schedule as JSch
from repro.core import strategy as JS
from repro.diffusion.pipeline import SamplerConfig as JSamplerConfig
from repro.diffusion.pipeline import sample as j_sample
from repro.models import dit as jdit
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import schedule as TSch
from repro_torch.core import strategy as TS
from repro_torch.diffusion.pipeline import SamplerConfig, make_grouped_lane_tick
from repro_torch.launch.batching import (ContinuousBatcher, Request, RequestQueue, _fold_groups,
                                         _lockstep_capable, run_sequential, run_stacked)
from repro_torch.launch.serve import serve_diffusion, serving_engine_config
from repro_torch.models import dit

LTOL = dict(rtol=1e-5, atol=1e-5)          # latents against the single-request run
SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw))


# ---------------------------------------------------------------------------
# strategy_key, emit_switch, refresh_symbols
# ---------------------------------------------------------------------------

def _strategy_pairs():
    """The same strategies built in both packages (two value-equal copies of
    several, one differing parameter in others)."""
    mg = lambda S, assign: S.MultiGranularityStrategy(
        children=("flashomni", "sliding-window"), head_assign=assign, layer_assign={0: 1})
    specs = [
        lambda S: S.FlashOmniStrategy(), lambda S: S.FlashOmniStrategy(),
        lambda S: S.FlashOmniStrategy(tau_q=0.3), lambda S: S.SkipOnlyStrategy(),
        lambda S: S.SkipOnlyStrategy(tau_kv=0.2), lambda S: S.CacheAllStrategy(),
        lambda S: S.SlidingWindowStrategy(), lambda S: S.SlidingWindowStrategy(2),
        lambda S: mg(S, (0, 0, 1)), lambda S: mg(S, (0, 0, 1)), lambda S: mg(S, (0, 1, 1)),
        lambda S: S.StepPhasedStrategy(boundaries=(0.5,)),
        lambda S: S.StepPhasedStrategy(boundaries=(3,)),
        lambda S: S.get_strategy("hunyuan-1.5x"), lambda S: S.get_strategy("hunyuan-1.5x"),
    ]
    return [f(JS) for f in specs], [f(TS) for f in specs]


def _classes(keys):
    return [min(j for j, other in enumerate(keys) if other == key) for key in keys]


def test_strategy_key_equality_classes_match():
    jstrats, tstrats = _strategy_pairs()
    jkeys = [JS.strategy_key(s) for s in jstrats]
    tkeys = [TS.strategy_key(s) for s in tstrats]
    assert _classes(tkeys) == _classes(jkeys)
    assert len(set(tkeys)) == 12          # 15 strategies, 3 value-equal copies
    assert tkeys == jkeys                 # same class names, names and parameters

    class AdHoc:
        name = "ad-hoc"

    x, y = AdHoc(), AdHoc()
    assert TS.strategy_key(x) == ("id", id(x)) != TS.strategy_key(y)
    with pytest.raises(TypeError, match="no value key"):
        TS._key_part(x)
    assert TS._key_part({"b": [1, 2], "a": None}) == JS._key_part({"b": [1, 2], "a": None})


def _qk(seed, b=2, h=2, n=256, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2)]


def test_step_strategy_key_is_the_phase_a_strategy_emits():
    flash, cache = TS.strategy_key(TS.FlashOmniStrategy()), TS.strategy_key(
        TS.CacheAllStrategy())
    key = TS.step_strategy_key
    assert key("flashomni", 0, 8) == key("flashomni", 5, 6) == flash
    phased = TS.StepPhasedStrategy(boundaries=(0.5,))     # round(0.5 n): 3 of 6, 4 of 8
    assert key(phased, 3, 6) == key(phased, 4, 8) == key(phased, 7, 8) == cache
    assert key(phased, 3, 8) == key(phased, 0, 6) == key(phased, None, None) == flash
    assert key(TS.StepPhasedStrategy(phases=("cache-all",), boundaries=()), 9, 10) == cache
    hunyuan = TS.get_strategy("hunyuan-1.5x")             # step-free children
    assert key(hunyuan, 1, 8) == key(hunyuan, 6, 50) == TS.strategy_key(hunyuan)
    holds_phased = TS.MultiGranularityStrategy(children=(phased, "flashomni"))
    assert key(holds_phased, 1, 8) != key(holds_phased, 2, 8)

    class AdHoc:                                          # may read the step
        name = "ad-hoc"

    ad = AdHoc()
    assert key(ad, 1, 8) == ("step", ("id", id(ad)), 1, 8) != key(ad, 1, 6)
    # The phase the key names is the one emit runs.
    _, tcfg = _cfgs()
    q, k = (_t(a) for a in _qk(3))
    for step, n in ((3, 6), (3, 8)):
        ctx = TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=256, step_idx=step, num_steps=n)
        want = (TS.CacheAllStrategy() if key(phased, step, n) == cache
                else TS.FlashOmniStrategy()).emit(q, k, ctx)
        got = phased.emit(q, k, ctx)
        assert torch.equal(got.s_c, want.s_c) and torch.equal(got.s_s, want.s_s)


def _fake_lane(k_since=0, n_updates=0, layers=2):
    return [types.SimpleNamespace(k_since=k_since, taylor=types.SimpleNamespace(
        n_updates=n_updates)) for _ in range(layers)]


@pytest.mark.parametrize("universe,steps,nsteps,k_since,groups", [
    # flashomni reads no step: Update lanes of 8 and 6 steps at any step fold.
    (("flashomni",), [0, 0, 2, 1], [8, 6, 8, 6], [0, 0, 0, 0], [[0, 1, 2, 3]]),
    # ... unless their counters differ.
    (("flashomni",), [0, 0, 6, 6], [8, 6, 8, 8], [0, 0, 3, 3], [[0, 1], [2, 3]]),
    # step-phased at 0.5: step 3 is phase 1 of 6 steps, phase 0 of 8.
    ("phased", [3, 3, 4], [6, 8, 8], [0, 0, 0], [[0, 2], [1]]),
])
def test_update_lanes_fold_on_the_strategy_they_pick(universe, steps, nsteps, k_since,
                                                     groups):
    if universe == "phased":
        universe = (TS.StepPhasedStrategy(boundaries=(0.5,)),)
    w, s = len(steps), 8
    mode_tab = np.full((w, s), TSch.MODE_UPDATE, np.int32)
    id_tab = np.zeros((w, s, 2), np.int32)
    states = [_fake_lane(k) for k in k_since]
    got = _fold_groups(mode_tab, np.array(steps), np.ones(w, bool), id_tab, np.array(nsteps),
                       states, tuple(TS.get_strategy(u) for u in universe))
    assert [(m, np.flatnonzero(mask).tolist()) for m, mask in got] == \
        [(TSch.MODE_UPDATE, g) for g in groups]
    # The grouped Update body refuses lanes that pick different strategies.
    body = make_grouped_lane_tick(get_smoke("flux-mmdit"), serving_engine_config(),
                                  SamplerConfig(num_steps=0),
                                  tuple(TS.get_strategy(u) for u in universe))["update"]
    if len(groups) > 1 and universe[0] != "flashomni":
        with pytest.raises(ValueError, match="pick different strategies"):
            body(None, None, [None] * w, states, [None] * w, np.array(steps), id_tab[:, 0],
                 np.array(nsteps), np.ones(w, bool))


@pytest.mark.parametrize("sid", [0, 1, 2])
def test_emit_switch_matches(sid):
    jcfg, tcfg = _cfgs()
    q, k = _qk(sid)
    jset = tuple(JS.get_strategy(n) for n in ("flashomni", "skip-only", "sliding-window"))
    tset = tuple(TS.get_strategy(n) for n in ("flashomni", "skip-only", "sliding-window"))
    want = JS.emit_switch(jnp.int32(sid), jnp.asarray(q), jnp.asarray(k),
                          JS.StrategyContext(cfg=jcfg, n_text=32, n_tokens=256), jset)
    got = TS.emit_switch(torch.tensor(sid), _t(q), _t(k),
                         TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=256), tset)
    for f in ("s_c", "s_s", "m_c", "m_s"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("cap_kv_frac", [0.9, 0.5])
def test_refresh_symbols_matches_and_is_the_flashomni_rule(cap_kv_frac):
    jcfg, tcfg = _cfgs(cap_kv_frac=cap_kv_frac)
    q, k = _qk(7)
    want = JE.refresh_symbols(jnp.asarray(q), jnp.asarray(k), jcfg, 32, 256)
    got = TE.refresh_symbols(_t(q), _t(k), tcfg, 32, 256)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    syms = TS.FlashOmniStrategy().emit(_t(q), _t(k), TS.StrategyContext(tcfg, 32, 256))
    assert torch.equal(syms.s_c, got[0]) and torch.equal(syms.s_s, got[1])


def test_denoise_step_layer_strategies_canonicalize_as_the_reference():
    """``layer_strategies`` gives the reference's (set, id row) and the same
    step as the canonical pair; both at once are refused."""
    cfg = get_smoke("flux-mmdit")
    tcfg = serving_engine_config()
    table = ["skip-only", None, "sliding-window"]
    jset, jrow = jdit._canonicalize_layer_strategies(table, _cfgs()[0], cfg.n_layers)
    tset, trow = dit._canonicalize_layer_strategies(table, tcfg, cfg.n_layers)
    np.testing.assert_array_equal(trow, np.asarray(jrow))
    assert [s.name for s in tset] == [s.name for s in jset]
    g = torch.Generator().manual_seed(3)
    params = dit.init_params(cfg, g, "cpu")
    xe, text = torch.randn((1, 96, cfg.d_model), generator=g), \
        torch.randn((1, 32, cfg.d_model), generator=g)
    run = lambda **kw: dit.denoise_step(params, cfg, tcfg,
                                        dit.init_engine_states(cfg, tcfg, 1, 128, "cpu"),
                                        xe, text, torch.zeros(1), mode="update",
                                        dtype=torch.float32, **kw)
    (v1, s1), (v2, s2) = run(layer_strategies=table), run(strategies=tset, strategy_row=trow)
    assert torch.equal(v1, v2) and all(torch.equal(a.s_s, b.s_s) for a, b in zip(s1, s2))
    with pytest.raises(ValueError, match="not both"):
        run(layer_strategies=table, strategies=tset)


# ---------------------------------------------------------------------------
# Lane tables, exactly
# ---------------------------------------------------------------------------

def _schedules(steps_and_names, layers=3):
    """The same schedules resolved in both packages."""
    jcfg, tcfg = _cfgs()
    out = ([], [])
    for steps, name in steps_and_names:
        out[0].append(JE.resolve_schedule(jcfg, steps, layers, schedule=name))
        out[1].append(TE.resolve_schedule(tcfg, steps, layers, schedule=name))
    return out


MIXES = [
    [(4, None), (6, "step-ramp")],
    [(8, None), (6, None), (8, "hunyuan-1.5x"), (5, "step-ramp")],
    [(6, "hunyuan-1.5x"), (6, "hunyuan-1.5x")],
]


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: "+".join(str(s) for s, _ in m))
@pytest.mark.parametrize("num_steps", [None, 9])
def test_stack_schedules_and_merge_match(mix, num_steps):
    jsch, tsch = _schedules(mix)
    jm, ji, jstrats, jlen = JSch.stack_schedules(jsch, num_steps)
    tm, ti, tstrats, tlen = TSch.stack_schedules(tsch, num_steps)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ti, ji)
    assert tm.dtype == ti.dtype == np.int32
    assert tlen == jlen
    assert [TS.strategy_key(s) for s in tstrats] == [JS.strategy_key(s) for s in jstrats]
    assert tstrats == TSch.merge_strategies(tsch)
    for js, ts in zip(jsch, tsch):
        for a, b in zip(TSch.schedule_lane_rows(ts, tstrats, tm.shape[1]),
                        JSch.schedule_lane_rows(js, jstrats, jm.shape[1])):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert _lockstep_capable(tsch) == (mix is MIXES[2])       # one mode table


def test_lane_tables_refuse_what_the_reference_refuses():
    (js6, jramp), (ts6, tramp) = _schedules([(6, None), (6, "step-ramp")], layers=2)
    for S, s6, ramp in ((JSch, js6, jramp), (TSch, ts6, tramp)):
        with pytest.raises(ValueError, match="raise the batcher's max_steps"):
            S.schedule_lane_rows(s6, s6.strategies, 4)
        with pytest.raises(ValueError, match="shared lane strategy set"):
            S.schedule_lane_rows(ramp, s6.strategies, 6)
        with pytest.raises(ValueError, match="at least one schedule"):
            S.stack_schedules([])
    (j3,), (t3,) = _schedules([(6, None)], layers=3)
    with pytest.raises(ValueError, match="mixed n_layers"):
        JSch.stack_schedules([js6, j3])
    with pytest.raises(ValueError, match="mixed n_layers"):
        TSch.stack_schedules([ts6, t3])


@pytest.mark.parametrize("seed", range(4))
def test_tick_mode_groups_match(seed):
    rng = np.random.default_rng(seed)
    lanes, s_max = 5, 7
    mode_tab = rng.integers(0, 4, (lanes, s_max)).astype(np.int32)
    steps = rng.integers(0, s_max + 2, lanes).astype(np.int32)     # past the end clips
    active = rng.random(lanes) < 0.7
    want = JSch.tick_mode_groups(mode_tab, steps, active)
    got = TSch.tick_mode_groups(mode_tab, steps, active)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert TSch.tick_mode_groups(mode_tab, steps, np.zeros(lanes, bool)) == []
    assert TSch.MODE_IDLE == JSch.MODE_IDLE and TSch.MODE_NAMES == JSch.MODE_NAMES


# ---------------------------------------------------------------------------
# Lane-state helpers
# ---------------------------------------------------------------------------

def _lane_states(n_lanes=3, seed=0):
    """Per-lane per-layer states after one Update, each lane its own input."""
    cfg = get_smoke("flux-mmdit")
    ecfg = serving_engine_config()
    g = torch.Generator().manual_seed(seed)
    params = dit.init_params(cfg, g, "cpu")
    lanes = []
    for _ in range(n_lanes):
        states = dit.init_engine_states(cfg, ecfg, 1, 128, "cpu")
        xe, text = torch.randn((1, 96, cfg.d_model), generator=g), \
            torch.randn((1, 32, cfg.d_model), generator=g)
        _, states = dit.denoise_step(params, cfg, ecfg, states, xe, text, torch.zeros(1),
                                     mode="update", dtype=torch.float32)
        lanes.append(states)
    return lanes


def _tensors(state):
    out = [state.s_c, state.s_s, state.taylor.derivs]
    return out + [t for t in state.plan if t is not None]


def _same_lane(a, b):
    for sa, sb in zip(a, b):
        assert (sa.k_since, sa.taylor.n_updates) == (sb.k_since, sb.taylor.n_updates)
        for ta, tb in zip(_tensors(sa), _tensors(sb)):
            assert torch.equal(ta, tb)


def test_lane_state_helpers_round_trip():
    lanes = _lane_states()
    stacked = TE.stack_lane_states(lanes[0], 4)
    assert len(stacked) == 4 and all(len(lane) == 3 for lane in stacked)
    stacked = TE.set_lane_state(stacked, 1, lanes[1])
    stacked = TE.set_lane_state(stacked, 3, lanes[2])
    _same_lane(stacked[1], lanes[1])
    _same_lane(stacked[0], lanes[0])
    # Fold lanes 3 and 1 (in that order) into the batch axis.
    fold = TE.gather_lane_states(stacked, [3, 1])
    assert fold[0].s_c.shape[0] == 2 and fold[0].taylor.derivs.shape[1] == 2
    assert torch.equal(fold[0].plan.q_ids[0], lanes[2][0].plan.q_ids[0])
    fold_tensors = [t for st in fold for t in _tensors(st)]    # kept alive: no reuse
    fold_ptrs = {t.data_ptr() for t in fold_tensors}
    back = TE.scatter_lane_states(TE.stack_lane_states(lanes[0], 4), [3, 1], fold)
    assert fold == [None] * 3                # consumed layer by layer
    _same_lane(back[3], lanes[2])
    _same_lane(back[1], lanes[1])
    _same_lane(back[0], lanes[0])
    # Each lane's share is its own tensor: no view of the fold, no alias.
    for lane in (back[1], back[3]):
        for st in lane:
            for t in _tensors(st):
                assert t._base is None and t.data_ptr() not in fold_ptrs
    merged = TE.merge_lane_states(back, stacked, [False, True, False, True])
    assert merged[0] is back[0] and merged[1] is stacked[1] and merged[3] is stacked[3]
    # One lane folds to its own list, with no copy.
    one = TE.gather_lane_states(stacked, [2])
    assert one[0] is stacked[2][0]
    # Lanes at different offsets cannot share a batch.
    moved = [st._replace(k_since=1) for st in lanes[1]]
    with pytest.raises(ValueError, match="k_since"):
        TE.gather_lane_states(TE.set_lane_state(stacked, 1, moved), [0, 1])


def test_request_queue_keeps_order_over_many_inserts():
    rng = np.random.default_rng(0)
    q = RequestQueue()
    mk = lambda rid, at: Request(rid=rid, x0=torch.zeros(1, 1, 1), text_emb=torch.zeros(1, 1, 1),
                                 num_steps=1, arrival=at)
    arrivals = np.round(rng.uniform(0.0, 4.0, size=200), 1)          # many ties
    for rid, at in enumerate(arrivals):
        q.submit(mk(rid, float(at)))
    assert len(q) == 200 and q.next_arrival() == arrivals.min()
    assert q.pop_ready(float(arrivals.min()) - 0.05) is None          # none arrived yet
    want = sorted(range(len(arrivals)), key=lambda r: (arrivals[r], r))
    got = [q.pop_ready(float("inf")).rid for _ in range(len(arrivals))]
    assert got == want and len(q) == 0 and q.next_arrival() is None


# ---------------------------------------------------------------------------
# Serving: every mode against single-request sample
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """The reference's smoke weights moved across, and a patch embedding."""
    jcfg = j_get_smoke("flux-mmdit")
    jparams = jdit.init_params(jcfg, jax.random.PRNGKey(0))
    pe = (np.random.default_rng(1).standard_normal((jcfg.patch_dim, jcfg.d_model))
          * 0.2).astype(np.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams)), pe


def _requests(cfg, steps, nv=96, seed=10, **kw):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, s in enumerate(steps):
        n = nv[i] if isinstance(nv, (list, tuple)) else nv
        x0 = rng.standard_normal((1, n, cfg.patch_dim)).astype(np.float32)
        text = rng.standard_normal((1, cfg.n_text_tokens, cfg.d_model)).astype(np.float32)
        reqs.append(Request(rid=i, x0=_t(x0), text_emb=_t(text), num_steps=s, **kw))
    return reqs


def _check_against(results, want, reqs, *, traces=True):
    """Each request: latents within 1e-5, every integer plan field and the
    trace modes exactly, densities to 1e-12."""
    for r in reqs:
        got, ref = results[r.rid], want[r.rid]
        np.testing.assert_allclose(got["out"].numpy(), ref["out"].numpy(), **LTOL)
        assert len(got["plans"]) == len(ref["plans"])
        for gp, rp in zip(got["plans"], ref["plans"]):
            for f, a, b in zip(gp._fields, gp, rp):
                if a is None or f == "row_score":
                    assert (a is None) == (b is None), f
                    continue
                assert a.dtype == b.dtype and torch.equal(a, b), f"{r.rid}: plan.{f}"
        if traces:
            assert [s["kind"] for s in got["trace"]] == [s["kind"] for s in ref["trace"]]
            assert [s["step"] for s in got["trace"]] == list(range(r.num_steps))
            for a, b in zip(got["trace"], ref["trace"]):
                assert abs(a["density"] - b["density"]) <= 1e-12
                assert abs(a["pair_sparsity"] - b["pair_sparsity"]) <= 1e-12
        assert got["latency"] >= 0 and got["finish"] >= got["latency"]


def test_run_stacked_matches_sample_and_the_reference(model):
    jparams, params, pe = model
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    reqs = _requests(cfg, [8, 6, 8, 6])
    seq = run_sequential(params, cfg, ecfg, reqs, patch_embed=_t(pe), keep_plans=True)
    stk = run_stacked(params, cfg, ecfg, reqs, patch_embed=_t(pe), keep_plans=True)
    _check_against(stk, seq, reqs, traces=False)
    assert all(stk[r.rid]["trace"] is None for r in reqs)
    # The two 8-step and the two 6-step requests each ran as one batch.
    assert stk[0]["finish"] == stk[2]["finish"] != stk[1]["finish"] == stk[3]["finish"]
    jecfg = JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK))
    for r in reqs:
        want = j_sample(jparams, j_get_smoke("flux-mmdit"), jecfg,
                        text_emb=jnp.asarray(r.text_emb.numpy()),
                        x0=jnp.asarray(r.x0.numpy()),
                        scfg=JSamplerConfig(num_steps=r.num_steps),
                        patch_embed=jnp.asarray(pe))
        np.testing.assert_allclose(stk[r.rid]["out"].numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4)


def test_run_stacked_groups_by_schedule_value(model):
    """Equal specs resolve to distinct objects (no memo): they still stack,
    and a different schedule value does not."""
    _, params, pe = model
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    reqs = (_requests(cfg, [6, 6], schedule="step-ramp")
            + _requests(cfg, [6], seed=11, schedule="hunyuan-1.5x"))
    reqs[2].rid = 2
    stk = run_stacked(params, cfg, ecfg, reqs, patch_embed=_t(pe), keep_plans=True)
    seq = run_sequential(params, cfg, ecfg, reqs, patch_embed=_t(pe), keep_plans=True)
    _check_against(stk, seq, reqs, traces=False)
    assert stk[0]["finish"] == stk[1]["finish"] != stk[2]["finish"]


CASES = {
    # name: (steps per request, request kwargs, engine-config mask overrides)
    "mixed_steps": ([8, 6, 8, 6, 4], {}, {}),
    "hunyuan_schedule": ([8, 6, 8], {"schedule": "hunyuan-1.5x"}, {}),
    "step_phased": ([6, 8, 8], "phased", {"interval": 2}),
}


def _case(name, cfg):
    steps, kw, mask = CASES[name]
    ecfg = serving_engine_config()
    ecfg = dataclasses.replace(ecfg, mask=dataclasses.replace(ecfg.mask, **mask))
    if kw == "phased":
        # Fractional boundary: round(0.5 * 6) = 3 and round(0.5 * 8) = 4, so
        # the lanes flip at different steps.
        kw = {"layer_strategies": [TS.StepPhasedStrategy(phases=("flashomni", "cache-all"),
                                                         boundaries=(0.5,))] * cfg.n_layers}
    return ecfg, _requests(cfg, steps, **kw)


@pytest.fixture(scope="module")
def sequential_runs(model):
    """``run_sequential`` of a :data:`CASES` entry, computed once for all
    of its ``grouped`` modes (the requests are rebuilt from their seed)."""
    _, params, pe = model
    cfg, runs = get_smoke("flux-mmdit"), {}

    def run(case):
        if case not in runs:
            ecfg, reqs = _case(case, cfg)
            runs[case] = run_sequential(params, cfg, ecfg, reqs, patch_embed=_t(pe),
                                        keep_plans=True)
        return runs[case]
    return run


@pytest.mark.parametrize("grouped", ["auto", True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_continuous_batcher_matches_sample(model, sequential_runs, case, grouped):
    _, params, pe = model
    cfg = get_smoke("flux-mmdit")
    ecfg, reqs = _case(case, cfg)
    seq = sequential_runs(case)
    bat = ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), lanes=3, grouped=grouped,
                            keep_plans=True)
    bat.submit_all(reqs)
    _check_against(bat.run(), seq, reqs)
    st = bat.stats
    assert st["ticks"] == st["grouped_ticks"] + st["scan_ticks"]
    assert st["ticks"] >= max(r.num_steps for r in reqs)
    assert sum(st["denoise_calls"].values()) >= st["ticks"]
    assert st["lane_steps"] == {"dense": 0, **{
        kind: sum(s["kind"] == kind for r in reqs for s in seq[r.rid]["trace"])
        for kind in ("update", "dispatch")}}
    if grouped is False:
        assert st["grouped_ticks"] == 0
        assert sum(st["denoise_calls"].values()) == sum(r.num_steps for r in reqs)
    elif case == "mixed_steps":
        # Lockstep ticks fold, Update ones too although the lanes' step
        # counts differ; refills sit at other counters and fold apart.
        assert st["grouped_ticks"] > 0 and st["scan_ticks"] > 0
        assert st["denoise_calls"]["update"] < st["lane_steps"]["update"]
        assert sum(st["denoise_calls"].values()) < sum(r.num_steps for r in reqs)


def test_continuous_batcher_shape_buckets_match_padded_sample(model):
    """A request of 64 vision tokens shares the 96-token lanes: its output is
    a sequential run of its zero-padded latents, sliced back."""
    _, params, pe = model
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    reqs = _requests(cfg, [8, 6, 8], nv=[96, 64, 64])
    padded = [dataclasses.replace(r, x0=torch.nn.functional.pad(r.x0, (0, 0, 0, 96 - r.x0.shape[1])))
              for r in reqs]
    seq = run_sequential(params, cfg, ecfg, padded, patch_embed=_t(pe), keep_plans=True)
    for r in reqs:
        seq[r.rid]["out"] = seq[r.rid]["out"][:, :r.x0.shape[1]]
    bat = ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), lanes=2, grouped=True,
                            shape_buckets=(96, 128), keep_plans=True)
    bat.submit_all(reqs)
    res = bat.run()
    _check_against(res, seq, reqs)
    assert [tuple(res[r.rid]["out"].shape) for r in reqs] == [(1, 96, 16), (1, 64, 16),
                                                              (1, 64, 16)]
    assert bat.stats["shape_partitions"] == 1
    assert bat.stats["shape_buckets"][reqs[1].shape_key()][0] == (1, 96, 16)


def test_continuous_empty_lanes_zero_metrics_and_options(model):
    """Lanes with no request report exactly zero; ``with_metrics=False``
    reads zero everywhere; ``sync_every_tick=False`` serves the same."""
    _, params, pe = model
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    reqs = _requests(cfg, [8, 4])
    seq = run_sequential(params, cfg, ecfg, reqs, patch_embed=_t(pe), keep_plans=True)
    bat = ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), lanes=4,
                            sync_every_tick=False, keep_plans=True)
    bat.submit_all(reqs)
    _check_against(bat.run(), seq, reqs)
    act, dens, ps = (bat.stats[k] for k in ("lane_active", "lane_density",
                                            "lane_pair_sparsity"))
    assert act.shape == dens.shape == (8, 4) and (~act).any()
    assert np.all(dens[~act] == 0.0) and np.all(ps[~act] == 0.0)
    assert np.all(dens[act] > 0.0)
    quiet = ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), lanes=4,
                              with_metrics=False)
    quiet.submit_all(reqs)
    res = quiet.run()
    for r in reqs:
        np.testing.assert_allclose(res[r.rid]["out"].numpy(), seq[r.rid]["out"].numpy(),
                                   **LTOL)
        assert all(s["density"] == 0.0 for s in res[r.rid]["trace"])
    assert not quiet.stats["lane_density"].any()
    with pytest.raises(ValueError, match="grouped"):
        ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), grouped="always")


def test_continuous_batcher_waits_for_arrivals(model):
    _, params, pe = model
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    reqs = _requests(cfg, [4, 4])
    reqs[1].arrival = 0.3
    bat = ContinuousBatcher(params, cfg, ecfg, patch_embed=_t(pe), lanes=2)
    bat.submit_all(reqs)
    res = bat.run()
    assert res[1]["finish"] >= 0.3 and res[1]["latency"] == res[1]["finish"] - 0.3


@pytest.mark.parametrize("serving", ["stacked", "continuous"])
def test_serve_diffusion_batched_modes_on_cpu(serving, capsys):
    res = serve_diffusion("flux-mmdit", num_requests=3, batch=1, num_steps=8, serving=serving,
                          mixed_steps=True, mixed_shapes=serving == "continuous",
                          device="cpu")
    assert sorted(res) == [0, 1, 2]
    assert [tuple(res[i]["out"].shape) for i in range(3)] == \
        ([(1, 96, 16), (1, 64, 16), (1, 96, 16)] if serving == "continuous" else
         [(1, 96, 16)] * 3)
    assert all(torch.isfinite(res[i]["out"]).all() for i in range(3))
    out = capsys.readouterr().out
    assert "req/s" in out
    if serving == "continuous":
        assert "x0 (1, 64, 16) -> lane (1, 96, 16)" in out and "grouped/" in out
    with pytest.raises(ValueError, match="unknown serving mode"):
        serve_diffusion("flux-mmdit", serving="lockstep", device="cpu")
