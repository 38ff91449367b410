"""Port parity: the occupancy-bucketed Dispatch path (repro_torch vs the JAX
reference on the same inputs).

  * bucket geometry, slot layout and grid-slot count: exact;
  * ``build_dispatch_plan`` at ``kv_buckets`` 2 and 3: every field exact,
    dtypes (int16 narrowing) and ``widen`` included, with the reference's
    ``row_score`` handed across;
  * the plain versions of B4 and B5 against the reference's Pallas kernels
    in interpret mode (f32 rtol = atol = 1e-5), and bit-equal to the
    uniform plain versions fed the same plan's clamped counts;
  * an Update → Dispatch round trip under ``kv_buckets=3`` for the
    ``multi-granularity`` and ``hunyuan-1.5x`` strategies, with
    ``plan_from_state`` rebuilding every plan field bit for bit;
  * the samplers: the ``hunyuan-1.5x`` schedule at ``kv_buckets=3`` on a
    4-head variant of the flux-mmdit smoke config (with 2 heads its
    ``(0, 0, 2)`` template never emits the sliding-window child), and
    ``sliding-window`` at ``kv_buckets=0`` (auto: 2 buckets) with 480 vision
    tokens, through ``run_sequential`` — latents rtol 1e-3 / atol 1e-4,
    per-step density and pair sparsity 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import plan as JP
from repro.core import strategy as JS
from repro.diffusion.pipeline import SamplerConfig as JSamplerConfig
from repro.diffusion.pipeline import sample as j_sample
from repro.kernels.flashomni_attention import flashomni_attention_csr_bucketed as j_attn_bkt
from repro.kernels.gemm_o import gemm_o_sparse_bucketed_kernel as j_gemm_o_bkt
from repro.models import dit as jdit
from repro_torch import kernels as TK
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import backend as TB
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core import strategy as TS
from repro_torch.diffusion.pipeline import SamplerConfig, sample
from repro_torch.kernels import ref as tref
from repro_torch.launch.batching import Request, run_sequential
from repro_torch.launch.serve import serving_engine_config

SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)
FTOL = dict(rtol=1e-5, atol=1e-5)
_j_build_plan = jax.jit(JP.build_dispatch_plan, static_argnums=(2, 3))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _same(name, want, got):
    if want is None or got is None:
        assert want is None and got is None, f"{name}: {got} != reference {want}"
        return
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype, f"{name}: dtype {got.dtype} != reference {want.dtype}"
    assert want.shape == got.shape, f"{name}: shape {got.shape} != {want.shape}"
    bad = int(np.sum(want != got))
    assert bad == 0, f"{name}: {bad} of {want.size} entries differ"


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw))


# ---------------------------------------------------------------------------
# Static geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap_q,cap_kv,heads,nb", [
    (8, 8, 4, 3), (8, 16, 4, 3), (16, 32, 8, 3), (5, 7, 3, 3), (8, 16, 4, 2),
    (8, 16, 4, 1), (1, 2, 1, 3), (216, 260, 24, 2), (108, 24, 1, 2),
])
def test_bucket_geometry_and_slot_layout_match(cap_q, cap_kv, heads, nb):
    geo = TP.bucket_geometry(cap_q, cap_kv, heads, nb)
    assert geo == JP.bucket_geometry(cap_q, cap_kv, heads, nb)
    assert TP.bucket_grid_slots(geo) == JP.bucket_grid_slots(geo)
    for want, got in zip(JP.bucket_slot_layout(geo), TP.bucket_slot_layout(geo)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    srow, _, soff, _ = JP.bucket_slot_layout(geo)
    first = np.r_[0, np.flatnonzero(np.diff(srow)) + 1]        # first slot of each row
    np.testing.assert_array_equal(TP.bucket_row_offsets(geo), soff[first])


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def _masks(seed, b, h, t, p=0.6):
    """Random masks with head skew: head 1 is a narrow band, the last head
    is near-full, plus an all-cached (b, h) and an empty KV row."""
    rng = np.random.default_rng(seed)
    m_c = rng.random((b, h, t)) < p
    m_s = rng.random((b, h, t, t)) < p
    band = np.abs(np.arange(t)[:, None] - np.arange(t)[None, :]) < 2
    m_s[:, 1] &= band
    m_s[:, -1] |= rng.random((b, t, t)) < 0.9
    m_c[0, -1] = False
    m_s[-1, 0, 1] = False
    m_c[-1, 0, 1] = True
    return m_c, m_s


@pytest.mark.parametrize("kv_buckets", [2, 3])
@pytest.mark.parametrize("seed,n,h,kw,score", [
    (0, 256, 3, {}, "random"),
    (1, 256, 4, dict(cap_q_frac=0.5, cap_kv_frac=0.4), "ties"),
    (2, 512, 3, dict(cap_q_frac=0.6, cap_kv_frac=0.7), "random"),
    (3, 384, 2, {}, None),
])
def test_bucketed_plan_every_field_exact(kv_buckets, seed, n, h, kw, score):
    jcfg, tcfg = _cfgs(kv_buckets=kv_buckets, **kw)
    t = jcfg.mask.n_blocks(n)
    m_c, m_s = _masks(seed, 2, h, t)
    rng = np.random.default_rng(seed)
    rs = {"random": lambda: rng.random((2, t)).astype(np.float32),
          "ties": lambda: rng.integers(0, 3, (2, t)).astype(np.float32),
          None: lambda: None}[score]()
    want = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s), jcfg, n,
                         row_score=None if rs is None else jnp.asarray(rs))
    got = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, n,
                                 row_score=_t(rs))
    assert got.bkt_head is not None and got.gmo_rows is not None
    for f in TP.DispatchPlan._fields:
        _same(f, getattr(want, f), getattr(got, f))
    assert got.bkt_kv_ids.dtype == torch.int16 and got.gmo_head_ids.dtype == torch.int16
    wide = got.widen()
    jwide = want.widen()
    for f in TP._ID_FIELDS:
        assert getattr(wide, f).dtype == torch.int32 and getattr(wide, f).is_contiguous()
        _same(f"widen {f}", getattr(jwide, f), getattr(wide, f))
    assert wide.widen() is wide                    # already wide: the plan itself
    # Uncompacted ids give the same values.
    full = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, n,
                                  row_score=_t(rs), compact_ids=False)
    assert full.widen() is full
    for f in TP._ID_FIELDS:
        assert torch.equal(getattr(full, f), getattr(wide, f)), f


def test_uniform_plan_has_no_bucket_fields_and_widen_is_identity_when_wide():
    _, tcfg = _cfgs()
    m_c, m_s = _masks(5, 2, 2, 8)
    plan = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, 256)
    assert all(getattr(plan, f) is None for f in TP._BKT_IDS + TP._GMO_IDS)
    wide = plan.widen()
    assert wide is not plan and wide.widen() is wide


# ---------------------------------------------------------------------------
# The plain versions of B4 and B5
# ---------------------------------------------------------------------------

B, H, N, DH, D, POOL, BLK = 2, 4, 256, 32, 64, 32, 16


@pytest.fixture(scope="module", params=[2, 3])
def bucketed(request):
    """A bucketed JAX plan whose buckets clamp both KV lists and head lists."""
    kb = request.param
    cfg = JE.EngineConfig(mask=JM.MaskConfig(block_q=BLK, block_kv=BLK, pool=POOL),
                          cap_q_frac=1.0, cap_kv_frac=1.0, kv_buckets=kb)
    t = N // POOL
    rng = np.random.default_rng(20 + kb)
    m_c = rng.random((B, H, t)) < 0.7
    m_c[:, :2] = True                   # rows live in most heads: GEMM-O clamps
    m_c[1, 3] = False                   # an all-cached (b, h)
    m_s = rng.random((B, H, t, t)) < 0.95
    m_s[:, 2] = np.eye(t, dtype=bool)   # a diagonal head among near-full ones
    m_s[0, 1, 3] = False                # a live row with no KV block
    plan = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s), cfg, N).widen()
    uni = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s),
                        dataclasses.replace(cfg, kv_buckets=1), N).widen()
    p = {f: np.asarray(getattr(plan, f)) for f in plan._fields if getattr(plan, f) is not None}
    assert np.asarray(uni.kv_row_cnt).sum() > p["kv_row_cnt"].sum()     # KV clamp
    assert np.asarray(uni.head_cnt).sum() > p["head_cnt"].sum()         # head clamp
    assert (p["bkt_q_ids"] == N // BLK).any()                          # dead layout rows
    spec = cfg.caps(N)
    return p, spec, JP.bucket_geometry(spec.cap_q, spec.cap_kv, H, kb), \
        JP.bucket_geometry(p["row_ids"].shape[-1], H, 1, kb)


def _rand(seed, *shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _flat(a):
    return a.reshape(B * H, *a.shape[2:])


@pytest.mark.parametrize("compact", [True, False])
def test_attention_bucketed_plain_matches_pallas_and_uniform(bucketed, compact):
    p, _, geo, _ = bucketed
    cr = p["row_ids"].shape[-1]
    q = _rand(1, B * H, (cr if compact else N // POOL) * POOL, DH)
    k, v, o = _rand(2, B * H, N, DH), _rand(3, B * H, N, DH), _rand(4, B * H, N, DH)
    read = p["bkt_q_slots" if compact else "bkt_q_src"]
    args = [p[f] for f in ("bkt_head", "bkt_q_ids")] + [read] + \
        [p[f] for f in ("bkt_kv_ids", "bkt_kv_cnt")]
    launches = TK.flashomni_attention_csr_bucketed.launches
    got = TK.flashomni_attention_csr_bucketed(
        *map(_t, (q, k, v, o)), *map(_t, args), geo, heads=H, block_q=BLK, block_kv=BLK)
    assert TK.flashomni_attention_csr_bucketed.launches == launches   # CPU: plain version
    pallas = j_attn_bkt(*map(jnp.asarray, (q, k, v, o)), *map(jnp.asarray, args), geo,
                        heads=H, block_q=BLK, block_kv=BLK, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FTOL)
    # The uniform plain version on the same plan's clamped per-row counts.
    uni = tref.attention_csr_ref(
        *map(_t, (q, k, v, o)), _t(_flat(p["q_ids"])),
        _t(_flat(p["q_slots" if compact else "q_ids"])), _t(_flat(p["q_cnt"])),
        _t(_flat(p["kv_row_ids"])), _t(_flat(p["kv_row_cnt"])), block_q=BLK, block_kv=BLK)
    assert torch.equal(got, uni)


def test_gemm_o_bucketed_plain_matches_pallas_and_uniform(bucketed):
    p, _, _, geo_o = bucketed
    o, w = _rand(5, B, H, N, DH), _rand(6, H, DH, D, std=(H * DH) ** -0.5)
    bias = _rand(7, B, N, D)
    args = [p[f] for f in ("gmo_rows", "gmo_src", "gmo_head_ids", "gmo_head_cnt")]
    got = TK.gemm_o_sparse_bucketed_kernel(*map(_t, (o, w, bias)), *map(_t, args), geo_o,
                                           block_rows=POOL)
    pallas = j_gemm_o_bkt(*map(jnp.asarray, (o, w, bias)), *map(jnp.asarray, args), geo_o,
                          block_rows=POOL, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **FTOL)
    uni = tref.gemm_o_ref(*map(_t, (o, w, bias)), _t(p["row_ids"]), _t(p["head_ids"]),
                          _t(p["head_cnt"]), block=POOL)
    assert torch.equal(got, uni)


def test_backend_routes_bucketed_plans(bucketed, bucketed_calls):
    """KernelBackend takes B4/B5 for a bucketed spec and plan, B2/B3 otherwise."""
    p, spec, _, _ = bucketed
    plan = TP.DispatchPlan(**{f: _t(p.get(f)) for f in TP.DispatchPlan._fields})
    cr = p["row_ids"].shape[-1]
    q = torch.from_numpy(_rand(8, B, H, cr * POOL, DH))
    k, v, o = (torch.from_numpy(_rand(s, B, H, N, DH)) for s in (9, 10, 11))
    w, bias = torch.from_numpy(_rand(12, H, DH, D)), torch.from_numpy(_rand(13, B, N, D))
    be = TB.KernelBackend()
    spec_u = spec._replace(kv_buckets=1)
    outs = []
    for sp in (spec, spec_u):
        a = be.attention(q, k, v, o, plan, sp, compact_q=True)
        outs.append((a, be.gemm_o(a.transpose(1, 2), w, plan, bias, block=POOL, spec=sp)))
        if sp is spec:
            assert bucketed_calls == {"flashomni_attention_csr_bucketed": 1,
                                      "gemm_o_sparse_bucketed_kernel": 1}
    assert bucketed_calls == {name: 1 for name in (
        "flashomni_attention_csr_bucketed", "gemm_o_sparse_bucketed_kernel",
        "flashomni_attention_csr", "gemm_o_sparse_kernel")}
    (a_b, g_b), (a, g) = outs
    # The uniform route on the bucketed plan consumes the same clamped lists;
    # the uniform kernel keeps o_reuse for all-cached heads on its own.
    assert torch.equal(a_b, a) and torch.equal(g_b, g)


# ---------------------------------------------------------------------------
# Engine round trip
# ---------------------------------------------------------------------------

_STATIC = dict(static_argnums=(3,), static_argnames=("n_text", "heads"))
_j_update = jax.jit(JE.update_layer, **_STATIC)
_j_dispatch = jax.jit(JE.dispatch_layer, **_STATIC)


def _same_plan(want, got, rtol=1e-4):
    for f in TP.DispatchPlan._fields:
        if f == "row_score":       # the one float field (ROADMAP C.3)
            np.testing.assert_allclose(got.row_score.numpy(), np.asarray(want.row_score),
                                       rtol=rtol, atol=1e-5)
            continue
        _same(f"plan.{f}", getattr(want, f), getattr(got, f))


@pytest.mark.parametrize("strategy", ["multi-granularity", "hunyuan-1.5x"])
def test_strategy_emissions_bucketed_roundtrip(strategy):
    b, h, n, dm, dh, n_text = 1, 4, 256, 64, 32, 64
    mask = dict(pool=32, block_q=16, block_kv=16, interval=4, order=1, warmup_steps=1,
                tau_kv=0.15, tau_q=0.5)
    kw = dict(cap_q_frac=1.0, cap_kv_frac=1.0, strategy=strategy, kv_buckets=3)
    jcfg = JE.EngineConfig(mask=JM.MaskConfig(**mask), cache_dtype=jnp.float32, **kw)
    tcfg = TE.EngineConfig(mask=TM.MaskConfig(**mask), cache_dtype=torch.float32, **kw)
    rng = np.random.default_rng(0)
    w = {nm: (rng.standard_normal(s) * 0.05).astype(np.float32) for nm, s in
         (("wq", (dm, h * dh)), ("wk", (dm, h * dh)), ("wv", (dm, h * dh)),
          ("wo", (h * dh, dm)))}
    w["q_scale"] = w["k_scale"] = np.ones(dh, np.float32)
    jp = JE.AttnParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tp = TE.AttnParams(**{k: _t(v) for k, v in w.items()})
    x = rng.standard_normal((b, n, dm)).astype(np.float32)
    x2 = x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)

    jst = JE.init_layer_state(b, h, n, dm, dh, jcfg)
    tst = TE.init_layer_state(b, h, n, dm, dh, tcfg, "cpu")
    _same_plan(jst.plan, tst.plan)                  # the all-live warmup plan
    jout, jst = _j_update(jp, jnp.asarray(x), jst, jcfg, n_text=n_text, heads=h)
    tout, tst = TE.update_layer(tp, _t(x), tst, tcfg, n_text=n_text, heads=h)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    assert tst.plan.bkt_head is not None
    _same_plan(jst.plan, tst.plan)
    for f in ("s_c", "s_s"):
        _same(f, getattr(jst, f), getattr(tst, f))

    jd, jst2 = _j_dispatch(jp, jnp.asarray(x2), jst, jcfg, n_text=n_text, heads=h)
    td, tst2 = TE.dispatch_layer(tp, _t(x2), tst, tcfg, n_text=n_text, heads=h)
    assert bool(torch.isfinite(td).all())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)

    rebuilt = TE.plan_from_state(tst2, tcfg, n)
    for f in TP.DispatchPlan._fields:
        a, c = getattr(rebuilt, f), getattr(tst2.plan, f)
        if a is None:                               # a mesh field of a one-device plan
            assert c is None, f
            continue
        assert a.dtype == c.dtype and torch.equal(a, c), f
    _same_plan(JE.plan_from_state(jst2, jcfg, n), rebuilt)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

STEPS, BATCH = 8, 2


def _run_reference(jcfg, jecfg, nv, seed, **kw):
    jparams = jdit.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    pe = (rng.standard_normal((jcfg.patch_dim, jcfg.d_model)) * 0.2).astype(np.float32)
    x0 = rng.standard_normal((BATCH, nv, jcfg.patch_dim)).astype(np.float32)
    text = rng.standard_normal((BATCH, jcfg.n_text_tokens, jcfg.d_model)).astype(np.float32)
    trace = []
    out = j_sample(jparams, jcfg, jecfg, text_emb=jnp.asarray(text), x0=jnp.asarray(x0),
                   scfg=JSamplerConfig(num_steps=STEPS), patch_embed=jnp.asarray(pe),
                   trace=trace, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return params, pe, x0, text, np.asarray(out), trace


def _check(out, trace, want_out, want_trace):
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-3, atol=1e-4)
    assert [s["kind"] for s in trace] == [s["kind"] for s in want_trace]
    assert [s["kind"] for s in trace].count("dispatch") == 4
    for got, want in zip(trace, want_trace):
        assert abs(got["density"] - want["density"]) <= 1e-6, (got, want)
        assert abs(got["pair_sparsity"] - want["pair_sparsity"]) <= 1e-6, (got, want)


@pytest.fixture
def bucketed_calls(monkeypatch):
    """Counts of the kernel wrappers KernelBackend calls (CPU: plain versions)."""
    counts = {}
    for name in ("flashomni_attention_csr", "flashomni_attention_csr_bucketed",
                 "gemm_o_sparse_kernel", "gemm_o_sparse_bucketed_kernel"):
        fn = getattr(TB, name)

        def spy(*a, _fn=fn, _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(TB, name, spy)
    return counts


def test_hunyuan_schedule_sampler_kv_buckets_3_matches_reference(bucketed_calls):
    """P2': the 4-head smoke variant under the hunyuan-1.5x schedule."""
    jcfg = dataclasses.replace(j_get_smoke("flux-mmdit"), n_heads=4, n_kv_heads=4)
    tcfg = dataclasses.replace(get_smoke("flux-mmdit"), n_heads=4, n_kv_heads=4)
    jecfg = JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), kv_buckets=3)
    params, pe, x0, text, want_out, want_trace = _run_reference(
        jcfg, jecfg, 96, 7, schedule="hunyuan-1.5x")
    trace = []
    out = sample(params, tcfg, serving_engine_config(kv_buckets=3),
                 text_emb=torch.from_numpy(text), x0=torch.from_numpy(x0),
                 patch_embed=torch.from_numpy(pe), scfg=SamplerConfig(num_steps=STEPS),
                 trace=trace, schedule="hunyuan-1.5x")
    _check(out, trace, want_out, want_trace)
    assert bucketed_calls == {"flashomni_attention_csr_bucketed": 3 * 4,
                              "gemm_o_sparse_bucketed_kernel": 3 * 4}


def test_sliding_window_auto_buckets_run_sequential_matches_reference(bucketed_calls):
    """sliding-window with kv_buckets=0 (auto: 2) where the band is narrower
    than the sequence (480 vision + 32 text tokens)."""
    jcfg = j_get_smoke("flux-mmdit")
    jecfg = JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), strategy="sliding-window",
                            kv_buckets=0)
    params, pe, x0, text, want_out, want_trace = _run_reference(jcfg, jecfg, 480, 8)
    ecfg = serving_engine_config("sliding-window", kv_buckets=0)
    assert ecfg.caps(512).kv_buckets == 2
    results = run_sequential(params, get_smoke("flux-mmdit"), ecfg,
                             [Request(rid=0, x0=torch.from_numpy(x0),
                                      text_emb=torch.from_numpy(text), num_steps=STEPS)],
                             patch_embed=torch.from_numpy(pe))
    _check(results[0]["out"], results[0]["trace"], want_out, want_trace)
    assert bucketed_calls == {"flashomni_attention_csr_bucketed": 3 * 4,
                              "gemm_o_sparse_bucketed_kernel": 3 * 4}


@pytest.mark.parametrize("kv_buckets,kept_kv,kept_heads", [(0, 101568, 768), (3, 97205, 474)])
def test_sliding_window_buckets_clamp_gemm_o_heads_not_kv(kv_buckets, kept_kv, kept_heads):
    """A property of the reference that the port reproduces (ROADMAP C.5):
    under ``sliding-window`` every live row keeps all heads, and the
    ``kv_buckets`` that the tuner picks because it leaves every KV list whole
    also sets the GEMM-O head buckets, which drop live (row, head) pairs.  At
    B=1, 24 heads, N=2048, 256 text tokens: auto (2 buckets) keeps all
    101 568 live KV blocks but 768 of 1152 (row, head) pairs; 3 buckets keep
    97 205 and 474."""
    b, h, n, n_text = 1, 24, 2048, 256
    jcfg, tcfg = _cfgs(strategy="sliding-window", kv_buckets=kv_buckets)
    q, k = (np.zeros((b, h, n, 8), np.float32) for _ in range(2))   # the band ignores Q/K
    jctx = JS.StrategyContext(cfg=jcfg, n_text=n_text, n_tokens=n)
    js = JS.get_strategy("sliding-window").emit(jnp.asarray(q), jnp.asarray(k), jctx)
    ts = TS.get_strategy("sliding-window").emit(
        _t(q), _t(k), TS.StrategyContext(cfg=tcfg, n_text=n_text, n_tokens=n))
    rs = np.asarray(jnp.sum(jnp.where(js.m_c, js.q_scores, 0.0), axis=-2))
    want = _j_build_plan(js.m_c, js.m_s, jcfg, n, row_score=jnp.asarray(rs))
    got = TP.build_dispatch_plan(ts.m_c, ts.m_s, tcfg, n, row_score=_t(rs))
    for f in TP.DispatchPlan._fields:
        _same(f, getattr(want, f), getattr(got, f))
    uni = TP.build_dispatch_plan(ts.m_c, ts.m_s, dataclasses.replace(tcfg, kv_buckets=1), n,
                                 row_score=_t(rs))
    live = lambda p: torch.arange(p.kv_row_cnt.shape[-1]) < p.q_cnt[..., None]
    kv = lambda p: int(torch.where(live(p), p.kv_row_cnt, 0).sum())
    assert kv(uni) == 101568 and kv(got) == kept_kv
    assert int(uni.head_cnt.sum()) == 1152
    assert int(got.head_cnt.sum()) == kept_heads         # live (row, head) pairs kept
