"""Port parity: plan-sharded mesh dispatch (``repro_torch.distributed.
plan_shard``, ``launch/mesh``, ``core.backend.MeshBackend``) against the JAX
reference and against the port's own single-device Dispatch.

  * the geometry functions, the pair-clamp fold and every ``shd_*`` plan
    field (and the folded ``kv_row_cnt``) exactly equal to the reference's,
    over ``mesh_sp`` ∈ {2, 4} × slack ∈ {1.5, 0.5} (the pair clamp binds at
    0.5) × three strategies × ``kv_buckets`` ∈ {1, 3};
  * in a spawned ``gloo`` world of 8 ranks, mesh (2, 4): the mesh
    ``dispatch_layer`` ``torch.equal`` to the single-device one on the same
    state, seq mode over the same grid for the kernels (their plain
    versions here) and the twin, and head mode; two all-to-alls and one
    all-gather per seq layer, the all-gather alone in head mode;
  * the single-device Dispatch of a mesh plan within the Dispatch-step
    tolerance of the reference's ``XlaBackend`` on the same state;
  * in a world of 2, mesh (1, 2): a smoke sampler ``torch.equal`` to the
    single-device one, ``serve_diffusion`` in two serving modes, the
    analyzer's mesh passes (no finding), its ``mesh-allgather`` fixture
    (exit 1), and the NCCL check refusing ranks that share a device;
  * no world: a mesh request raises.

The spawned ranks run module-level functions of this file: it imports
neither JAX nor the reference at module level, so a rank imports torch
only.  Each spawn joins within 120 s or fails.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.launch.mesh import run_local_mesh

SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)
# The reference's mesh prelude (tests/test_distributed.py): B, H, n, d_model, dh.
B, H, N, DM, DH = 2, 4, 256, 64, 16
STRATEGIES = ("flashomni", "hunyuan-1.5x", "multi-granularity")
GRID = list(itertools.product(STRATEGIES, (1, 3), (1.5, 0.5)))   # strategy, kv_buckets, slack
FTOL = dict(rtol=1e-4, atol=1e-5)        # a whole Dispatch step (test_torch_engine)
JOIN_S = 120


def _weights(seed=7):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in
         (("wq", (DM, H * DH)), ("wk", (DM, H * DH)), ("wv", (DM, H * DH)),
          ("wo", (H * DH, DM)))}
    w["q_scale"] = w["k_scale"] = np.ones(DH, np.float32)
    return w, rng.standard_normal((B, N, DM)).astype(np.float32)


def _tcfg(**kw):
    return TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw)


def _ref():
    """The reference's modules, imported where a test needs them."""
    import jax
    from repro.core import engine as JE
    from repro.core import masks as JM
    from repro.core import plan as JP
    from repro.distributed import plan_shard as JS
    from repro.launch import mesh as JL
    return jax, JE, JM, JP, JS, JL


def _jcfg(**kw):
    _, JE, JM, *_ = _ref()
    return JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw)


# ---------------------------------------------------------------------------
# The geometry, the fold and the shd_* fields, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp,slack", [(4, 1.5), (2, 1.5), (4, 0.5), (2, 64.0), (3, 1.0)])
def test_shard_geometry_math(sp, slack):
    from repro_torch.distributed import plan_shard as TS
    _, _, _, _, JS, _ = _ref()
    spec_t, spec_j = _tcfg().caps(N), _jcfg().caps(N)
    t = 48 if sp == 3 else 16
    g = TS.shard_geometry(spec_t, t, t, sp, pair_slack=slack)
    assert tuple(g) == tuple(JS.shard_geometry(spec_j, t, t, sp, pair_slack=slack))
    assert g.buf_blocks == g.kv_bps + sp * g.pair_cap
    assert TS.exchange_blocks(g) == sp * g.pair_cap == JS.exchange_blocks(g)
    assert TS.dense_exchange_blocks(t) == t == JS.dense_exchange_blocks(t)
    if slack >= 1:                   # the union admits every row list
        assert g.cap_kv >= min(spec_t.cap_kv, t)


def test_shard_geometry_rejects_what_the_reference_rejects():
    from repro_torch.distributed import plan_shard as TS
    spec = _tcfg().caps(N)
    with pytest.raises(ValueError, match="divisible"):
        TS.shard_geometry(spec, 15, 16, 4)
    with pytest.raises(ValueError, match="mesh_sp"):
        TS.shard_geometry(spec, 16, 16, 0)


def _masks(seed, t, b=B, h=H):
    rng = np.random.default_rng(seed)
    m_c = rng.random((b, h, t)) < 0.7
    m_s = rng.random((b, h, t, t)) < 0.5
    m_c[..., 0] = m_s[..., 0] = True          # every row reads block 0
    return m_c, m_s


@pytest.mark.parametrize("sp,slack", [(2, 1.5), (4, 0.5), (4, 0.25)])
def test_mesh_keep_rows_matches_reference(sp, slack):
    """The pair clamp on random per-row masks (ties in the need counts
    included): the kept rows equal the reference's exactly."""
    import jax.numpy as jnp
    from repro_torch.core.symbols import active_indices
    from repro_torch.distributed import plan_shard as TS
    _, _, _, _, JS, _ = _ref()
    t = 16
    rng = np.random.default_rng(sp)
    rows = rng.random((B, H, 12, t)) < 0.5
    q_ids, q_cnt = active_indices(torch.from_numpy(rng.random((B, H, t)) < 0.6), 12)
    spec = _tcfg().caps(N)
    g = TS.shard_geometry(spec, t, t, sp, slack)
    got = TS.mesh_keep_rows(torch.from_numpy(rows), q_ids, q_cnt, g)
    want = JS.mesh_keep_rows(jnp.asarray(rows), jnp.asarray(q_ids.numpy()),
                             jnp.asarray(q_cnt.numpy()), g)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool((got <= torch.from_numpy(rows)).all())           # it only drops


def test_identity_fold_is_noop():
    """pair_cap at its safe bound (kv_bps): the fold keeps every block, so the
    one-device fields match the plan built without a mesh bit for bit."""
    m_c, m_s = (torch.from_numpy(a) for a in _masks(0, N // 32))
    p0 = TP.build_dispatch_plan(m_c, m_s, _tcfg(), N)
    pm = TP.build_dispatch_plan(m_c, m_s, _tcfg(mesh_sp=2, mesh_pair_slack=64.0), N)
    for f in ("q_ids", "q_cnt", "q_slots", "kv_ids", "kv_cnt", "pair_live", "kv_row_ids",
              "kv_row_cnt", "row_ids", "row_cnt", "head_ids", "head_cnt", "occ_hist"):
        assert torch.equal(getattr(p0, f), getattr(pm, f)), f
    assert p0.shd_q_ids is None and pm.shd_q_ids is not None


def _strategy_masks(strategy):
    """(m_c, m_s, row_score) of one Update of the prelude's layer under
    ``strategy`` (the port's emission; it matches the reference's exactly,
    tests/test_torch_strategy_schedule.py)."""
    w, x = _weights()
    cfg = _tcfg(strategy=strategy)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    _, st = TE.update_layer(p, torch.from_numpy(x), TE.init_layer_state(B, H, N, DM, DH, cfg,
                                                                      "cpu"),
                            cfg, n_text=32, heads=H, step_idx=2, num_steps=8)
    m_c, m_s = TE._unpack(st, cfg, N)
    return m_c, m_s, st.plan.row_score


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_shd_fields_match_reference(strategy):
    """Every plan field, the shd_* partition and the folded kv_row_cnt
    included, equal to the reference's plan built on one CPU device from the
    same masks, over mesh_sp × slack × kv_buckets."""
    import jax
    import jax.numpy as jnp
    _, _, _, JP, _, _ = _ref()
    build = jax.jit(JP.build_dispatch_plan, static_argnums=(2, 3))
    m_c, m_s, score = _strategy_masks(strategy)
    args = (jnp.asarray(m_c.numpy()), jnp.asarray(m_s.numpy()))
    folded = 0
    for sp, slack, kvb in itertools.product((2, 4), (1.5, 0.5), (1, 3)):
        kw = dict(strategy=strategy, kv_buckets=kvb, mesh_dp=1, mesh_sp=sp,
                  mesh_pair_slack=slack)
        want = build(*args, _jcfg(**kw), N, jnp.asarray(score.numpy()))
        got = TP.build_dispatch_plan(m_c, m_s, _tcfg(**kw), N, row_score=score)
        assert got.shd_q_ids is not None
        for f in TP.DispatchPlan._fields:
            w, g = getattr(want, f), getattr(got, f)
            if w is None:
                assert g is None, f
                continue
            w, g = np.asarray(w), g.numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, (f, w.dtype, g.dtype)
            if f == "row_score":
                assert np.array_equal(w, g), f
                continue
            assert int(np.sum(w != g)) == 0, f"{f} ({sp}, {slack}, {kvb}): differs"
        one = TP.build_dispatch_plan(m_c, m_s, _tcfg(strategy=strategy, kv_buckets=kvb), N,
                                     row_score=score)
        folded += int((got.kv_row_cnt != one.kv_row_cnt).sum())
        if slack >= 1.5:        # pair_cap at kv_bps here: the fold keeps every block
            assert torch.equal(got.kv_row_cnt, one.kv_row_cnt)
    assert folded > 0           # and at slack 0.5 the clamp binds


def test_plan_from_state_rebuilds_shd_bit_exact():
    w, x = _weights(3)
    cfg = _tcfg(kv_buckets=3, mesh_sp=4, mesh_pair_slack=0.5)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    _, st = TE.update_layer(p, torch.from_numpy(x),
                            TE.init_layer_state(B, H, N, DM, DH, cfg, "cpu"), cfg, heads=H)
    rebuilt = TE.plan_from_state(st, cfg, N)
    assert st.plan.shd_q_ids is not None and st.plan.shd_q_ids.dtype == torch.int16
    for f in TP.DispatchPlan._fields:
        a, b = getattr(st.plan, f), getattr(rebuilt, f)
        if a is None:
            assert b is None, f
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), f
    wide = st.plan.widen()
    assert all(getattr(wide, f).dtype == torch.int32 for f in TP._SHD_IDS)


def test_port_mesh_plan_passes_the_validator():
    """plan_check's shd_* block on the port's own mesh plans: clean, and a
    mutated send count and gather index are found."""
    from repro_torch.analysis.plan_check import check_plan
    w, x = _weights(5)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    for sp, slack, kvb in ((2, 1.5, 1), (4, 0.5, 3)):
        cfg = _tcfg(kv_buckets=kvb, mesh_sp=sp, mesh_pair_slack=slack)
        _, st = TE.update_layer(p, torch.from_numpy(x),
                                TE.init_layer_state(B, H, N, DM, DH, cfg, "cpu"), cfg, heads=H)
        assert check_plan(st.plan, cfg, N) == []
        bad = st.plan._replace(shd_send_cnt=st.plan.shd_send_cnt + 1000,
                               shd_gather_idx=st.plan.shd_gather_idx - 1000)
        msgs = check_plan(bad, cfg, N)
        assert any("shd_send_cnt exceeds pair_cap" in m for m in msgs)
        assert any("shd_gather_idx outside" in m for m in msgs)


def test_engine_config_mesh_fields():
    cfg = _tcfg(kv_buckets=0, mesh_sp=2)
    assert cfg.resolved_kv_buckets() == 1 == _jcfg(kv_buckets=0, mesh_sp=2).resolved_kv_buckets()
    assert _tcfg(kv_buckets=0).resolved_kv_buckets() == _jcfg(kv_buckets=0).resolved_kv_buckets()
    for bad in (dict(mesh_sp=0), dict(mesh_dp=0), dict(mesh_axis="row"),
                dict(mesh_pair_slack=0.0)):
        with pytest.raises(ValueError):
            _tcfg(**bad)


def test_mesh_attention_validation_errors():
    """The reference's errors, word for word, before any world is needed."""
    from repro_torch.core.backend import KernelBackend, TorchBackend
    from repro_torch.distributed.plan_shard import mesh_attention
    m_c, m_s = (torch.from_numpy(a) for a in _masks(0, N // 32))
    cfg0 = _tcfg()
    plan = TP.build_dispatch_plan(m_c, m_s, cfg0, N)
    spec = cfg0.caps(N)
    z = torch.zeros((B, H, N, DH))
    for inner in (TorchBackend(), KernelBackend()):
        with pytest.raises(ValueError, match=r"shd_\* fields missing"):
            mesh_attention(inner, dataclasses.replace(cfg0, mesh_sp=2), z, z, z, z, plan, spec)
        with pytest.raises(ValueError, match="heads 4 not divisible by mesh_sp=3"):
            mesh_attention(inner, dataclasses.replace(cfg0, mesh_sp=3, mesh_axis="head"),
                           z, z, z, z, plan, spec)
        with pytest.raises(ValueError, match="cannot shard the bucketed layout"):
            mesh_attention(inner, dataclasses.replace(cfg0, mesh_sp=2, mesh_axis="head"),
                           z, z, z, z, plan, spec._replace(kv_buckets=3))
        with pytest.raises(ValueError, match="batch 2 not divisible by mesh_dp=3"):
            mesh_attention(inner, dataclasses.replace(cfg0, mesh_dp=3), z, z, z, z, plan,
                           spec)


def test_mesh_shape_for_matches_reference():
    from repro_torch.launch.mesh import mesh_shape_for
    _, _, _, _, _, JL = _ref()
    for n, cap in ((512, (16, 16)), (32, (16, 16)), (1024, (2, 16, 16)), (8, (16, 16)),
                   (6, (16, 16)), (1, (16, 16)), (3, (4, 2))):
        assert mesh_shape_for(n, cap) == JL.mesh_shape_for(n, cap)
    with pytest.raises(ValueError, match="power"):
        mesh_shape_for(8, (3, 16))
    with pytest.raises(ValueError, match="device"):
        mesh_shape_for(0, (16, 16))


def test_mesh_needs_an_initialised_world():
    """A mesh request without a world raises: the mesh, the Dispatch that
    needs it and the server."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.serve import serve_diffusion
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        make_engine_mesh(1, 2)
    w, x = _weights()
    cfg = _tcfg(mesh_sp=2)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    _, st = TE.update_layer(p, torch.from_numpy(x),
                            TE.init_layer_state(B, H, N, DM, DH, cfg, "cpu"), cfg, heads=H)
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        TE.dispatch_layer(p, torch.from_numpy(x), st, cfg, heads=H)
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        serve_diffusion("flux-mmdit", mesh=(1, 2), device="cpu", verbose=False)


@pytest.mark.parametrize("case", [("flashomni", 1, 1.5), ("flashomni", 3, 0.5),
                                  ("multi-granularity", 1, 0.5)])
def test_single_device_dispatch_of_a_mesh_plan_matches_reference(case):
    """The reference's Update under the mesh config, its state moved across:
    the port's one-device Dispatch of that mesh plan (kernels' plain versions
    and the twin, per-row forced by the shd_* fields) within the Dispatch-step
    tolerance of the reference's XlaBackend."""
    import jax
    import jax.numpy as jnp
    from repro_torch.core import taylorseer as TT
    _, JE, _, _, _, _ = _ref()
    t = lambda a: None if a is None else torch.from_numpy(np.array(a, copy=True))
    strategy, kvb, slack = case
    w, x = _weights()
    kw = dict(strategy=strategy, kv_buckets=kvb, mesh_dp=2, mesh_sp=4, mesh_pair_slack=slack)
    jcfg = _jcfg(cache_dtype=jnp.float32, **kw)
    static = dict(static_argnums=(3,), static_argnames=("n_text", "heads"))
    jp = JE.AttnParams(**{k: jnp.asarray(v) for k, v in w.items()})
    _, jst = jax.jit(JE.update_layer, **static)(
        jp, jnp.asarray(x), JE.init_layer_state(B, H, N, DM, DH, jcfg), jcfg, heads=H)
    want, _ = jax.jit(JE.dispatch_layer, **static)(
        jp, jnp.asarray(x), jst, dataclasses.replace(jcfg, mesh_dp=1, mesh_sp=1), heads=H)
    st = TE.LayerState(
        s_c=t(jst.s_c), s_s=t(jst.s_s), k_since=int(jst.k_since),
        taylor=TT.TaylorState(t(jst.taylor.derivs), int(jst.taylor.n_updates)),
        plan=TP.DispatchPlan(**{f: t(getattr(jst.plan, f)) for f in TP.DispatchPlan._fields}))
    assert st.plan.shd_q_ids is not None
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    for backend in ("kernels", "torch"):
        cfg1 = _tcfg(cache_dtype=torch.float32, backend=backend, strategy=strategy,
                     kv_buckets=kvb)
        got, _ = TE.dispatch_layer(p, torch.from_numpy(x), st, cfg1, heads=H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FTOL, err_msg=backend)


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------

def _world8(rank, w, x):
    """Every GRID case in seq mode, both backends, then head mode: (case,
    torch.equal(mesh, one device), max |diff|, collective counts)."""
    from repro_torch.analysis.op_walk import collective_counts, record_call
    torch.set_num_threads(1)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    xt = torch.from_numpy(x)
    cases = [(b, s, kvb, slack, "seq") for b in ("kernels", "torch")
             for s, kvb, slack in GRID]
    cases += [(b, "flashomni", 1, 1.5, "head") for b in ("kernels", "torch")]
    out = []
    for backend, strategy, kvb, slack, axis in cases:
        cfgm = _tcfg(backend=backend, strategy=strategy, kv_buckets=kvb, mesh_dp=2, mesh_sp=4,
                     mesh_pair_slack=slack, mesh_axis=axis)
        _, st = TE.update_layer(p, xt, TE.init_layer_state(B, H, N, DM, DH, cfgm, "cpu"),
                                cfgm, heads=H)
        (om, _), rec = record_call(TE.dispatch_layer, p, xt, st, cfgm, heads=H)
        o1, _ = TE.dispatch_layer(p, xt, st, dataclasses.replace(cfgm, mesh_dp=1, mesh_sp=1),
                                  heads=H)
        out.append(((backend, strategy, kvb, slack, axis), bool(torch.equal(om, o1)),
                    float((om - o1).abs().max()), dict(collective_counts(rec))))
    return out


def test_mesh_dispatch_bit_parity_in_a_world_of_8():
    w, x = _weights()
    ranks = run_local_mesh(_world8, 2, 4, w, x, timeout=JOIN_S)
    assert all(r == ranks[0] for r in ranks[1:])           # every rank holds the output
    assert len(ranks[0]) == 2 * len(GRID) + 2
    for case, equal, diff, coll in ranks[0]:
        assert equal, f"{case}: mesh differs from one device by {diff}"
        want = {"all_to_all": 2, "all_gather": 1} if case[-1] == "seq" else {"all_gather": 1}
        assert coll == want, (case, coll)


def _world2(rank):
    """Mesh (1, 2): a smoke sampler against one device, the server in two
    modes, the analyzer's mesh parts and fixture, and NCCL refused for ranks
    that share a device."""
    from repro_torch.analysis import AnalysisContext, __main__ as cli
    from repro_torch.analysis.cost_passes import CollectiveBytesBudget
    from repro_torch.analysis.passes import CollectiveBudget, DispatchPurity, sweep_configs
    from repro_torch.configs.registry import get_smoke
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    from repro_torch.launch.mesh import _check_one_card_per_rank
    from repro_torch.launch.serve import serve_diffusion, serving_engine_config, serving_inputs
    torch.set_num_threads(1)
    res = {}
    cfg = get_smoke("flux-mmdit")
    params, pe, (req,) = serving_inputs(cfg, n_vision=96, batch=2, num_requests=1,
                                        num_steps=8, device="cpu")
    outs = {}
    for mesh in ((1, 2), (1, 1)):
        ecfg = serving_engine_config(mesh=mesh)
        outs[mesh] = sample(params, cfg, ecfg, text_emb=req.text_emb, x0=req.x0,
                            patch_embed=pe, scfg=SamplerConfig(num_steps=8))
    res["sample_equal"] = bool(torch.equal(outs[(1, 2)], outs[(1, 1)]))
    for serving in ("sequential", "stacked"):
        r = serve_diffusion("flux-mmdit", num_requests=2, num_steps=6, serving=serving,
                            mesh=(1, 2), device="cpu", verbose=False)
        res[serving] = all(bool(torch.isfinite(v["out"]).all()) for v in r.values())
    ctx = AnalysisContext(src_root="", device="cpu")
    purity = DispatchPurity()
    findings = [f for label, c in sweep_configs(meshes=(True,))
                for f in purity.check(label, c, "cpu")]
    findings += CollectiveBudget().run(ctx) + CollectiveBytesBudget().run(ctx)
    res["analysis"] = [str(f) for f in findings]
    res["notes"] = ctx.notes
    res["fixture_rc"] = cli.main(["--device", "cpu", "--fixture", "mesh-allgather", "-q"])
    try:                                   # what an NCCL world runs first
        _check_one_card_per_rank(torch.distributed.group.WORLD)
        res["nccl"] = "no error"
    except ValueError as e:
        res["nccl"] = str(e)
    return res


def test_mesh_serving_and_analysis_in_a_world_of_2():
    ranks = run_local_mesh(_world2, 1, 2, timeout=JOIN_S)
    for r in ranks:
        assert r["sample_equal"]
        assert r["sequential"] and r["stacked"]
        assert r["analysis"] == [], r["analysis"]
        assert any("a2a payload" in n for n in r["notes"]), r["notes"]
        assert r["fixture_rc"] == 1
        assert "transport='gloo'" in r["nccl"], r["nccl"]
