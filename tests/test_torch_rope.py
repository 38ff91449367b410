"""Port parity: the engine's RoPE (``rope_freqs``, ``apply_rope`` and
``freqs=`` in ``update_layer``/``dispatch_layer``) against the JAX reference.

  * ``rope_freqs`` equal to the reference's table bit for bit;
    ``apply_rope`` within rtol 1e-6 in float32 and one bfloat16 ulp in
    bfloat16, on the full table and on a gathered (B, 1, n_q, dh/2) one;
  * Update with ``freqs``: the outputs within the Dispatch-step tolerance,
    the packed symbols and every integer plan field exact, in both cache
    modes, at ``cap_q_frac`` 0.75 (capacity-truncated gathers) and 1.0,
    with 1 and 2 KV buckets;
  * Dispatch with ``freqs`` on the reference's state: the kernels' plain
    versions (compact GEMM-Q rows rotated at their original positions),
    the twin and ``use_gemm_q=False`` against the reference's XLA and
    Pallas (interpret) backends at rtol 1e-4 / atol 1e-5;
  * the positions of int16 row ids at hunyuan-video-dit's 33 024 tokens
    computed in int64;
  * in a spawned ``gloo`` world of 2, mesh (1, 2) on the ``seq`` axis: the
    mesh Dispatch with ``freqs`` ``torch.equal`` to one device.

The spawned ranks import this module: it imports neither JAX nor the
reference at module level, so a rank imports torch only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import backend as TB
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core import taylorseer as TT
from repro_torch.launch.mesh import run_local_mesh

B, H, DH, DM, N, N_TEXT = 2, 2, 32, 64, 256, 32
SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)
FTOL = dict(rtol=1e-4, atol=1e-5)        # a whole Dispatch step (test_torch_engine)
CASES = [(mode, capq, kvb) for mode in ("bias", "o_cache") for capq in (0.75, 1.0)
         for kvb in (1, 2)]
PORT = {"kernels": dict(backend="kernels"), "torch": dict(backend="torch"),
        "no-gemm-q": dict(backend="kernels", use_gemm_q=False)}


@functools.cache
def _ref():
    """The reference's engine and its steps, jitted once per config."""
    import jax
    from repro.core import engine as JE
    from repro.core import masks as JM
    static = dict(static_argnums=(3,), static_argnames=("n_text", "heads"))
    return jax, JE, JM, jax.jit(JE.update_layer, **static), jax.jit(JE.dispatch_layer, **static)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _cfgs(**kw):
    _, JE, JM, _, _ = _ref()
    import jax.numpy as jnp
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), cache_dtype=jnp.float32, **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), cache_dtype=torch.float32, **kw))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    s = DM ** -0.5
    w = {n: (rng.standard_normal(shape) * s).astype(np.float32) for n, shape in
         (("wq", (DM, H * DH)), ("wk", (DM, H * DH)), ("wv", (DM, H * DH)),
          ("wo", (H * DH, DM)))}
    w["q_scale"] = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    w["k_scale"] = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    return w


def _x(seed):
    return np.random.default_rng(seed).standard_normal((B, N, DM)).astype(np.float32)


def _state_to_torch(st) -> TE.LayerState:
    plan = TP.DispatchPlan(**{f: _t(getattr(st.plan, f)) for f in TP.DispatchPlan._fields})
    return TE.LayerState(s_c=_t(st.s_c), s_s=_t(st.s_s),
                         taylor=TT.TaylorState(derivs=_t(st.taylor.derivs),
                                               n_updates=int(st.taylor.n_updates)),
                         k_since=int(st.k_since), plan=plan)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# ---------------------------------------------------------------------------
# The table and the rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dim", [(256, 32), (4608, 128), (33024, 128)])
def test_rope_freqs_equal_to_the_reference(n, dim):
    _, JE, _, _, _ = _ref()
    got = TE.rope_freqs(n, dim, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, dim // 2)
    assert np.array_equal(got.numpy(), np.asarray(JE.rope_freqs(n, dim)))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 (8 significant bits) at each |a|."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gathered", [False, True])
def test_apply_rope_matches_the_reference(dtype, gathered):
    """On the transposed (B, H, N, dh) view the engine rotates, with the full
    table or a per-batch gathered one that broadcasts over the heads."""
    _, JE, _, _, _ = _ref()
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, N, H, DH)).astype(np.float32)
    freqs = np.asarray(JE.rope_freqs(N, DH))
    if gathered:
        pos = rng.integers(0, N, (B, N // 2))
        freqs, x = freqs[pos][:, None], x[:, : N // 2]
    jx = jnp.asarray(x).astype(dtype).transpose(0, 2, 1, 3)
    tx = _t(x).to(getattr(torch, dtype)).transpose(1, 2)
    got = TE.apply_rope(tx, _t(freqs))
    want = np.asarray(JE.apply_rope(jx, jnp.asarray(freqs)).astype(jnp.float32))
    assert got.dtype == tx.dtype and got.shape == tx.shape and got.is_contiguous()
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


def test_rope_positions_of_int16_ids_at_33k_tokens():
    """hunyuan-video-dit's 33 024 tokens at pool 32 are 1032 row blocks: the
    plan keeps their ids in int16, whose product with the pool overflows;
    the positions come out of int64 arithmetic, on the plan and widened."""
    n, pool = 33024, 32
    t = n // pool
    cfg = TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), cap_q_frac=1.0)
    m_c = torch.zeros((1, 1, t), dtype=torch.bool)
    m_c[..., ::3] = True
    m_c[..., t - 1] = True                                    # block 1031 is live
    idx = torch.arange(t)
    m_s = ((idx[None, :] - idx[:, None]) % t < 2).expand(1, 1, t, t)
    plan = TP.build_dispatch_plan(m_c, m_s, cfg, n)
    assert plan.row_ids.dtype == torch.int16 and int(plan.row_ids.max()) == t - 1
    assert int((plan.row_ids * pool).min()) < 0               # int16 wraps
    ids = plan.row_ids.numpy().astype(np.int64)
    want = (ids[..., None] * pool + np.arange(pool)).reshape(1, -1)
    for row_ids in (plan.row_ids, plan.widen().row_ids):
        got = TE.rope_positions(row_ids, pool, n)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
    assert int(want.max()) == n - 1


def test_rope_positions_clamp_past_the_table_as_the_reference_gathers():
    """A partial last block: positions past the table read its last row,
    as the reference's ``freqs[pos]`` does."""
    _, JE, _, _, _ = _ref()
    import jax.numpy as jnp
    n = 100
    freqs = JE.rope_freqs(n, 8)
    ids = np.array([[0, 3]], np.int32)                       # block 3: tokens 96..127
    pos = TE.rope_positions(torch.from_numpy(ids), 32, n)
    want = np.asarray(freqs[(jnp.asarray(ids)[..., None] * 32 + jnp.arange(32)).reshape(1, -1)])
    assert np.array_equal(_t(freqs)[pos].numpy(), want)


# ---------------------------------------------------------------------------
# Update and Dispatch with freqs, port against reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(map(str, c)))
def updated(request):
    """Two Update steps with ``freqs`` through both engines from one state."""
    mode, capq, kvb = request.param
    jax, JE, _, j_update, _ = _ref()
    import jax.numpy as jnp
    jcfg, tcfg = _cfgs(cache_mode=mode, cap_q_frac=capq, kv_buckets=kvb)
    w = _weights()
    jp = JE.AttnParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tp = TE.AttnParams(**{k: _t(v) for k, v in w.items()})
    jfreqs = JE.rope_freqs(N, DH)
    tfreqs = _t(jfreqs)
    jst = JE.init_layer_state(B, H, N, DM, DH, jcfg)
    tst = TE.init_layer_state(B, H, N, DM, DH, tcfg, "cpu")
    steps = []
    for seed in (1, 2):
        x = _x(seed)
        jout, jst = j_update(jp, jnp.asarray(x), jst, jcfg, n_text=N_TEXT, heads=H,
                             freqs=jfreqs)
        tout, tst = TE.update_layer(tp, _t(x), tst, tcfg, n_text=N_TEXT, heads=H,
                                    freqs=tfreqs)
        steps.append((np.asarray(jout), tout, jst, tst))
    return request.param, (jp, tp), (jfreqs, tfreqs), steps, {}


def test_update_layer_with_rope_matches(updated):
    (mode, capq, kvb), (_, tp), (_, tfreqs), steps, _ = updated
    for jout, tout, jst, tst in steps:
        np.testing.assert_allclose(tout.numpy(), jout, **FTOL)
        for f in ("s_c", "s_s"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
        for f in TP.DispatchPlan._fields:
            want, got = getattr(jst.plan, f), getattr(tst.plan, f)
            if want is None:
                assert got is None, f
            elif f == "row_score":          # the one float field
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **FTOL)
            else:
                want, got = np.asarray(want), got.numpy()
                assert want.dtype == got.dtype, f
                assert int(np.sum(want != got)) == 0, f"plan.{f}: {np.sum(want != got)} differ"
        np.testing.assert_allclose(tst.taylor.derivs.numpy(), np.asarray(jst.taylor.derivs),
                                   **FTOL)
    live = steps[-1][3].plan.q_cnt
    assert 0 < int(live.sum()) < B * H * steps[-1][3].plan.q_ids.shape[-1]   # sparse
    # RoPE is applied: the same Update without it gives another output.
    _, _, _, tst = steps[-1]
    no_rope, _ = TE.update_layer(tp, _t(_x(2)), tst, _cfgs(cache_mode=mode, cap_q_frac=capq,
                                                           kv_buckets=kvb)[1],
                                 n_text=N_TEXT, heads=H)
    assert _rel_l2(no_rope, steps[-1][1]) > 100 * FTOL["rtol"]


def _reference_dispatch(updated, ref_backend):
    """The reference's two Dispatch steps with ``freqs`` (memoised per
    backend on the fixture)."""
    (mode, capq, kvb), (jp, _), (jfreqs, _), steps, memo = updated
    if ref_backend not in memo:
        _, JE, _, _, j_dispatch = _ref()
        import jax.numpy as jnp
        jcfg = dataclasses.replace(_cfgs(cache_mode=mode, cap_q_frac=capq, kv_buckets=kvb)[0],
                                   backend=ref_backend, interpret=True)
        jst, outs = steps[-1][2], []
        for seed in (3, 4):                    # Dispatch offsets k_since = 1, 2
            jout, jst = j_dispatch(jp, jnp.asarray(_x(seed)), jst, jcfg, n_text=N_TEXT,
                                   heads=H, freqs=jfreqs)
            outs.append(np.asarray(jout))
        memo[ref_backend] = outs
    return memo[ref_backend]


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("port", list(PORT))
def test_dispatch_layer_with_rope_matches(updated, port, ref_backend):
    (mode, capq, kvb), (_, tp), (_, tfreqs), steps, _ = updated
    want = _reference_dispatch(updated, ref_backend)
    tcfg = dataclasses.replace(_cfgs(cache_mode=mode, cap_q_frac=capq, kv_buckets=kvb)[1],
                               **PORT[port])
    assert (TB.get_backend(tcfg).compact_q and tcfg.use_gemm_q) == (port == "kernels")
    tst = _state_to_torch(steps[-1][2])
    for seed, jout in zip((3, 4), want):
        tout, tst = TE.dispatch_layer(tp, _t(_x(seed)), tst, tcfg, n_text=N_TEXT, heads=H,
                                      freqs=tfreqs)
        np.testing.assert_allclose(tout.numpy(), jout, **FTOL)
    assert tst.k_since == 2


# ---------------------------------------------------------------------------
# The mesh: MeshBackend takes compact_q from its inner backend
# ---------------------------------------------------------------------------

def _mesh_rank(rank, w, x):
    """Mesh (1, 2) on the seq axis with ``freqs``, both backends: (backend,
    compact_q, torch.equal(mesh, one device), max |diff|, rel-L2 to the run
    without ``freqs``)."""
    torch.set_num_threads(1)
    p = TE.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    xt = torch.from_numpy(x)
    freqs = TE.rope_freqs(N, DH, device="cpu")
    out = []
    for backend in ("kernels", "torch"):
        cfgm = TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), backend=backend,
                               cap_q_frac=0.75, mesh_sp=2, mesh_axis="seq")
        st0 = TE.init_layer_state(B, H, N, DM, DH, cfgm, "cpu")
        _, st = TE.update_layer(p, xt, st0, cfgm, n_text=N_TEXT, heads=H, freqs=freqs)
        om, _ = TE.dispatch_layer(p, xt, st, cfgm, n_text=N_TEXT, heads=H, freqs=freqs)
        one = dataclasses.replace(cfgm, mesh_sp=1)
        o1, _ = TE.dispatch_layer(p, xt, st, one, n_text=N_TEXT, heads=H, freqs=freqs)
        bare, _ = TE.dispatch_layer(p, xt, st, one, n_text=N_TEXT, heads=H)
        out.append((backend, TB.get_backend(cfgm).compact_q, bool(torch.equal(om, o1)),
                    float((om - o1).abs().max()), _rel_l2(bare, o1)))
    return out


def test_mesh_dispatch_with_rope_equals_one_device():
    w = _weights()
    ranks = run_local_mesh(_mesh_rank, 1, 2, w, _x(6), timeout=120)
    assert ranks[0] == ranks[1]                               # every rank holds the output
    for backend, compact, equal, diff, rel in ranks[0]:
        assert compact == (backend == "kernels"), backend
        assert equal, f"{backend}: mesh differs from one device by {diff}"
        assert rel > 100 * FTOL["rtol"], (backend, rel)
