"""Port parity: ``update_layer`` and ``dispatch_layer`` (repro_torch vs the
JAX reference on the same LayerState), in both cache modes.

Update: the packed symbols and every plan field exact, the outputs and the
TaylorSeer stack to f32 rtol 1e-4 / atol 1e-5.  Dispatch runs on the JAX
state moved across (so it is held on the reference's own plan) against the
reference's XLA and Pallas (interpret) backends.  The Taylor cache is f32
here so the cached features compare at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import masks as JM
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core import taylorseer as TT

B, H, DH, DM, N, N_TEXT = 2, 2, 32, 64, 256, 32
SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)
FTOL = dict(rtol=1e-4, atol=1e-5)
# The reference's engine steps, jitted (one compile per config, not per op).
_STATIC = dict(static_argnums=(3,), static_argnames=("n_text", "heads"))
_j_update = jax.jit(JE.update_layer, **_STATIC)
_j_dispatch = jax.jit(JE.dispatch_layer, **_STATIC)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), cache_dtype=jnp.float32, **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), cache_dtype=torch.float32, **kw))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    s = DM ** -0.5
    w = {n: (rng.standard_normal(shape) * s).astype(np.float32) for n, shape in
         (("wq", (DM, H * DH)), ("wk", (DM, H * DH)), ("wv", (DM, H * DH)),
          ("wo", (H * DH, DM)))}
    w["q_scale"] = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    w["k_scale"] = (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
    return (JE.AttnParams(**{k: jnp.asarray(v) for k, v in w.items()}),
            TE.AttnParams(**{k: _t(v) for k, v in w.items()}))


def _x(seed):
    return np.random.default_rng(seed).standard_normal((B, N, DM)).astype(np.float32)


def _state_to_torch(st) -> TE.LayerState:
    plan = TP.DispatchPlan(**{f: _t(getattr(st.plan, f)) for f in TP.DispatchPlan._fields})
    return TE.LayerState(s_c=_t(st.s_c), s_s=_t(st.s_s),
                         taylor=TT.TaylorState(derivs=_t(st.taylor.derivs),
                                               n_updates=int(st.taylor.n_updates)),
                         k_since=int(st.k_since), plan=plan)


def _same_state(want, got):
    for f in ("s_c", "s_s"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in TP.DispatchPlan._fields:
        if getattr(want.plan, f) is None:        # a bucketed field of a uniform plan
            assert getattr(got.plan, f) is None, f
            continue
        w, g = np.asarray(getattr(want.plan, f)), getattr(got.plan, f).numpy()
        assert w.dtype == g.dtype, f
        if f == "row_score":     # the one float field: column mass of a softmax map
            np.testing.assert_allclose(g, w, **FTOL)
            continue
        assert int(np.sum(w != g)) == 0, f"plan.{f}: {int(np.sum(w != g))} entries differ"
    np.testing.assert_allclose(got.taylor.derivs.numpy(), np.asarray(want.taylor.derivs),
                               **FTOL)
    assert got.taylor.n_updates == int(want.taylor.n_updates)
    assert got.k_since == int(want.k_since)


@pytest.fixture(scope="module", params=["bias", "o_cache"])
def updated(request):
    """Two Update steps through both engines; returns everything the tests need."""
    mode = request.param
    jcfg, tcfg = _cfgs(cache_mode=mode)
    jp, tp = _params()
    jst = JE.init_layer_state(B, H, N, DM, DH, jcfg)
    tst = TE.init_layer_state(B, H, N, DM, DH, tcfg, "cpu")
    steps = []
    for seed in (1, 2):
        x = _x(seed)
        jout, jst = _j_update(jp, jnp.asarray(x), jst, jcfg, n_text=N_TEXT, heads=H)
        tout, tst = TE.update_layer(tp, _t(x), tst, tcfg, n_text=N_TEXT, heads=H)
        steps.append((np.asarray(jout), tout, jst, tst))
    return mode, jp, tp, steps


def test_update_layer_matches(updated):
    _, _, _, steps = updated
    for jout, tout, jst, tst in steps:
        np.testing.assert_allclose(tout.numpy(), jout, **FTOL)
        _same_state(jst, tst)
    live = np.asarray(steps[-1][2].plan.q_cnt)
    assert 0 < live.sum() < B * H * steps[-1][2].plan.q_ids.shape[-1]   # sparse, not empty


@pytest.mark.parametrize("backend,kw", [
    ("xla", {}),
    ("pallas", {}),
    ("xla", dict(use_gemm_q=False, use_gemm_o=False)),
])
def test_dispatch_layer_matches(updated, backend, kw):
    mode, jp, tp, steps = updated
    jcfg, tcfg = _cfgs(cache_mode=mode, **kw)
    jcfg = JE.EngineConfig(**{**jcfg.__dict__, "backend": backend})
    jst = steps[-1][2]
    tst = _state_to_torch(jst)
    for seed in (3, 4):                      # Dispatch offsets k_since = 1, 2
        x = _x(seed)
        jout, jst = _j_dispatch(jp, jnp.asarray(x), jst, jcfg, n_text=N_TEXT, heads=H)
        tout, tst = TE.dispatch_layer(tp, _t(x), tst, tcfg, n_text=N_TEXT, heads=H)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FTOL)
        assert tst.k_since == int(jst.k_since)
    assert tst.plan is not None and jax.tree.leaves(jst.plan)
