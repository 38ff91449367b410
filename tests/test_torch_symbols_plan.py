"""Port parity: sparse symbols, masks, the flashomni strategy and the
DispatchPlan (repro_torch vs the JAX reference on the same inputs).

Integer outputs and every plan field must match exactly; the float-
threshold masks must match with zero mismatches (the count is reported).
Inputs are made with numpy from a seed and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import plan as JP
from repro.core import strategy as JS
from repro.core import symbols as JSym
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core import strategy as TS
from repro_torch.core import symbols as TSym

SERVE_MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
                  block_q=16, block_kv=16, pool=32, warmup_steps=2)


# The reference's mask and plan builders, jitted: one compile per case
# instead of one per eager op keeps this file fast.
_j_build_plan = jax.jit(JP.build_dispatch_plan, static_argnums=(2, 3))
_j_empty_plan = jax.jit(JP.empty_plan_like, static_argnums=(0, 1, 2, 3))
_j_caching = jax.jit(JM.make_caching_mask, static_argnums=(2, 3))
_j_skip = jax.jit(JM.make_skip_mask, static_argnums=(2, 3), static_argnames=("static_window",))


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**SERVE_MASK), **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**SERVE_MASK), **kw))


def _same(name, want, got):
    if want is None or got is None:         # a bucketed field of a uniform plan
        assert want is None and got is None, f"{name}: {got} != reference {want}"
        return
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype, f"{name}: dtype {got.dtype} != reference {want.dtype}"
    assert want.shape == got.shape, f"{name}: shape {got.shape} != {want.shape}"
    bad = int(np.sum(want != got))
    assert bad == 0, f"{name}: {bad} of {want.size} entries differ"


def _masks(seed, b, h, t, p=0.6):
    """Random (B, H, T) / (B, H, T, T) masks with an all-False (b, h) row of
    m_c and an all-False KV row of m_s."""
    rng = np.random.default_rng(seed)
    m_c = rng.random((b, h, t)) < p
    m_s = rng.random((b, h, t, t)) < p
    m_c[0, -1] = False
    m_s[-1, 0, 1] = False
    m_c[-1, 0, 1] = True
    return m_c, m_s


@pytest.mark.parametrize("t", [5, 8, 13, 64])
def test_pack_unpack_bits_match(t):
    rng = np.random.default_rng(t)
    m = rng.random((3, 2, t)) < 0.5
    m[0, 0] = False
    want = JSym.pack_bits(jnp.asarray(m))
    got = TSym.pack_bits(torch.from_numpy(m))
    _same("pack_bits", want, got)
    _same("unpack_bits", JSym.unpack_bits(want, t), TSym.unpack_bits(got, t))
    assert TSym.packed_len(t) == JSym.packed_len(t)


@pytest.mark.parametrize("t_q,t_kv", [(5, 7), (8, 8), (13, 3)])
def test_decode_spatial_and_reduction_match(t_q, t_kv):
    """The paper's decoders F(S_c, i) and J(S_s, i, j), big-endian, on the
    row-major (T_q x T_kv) matrix with no per-row byte padding: exact."""
    rng = np.random.default_rng(t_q * t_kv)
    m_c = rng.random((2, 3, t_q)) < 0.5
    m_s = rng.random((2, 3, t_q, t_kv)) < 0.5
    js_c, ts_c = JSym.pack_bits(jnp.asarray(m_c)), TSym.pack_bits(torch.from_numpy(m_c))
    flat = m_s.reshape(2, 3, -1)
    js_s, ts_s = JSym.pack_bits(jnp.asarray(flat)), TSym.pack_bits(torch.from_numpy(flat))
    for i in range(t_q):
        got = TSym.decode_spatial(ts_c, i)
        _same(f"F(S_c, {i})", JSym.decode_spatial(js_c, i), got)
        assert np.array_equal(got.numpy(), m_c[..., i])
        for j in range(t_kv):
            got = TSym.decode_reduction(ts_s, i, j, t_kv)
            _same(f"J(S_s, {i}, {j})", JSym.decode_reduction(js_s, i, j, t_kv), got)
            assert np.array_equal(got.numpy(), m_s[..., i, j])
    idx = np.arange(t_q, dtype=np.int32)[::-1].copy()
    _same("F(S_c, ids)", JSym.decode_spatial(js_c, jnp.asarray(idx)),
          TSym.decode_spatial(ts_c, torch.from_numpy(idx)))


@pytest.mark.parametrize("cap", [1, 3, 7, 12])
def test_active_indices_and_slot_positions_match(cap):
    rng = np.random.default_rng(cap)
    m = rng.random((2, 3, 12)) < 0.4
    m[0, 0] = False                     # all-False row: ids pad with 0
    m[1, 2] = True                      # count > cap when cap < 12
    ids_j, cnt_j = JSym.active_indices(jnp.asarray(m), cap)
    ids_t, cnt_t = TSym.active_indices(torch.from_numpy(m), cap)
    _same("active_indices ids", ids_j, ids_t)
    _same("active_indices count", cnt_j, cnt_t)
    _same("slot_positions", JSym.slot_positions(ids_j, cnt_j, 12),
          TSym.slot_positions(ids_t, cnt_t, 12))
    for frac in (0.1, 0.5, 0.75, 1.0):
        for quantum in (1, 8):
            assert TSym.capacity_for(12, frac, quantum) == JSym.capacity_for(12, frac, quantum)


@pytest.mark.parametrize("cap", [1, 4, 9, 16])
def test_clamp_mask_topk_ties_lower_index_wins(cap):
    rng = np.random.default_rng(100 + cap)
    m = rng.random((4, 16)) < 0.7
    m[0] = False
    score = rng.integers(0, 3, (4, 16)).astype(np.float32)   # many ties
    score[1] = 1.0                                           # all tied
    want = JSym.clamp_mask_topk(jnp.asarray(m), jnp.asarray(score), cap)
    got = TSym.clamp_mask_topk(torch.from_numpy(m), torch.from_numpy(score), cap)
    _same("clamp_mask_topk", want, got)


def _qk(seed, b=2, h=2, n=128, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k


@pytest.mark.parametrize("seed,n,n_text", [(0, 128, 32), (1, 256, 32), (2, 256, 0)])
def test_masks_match(seed, n, n_text):
    q, k = _qk(seed, n=n)
    jq, jk, tq, tk = jnp.asarray(q), jnp.asarray(k), torch.from_numpy(q), torch.from_numpy(k)
    mcfg_j, mcfg_t = JM.MaskConfig(**SERVE_MASK), TM.MaskConfig(**SERVE_MASK)
    np.testing.assert_allclose(
        TM.compressed_attention_map(tq, tk, 32).numpy(),
        np.asarray(JM.compressed_attention_map(jq, jk, 32)), rtol=1e-5, atol=1e-6)
    _same("make_caching_mask", _j_caching(jq, jk, mcfg_j, n_text),
          TM.make_caching_mask(tq, tk, mcfg_t, n_text))
    _same("make_skip_mask", _j_skip(jq, jk, mcfg_j, n_text),
          TM.make_skip_mask(tq, tk, mcfg_t, n_text))
    _same("make_skip_mask(window)",
          _j_skip(jq, jk, mcfg_j, n_text, static_window=2),
          TM.make_skip_mask(tq, tk, mcfg_t, n_text, static_window=2))
    m_c = np.random.default_rng(seed).random((2, 2, 8)) < 0.2
    _same("apply_degradation", JM.apply_degradation(jnp.asarray(m_c), 0.3),
          TM.apply_degradation(torch.from_numpy(m_c), 0.3))
    _same("expand_block_mask", JM.expand_block_mask(jnp.asarray(m_c), 2, 15),
          TM.expand_block_mask(torch.from_numpy(m_c), 2, 15))


@pytest.mark.parametrize("seed,n,kw", [
    (3, 128, {}),
    (4, 256, dict(cap_q_frac=0.5, cap_kv_frac=0.5)),      # truncating caps
])
def test_flashomni_strategy_matches(seed, n, kw):
    q, k = _qk(seed, n=n)
    jcfg, tcfg = _cfgs(**kw)
    jctx = JS.StrategyContext(cfg=jcfg, n_text=32, n_tokens=n)
    want = jax.jit(lambda q, k: JS.get_strategy("flashomni").emit(q, k, jctx))(
        jnp.asarray(q), jnp.asarray(k))
    got = TS.get_strategy("flashomni").emit(
        torch.from_numpy(q), torch.from_numpy(k),
        TS.StrategyContext(cfg=tcfg, n_text=32, n_tokens=n))
    for f in ("s_c", "s_s", "m_c", "m_s"):
        _same(f, getattr(want, f), getattr(got, f))
    np.testing.assert_allclose(got.q_scores.numpy(), np.asarray(want.q_scores),
                               rtol=1e-5, atol=1e-6)
    assert isinstance(TS.get_strategy("cache-all"), TS.CacheAllStrategy)


@pytest.mark.parametrize("seed,n,kw,score", [
    (5, 128, {}, "ties"),
    (6, 256, {}, None),
    (7, 256, dict(cap_q_frac=0.5, cap_kv_frac=0.4), "ties"),   # cap < count
    (8, 512, dict(cap_q_frac=0.6, cap_kv_frac=0.7), "random"),
])
def test_build_dispatch_plan_every_field_exact(seed, n, kw, score):
    jcfg, tcfg = _cfgs(**kw)
    t = jcfg.mask.n_blocks(n)
    m_c, m_s = _masks(seed, 2, 3, t)
    rng = np.random.default_rng(seed)
    rs = None
    if score == "ties":
        rs = rng.integers(0, 3, (2, t)).astype(np.float32)
    elif score == "random":
        rs = rng.random((2, t)).astype(np.float32)
    want = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s), jcfg, n,
                         row_score=None if rs is None else jnp.asarray(rs))
    got = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, n,
                                 row_score=None if rs is None else torch.from_numpy(rs))
    for f in TP.DispatchPlan._fields:
        _same(f, getattr(want, f), getattr(got, f))
    wide = got.widen()
    for f in ("q_ids", "q_slots", "kv_ids", "kv_row_ids", "row_ids", "head_ids"):
        assert getattr(wide, f).dtype == torch.int32 and getattr(wide, f).is_contiguous()
        _same(f"widen {f}", getattr(want.widen(), f), getattr(wide, f))


def test_empty_plan_and_bucketed_refusal():
    jcfg, tcfg = _cfgs()
    want = _j_empty_plan(2, 3, 128, jcfg)
    got = TP.empty_plan_like(2, 3, 128, tcfg, "cpu")
    for f in TP.DispatchPlan._fields:
        _same(f, getattr(want, f), getattr(got, f))
    with pytest.raises(ValueError, match="kv_buckets"):
        TE.EngineConfig(kv_buckets=4)
