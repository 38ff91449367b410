"""Port parity: the structural twin path (``TorchBackend`` and the functions
of ``core/attention`` and ``core/sparse_gemm`` it runs) against the JAX
reference's ``XlaBackend`` and its functions, on the same inputs.

  * the index helpers (block gathers, the masked scatter) exactly;
  * every float output within the reference's own tolerances: f32 2e-5 for
    attention and GEMM-Q, 1e-4 for GEMM-O (``tests/test_backend.py``);
  * plans built by the reference from seeded masks and handed across, in
    four layouts: the per-head union (``cap_kv == T_kv``), the per-row CSR
    lists (``cap_kv < T_kv``), a bucketed plan (``kv_buckets = 2``) and a
    row-capacity truncation that leaves padded row slots;
  * ``dispatch_layer`` under ``backend="torch"`` against the reference's
    under ``backend="xla"``, in both cache modes;
  * ``TorchBackend`` against ``KernelBackend`` (on the CPU: the kernels'
    plain versions) with the rows of live queries whose KV list is empty
    zeroed, since the twin follows its reference there (a uniform softmax)
    and the kernels write zeros (ROADMAP C.4);
  * ``get_backend`` routing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import plan as JP
from repro.core import sparse_gemm as JG
from repro.core.backend import XlaBackend
from repro_torch.core import attention as TA
from repro_torch.core import backend as TB
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core import sparse_gemm as TG
from repro_torch.core import taylorseer as TT

ATOL = dict(rtol=2e-5, atol=2e-5)        # attention, GEMM-Q
OTOL = dict(rtol=1e-4, atol=1e-4)        # GEMM-O
FTOL = dict(rtol=1e-4, atol=1e-5)        # a whole Dispatch step (test_torch_engine)
B, H, DH, DM, N = 2, 3, 32, 64, 256      # T = 16 kernel blocks, 8 pooled blocks
MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
            block_q=16, block_kv=16, pool=32, warmup_steps=2)
_j_build_plan = jax.jit(JP.build_dispatch_plan, static_argnums=(2, 3))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(**kw):
    return (JE.EngineConfig(mask=JM.MaskConfig(**MASK), cache_dtype=jnp.float32, **kw),
            TE.EngineConfig(mask=TM.MaskConfig(**MASK), cache_dtype=torch.float32, **kw))


def _masks(seed, empty_row=False):
    """Compressed masks (B, H, 8) / (B, H, 8, 8): ragged rows, a fully cached
    head, a row live in one head only, batch 1 with two live rows (padded
    row slots); with ``empty_row`` one live row keeps no KV block."""
    rng = np.random.default_rng(seed)
    t = N // MASK["pool"]
    m_c = rng.random((B, H, t)) < 0.6
    m_c[:, 0] = False
    m_c[:, 1, 0] = True
    m_c[1] = False
    m_c[1, 2, [1, 5]] = True
    m_s = rng.random((B, H, t, t)) < 0.5
    m_s[..., 0] = True
    if empty_row:
        m_c[0, 2, 3] = True
        m_s[0, 2, 3] = False
    return m_c, m_s


PLANS = {                      # layout -> EngineConfig overrides
    "union": dict(cap_q_frac=1.0, cap_kv_frac=1.0),
    "per_row": dict(cap_q_frac=1.0, cap_kv_frac=0.5),
    "bucketed": dict(cap_q_frac=1.0, cap_kv_frac=1.0, kv_buckets=2),
    "row_cap": dict(cap_q_frac=0.5, cap_kv_frac=0.75),
}


def _plan(layout, seed=0, empty_row=False):
    """The reference's plan for ``layout`` (and the port's on the same masks,
    which must equal it), both configs and the kernel-block spec."""
    jcfg, tcfg = _cfgs(**PLANS[layout])
    m_c, m_s = _masks(seed, empty_row)
    jplan = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s), jcfg, N)
    tplan = TP.build_dispatch_plan(_t(m_c), _t(m_s), tcfg, N)
    for f in TP.DispatchPlan._fields:
        want, got = getattr(jplan, f), getattr(tplan, f)
        if want is None:
            assert got is None, f
        elif f != "row_score":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f)
    spec = tcfg.caps(N)
    assert (spec.cap_kv < N // 16) == (layout in ("per_row", "row_cap"))
    return jcfg, tcfg, jplan, tplan, spec


# ---------------------------------------------------------------------------
# Index helpers, exactly
# ---------------------------------------------------------------------------

def test_block_gathers_and_masked_scatter_match_exactly():
    rng = np.random.default_rng(0)
    xb = _rand(rng, 2, 3, 8, 4, 5)
    ids = rng.integers(0, 8, (2, 3, 6)).astype(np.int32)
    row_ids = rng.integers(0, 8, (2, 3, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(TA._gather_blocks(_t(xb), _t(ids)).numpy(),
                                  np.asarray(JA._gather_blocks(xb, ids)))
    np.testing.assert_array_equal(TA._gather_row_blocks(_t(xb), _t(row_ids)).numpy(),
                                  np.asarray(JA._gather_row_blocks(xb, row_ids)))
    # Live ids distinct and ascending (active_indices); padding slots repeat
    # the last live id (0 when none), so they collide with a live block.
    cnt = rng.integers(0, 6, (2, 3)).astype(np.int32)
    sids = np.zeros((2, 3, 5), np.int32)
    for bi in range(2):
        for hi in range(3):
            live = np.sort(rng.permutation(8)[:cnt[bi, hi]])
            sids[bi, hi, :len(live)] = live
            sids[bi, hi, len(live):] = live[-1] if len(live) else 0
    vals = _rand(rng, 2, 3, 5, 4, 5)
    np.testing.assert_array_equal(
        TA.scatter_blocks(_t(xb), _t(sids), _t(cnt), _t(vals)).numpy(),
        np.asarray(JA.scatter_blocks(xb, sids, cnt, vals)))
    mask = rng.random((2, 3, 4)) < 0.5
    np.testing.assert_array_equal(
        TA._block_mask_to_tokens(_t(mask), 16, 8, 60, 30).numpy(),
        np.asarray(JA._block_mask_to_tokens(mask, 16, 8, 60, 30)))


# ---------------------------------------------------------------------------
# The structural functions against their reference counterparts
# ---------------------------------------------------------------------------

def test_masked_block_attention_matches():
    rng = np.random.default_rng(1)
    t, blk, d = 8, 16, 32
    q, k, v, o = (_rand(rng, B, H, t * blk, d) for _ in range(4))
    m_c = rng.random((B, H, t)) < 0.6
    m_s = rng.random((B, H, t, t)) < 0.5
    m_s[0, 0, 1] = False                     # a live row with no KV: uniform softmax
    m_c[0, 0, 1] = True
    got = TA.masked_block_attention(*map(_t, (q, k, v, m_c, m_s, o)), block_q=blk,
                                    block_kv=blk)
    want = JA.masked_block_attention(q, k, v, m_c, m_s, o, block_q=blk, block_kv=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("layout", list(PLANS))
@pytest.mark.parametrize("chunk,force", [(16, False), (2, False), (3, False), (4, True)])
def test_sparse_attention_from_plan_matches(layout, chunk, force):
    """Every layout, with chunks that divide ``cap_q`` (the reference maps
    over them), that do not (it runs one chunk; the port a short last one)
    and the forced per-row layout."""
    _, _, jplan, tplan, spec = _plan(layout)
    rng = np.random.default_rng(2)
    q, k, v, o = (_rand(rng, B, H, N, DH) for _ in range(4))
    names = ("q_ids", "q_cnt", "kv_ids", "kv_cnt", "pair_live")
    kw = dict(q_chunk_blocks=chunk, force_per_row=force)
    want = JA.sparse_attention_from_plan(
        q, k, v, o, *(getattr(jplan, f) for f in names), spec,
        kv_row_ids=jplan.kv_row_ids, kv_row_cnt=jplan.kv_row_cnt, **kw)
    got = TA.sparse_attention_from_plan(
        *map(_t, (q, k, v, o)), *(getattr(tplan.widen(), f) for f in names), spec,
        kv_row_ids=tplan.widen().kv_row_ids, kv_row_cnt=tplan.widen().kv_row_cnt, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("cap_kv,kv_buckets", [(8, 1), (5, 1), (8, 2)])
def test_sparse_attention_xla_matches(cap_kv, kv_buckets):
    rng = np.random.default_rng(3)
    t, blk = 8, 16
    q, k, v, o = (_rand(rng, B, H, t * blk, DH) for _ in range(4))
    m_c = rng.random((B, H, t)) < 0.6
    m_s = rng.random((B, H, t, t)) < 0.6
    m_s[..., 0] = True
    spec = TA.SparseAttentionSpec(blk, blk, 6, cap_kv, kv_buckets)
    want = JA.sparse_attention_xla(q, k, v, m_c, m_s, o, JA.SparseAttentionSpec(*spec),
                                   q_chunk_blocks=2)
    got = TA.sparse_attention_xla(*map(_t, (q, k, v, m_c, m_s, o)), spec, q_chunk_blocks=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("lead,with_len", [((B, H), False), ((), False), ((), True)])
def test_sparse_decode_attention_matches(lead, with_len):
    """``cache_len`` broadcasts as the reference's does, which holds for one
    unbatched cache."""
    rng = np.random.default_rng(4)
    q = _rand(rng, *lead, 3, DH)
    kc, vc = _rand(rng, *lead, 128, DH), _rand(rng, *lead, 128, DH)
    kv_ids = np.broadcast_to(np.sort(rng.permutation(8)[:5]), (*lead, 5)).astype(np.int32)
    kv_cnt = rng.integers(1, 6, lead).astype(np.int32)
    cache_len = np.asarray(70, np.int32) if with_len else None
    want = JA.sparse_decode_attention(q, kc, vc, kv_ids, kv_cnt, 16, cache_len=cache_len)
    got = TA.sparse_decode_attention(*map(_t, (q, kc, vc, kv_ids, kv_cnt)), 16,
                                     cache_len=_t(cache_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("compact,with_bias", [(False, False), (True, False), (False, True)])
def test_gemm_q_from_plan_and_sparse_match(compact, with_bias):
    _, _, jplan, tplan, _ = _plan("row_cap")
    rng = np.random.default_rng(5)
    x, w = _rand(rng, B, N, DM), _rand(rng, DM, H * DH)
    bias = _rand(rng, H * DH) if with_bias else None
    want = JG.gemm_q_from_plan(x, w, jplan.row_ids.astype(jnp.int32), jplan.row_cnt,
                               block=32, bias=bias, compact=compact)
    got = TG.gemm_q_from_plan(_t(x), _t(w), tplan.widen().row_ids, tplan.row_cnt, block=32,
                              bias=_t(bias), compact=compact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    m_rows = rng.random((B, N // 32)) < 0.5
    np.testing.assert_allclose(
        TG.gemm_q_sparse(_t(x), _t(w), _t(m_rows), block=32, cap=5).numpy(),
        np.asarray(JG.gemm_q_sparse(x, w, m_rows, block=32, cap=5)), **ATOL)


def test_gemm_o_from_plan_and_sparse_match():
    """Padded row slots (batch 1 keeps two live rows of Cr) never store."""
    _, _, jplan, tplan, _ = _plan("row_cap")
    assert int(tplan.row_cnt.min()) < tplan.row_ids.shape[-1]
    rng = np.random.default_rng(6)
    o, w, bias = _rand(rng, B, N, H, DH), _rand(rng, H, DH, DM), _rand(rng, B, N, DM)
    want = JG.gemm_o_from_plan(o, w, jplan.head_mask, jplan.row_ids.astype(jnp.int32),
                               jplan.row_cnt, bias, block=32)
    got = TG.gemm_o_from_plan(_t(o), _t(w), tplan.head_mask, tplan.widen().row_ids,
                              tplan.row_cnt, _t(bias), block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OTOL)
    m_ch = rng.random((B, N // 32, H)) < 0.4
    np.testing.assert_allclose(
        TG.gemm_o_sparse(_t(o), _t(w), _t(m_ch), _t(bias), block=32, cap=6).numpy(),
        np.asarray(JG.gemm_o_sparse(o, w, m_ch, bias, block=32, cap=6)), **OTOL)


# ---------------------------------------------------------------------------
# TorchBackend against XlaBackend, stage by stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(PLANS))
def test_torch_backend_matches_xla_backend(layout):
    jcfg, _, jplan, tplan, spec = _plan(layout)
    jb, tb = XlaBackend(), TB.TorchBackend()
    assert (tb.name, tb.compact_q) == ("torch", False)
    rng = np.random.default_rng(7)
    q, k, v, o = (_rand(rng, B, H, N, DH) for _ in range(4))
    cr = tplan.row_ids.shape[-1]
    qc = _rand(rng, B, H, cr * MASK["pool"], DH)        # a compact GEMM-Q layout
    for qq, compact in ((q, False), (qc, True)):
        want = jb.attention(qq, k, v, o, jplan, spec, compact_q=compact)
        got = tb.attention(*map(_t, (qq, k, v, o)), tplan, spec, compact_q=compact)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    x, wq = _rand(rng, B, N, DM), _rand(rng, DM, H * DH)
    np.testing.assert_allclose(tb.gemm_q(_t(x), _t(wq), tplan, block=32).numpy(),
                               np.asarray(jb.gemm_q(x, wq, jplan, block=32)), **ATOL)
    o_tok, wo, bias = _rand(rng, B, N, H, DH), _rand(rng, H, DH, DM), _rand(rng, B, N, DM)
    np.testing.assert_allclose(
        tb.gemm_o(_t(o_tok), _t(wo), tplan, _t(bias), block=32, spec=spec).numpy(),
        np.asarray(jb.gemm_o(o_tok, wo, jplan, bias, block=32, spec=spec)), **OTOL)


# ---------------------------------------------------------------------------
# A whole Dispatch step: backend="torch" against the reference's "xla"
# ---------------------------------------------------------------------------

_STATIC = dict(static_argnums=(3,), static_argnames=("n_text", "heads"))
_j_update = jax.jit(JE.update_layer, **_STATIC)
_j_dispatch = jax.jit(JE.dispatch_layer, **_STATIC)


def _state_to_torch(st) -> TE.LayerState:
    plan = TP.DispatchPlan(**{f: _t(getattr(st.plan, f)) for f in TP.DispatchPlan._fields})
    return TE.LayerState(s_c=_t(st.s_c), s_s=_t(st.s_s),
                         taylor=TT.TaylorState(derivs=_t(st.taylor.derivs),
                                               n_updates=int(st.taylor.n_updates)),
                         k_since=int(st.k_since), plan=plan)


@pytest.mark.parametrize("mode", ["bias", "o_cache"])
@pytest.mark.parametrize("cap_kv_frac,kv_buckets", [(0.9, 1), (1.0, 1), (1.0, 2)])
def test_dispatch_layer_torch_backend_matches_reference_xla(mode, cap_kv_frac, kv_buckets):
    kw = dict(cache_mode=mode, cap_kv_frac=cap_kv_frac, kv_buckets=kv_buckets)
    jcfg, tcfg = _cfgs(**kw)
    jcfg = JE.EngineConfig(**{**jcfg.__dict__, "backend": "xla"})
    tcfg = TE.EngineConfig(**{**tcfg.__dict__, "backend": "torch"})
    rng = np.random.default_rng(8)
    w = {n: _rand(rng, *s) * DM ** -0.5 for n, s in (
        ("wq", (DM, H * DH)), ("wk", (DM, H * DH)), ("wv", (DM, H * DH)),
        ("wo", (H * DH, DM)))}
    w["q_scale"] = w["k_scale"] = np.ones(DH, np.float32)
    jp = JE.AttnParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tp = TE.AttnParams(**{k: _t(v) for k, v in w.items()})
    jst = JE.init_layer_state(B, H, N, DM, DH, jcfg)
    for _ in range(2):
        _, jst = _j_update(jp, jnp.asarray(_rand(rng, B, N, DM)), jst, jcfg, n_text=32,
                           heads=H)
    tst = _state_to_torch(jst)
    assert 0 < int(tst.plan.q_cnt.sum()) < tst.plan.q_ids.numel()      # sparse, not empty
    for _ in range(2):
        x = _rand(rng, B, N, DM)
        jout, jst = _j_dispatch(jp, jnp.asarray(x), jst, jcfg, n_text=32, heads=H)
        tout, tst = TE.dispatch_layer(tp, _t(x), tst, tcfg, n_text=32, heads=H)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FTOL)
        assert tst.k_since == int(jst.k_since)


# ---------------------------------------------------------------------------
# The twin against the kernels' plain versions (CPU), empty rows zeroed
# ---------------------------------------------------------------------------

def _empty_rows(plan, n):
    """(B, H, N) bool: the rows of live q blocks whose KV list is empty."""
    p = plan.widen()
    live = torch.arange(p.q_ids.shape[-1]) < p.q_cnt[..., None]
    empty = live & (p.kv_row_cnt == 0)
    out = torch.zeros((*p.q_ids.shape[:2], n // 16 + 1), dtype=torch.bool)
    out.scatter_(-1, torch.where(empty, p.q_ids.long(), n // 16), True)
    return out[..., :-1].repeat_interleave(16, dim=-1)


@pytest.mark.parametrize("layout", ["union", "per_row", "bucketed"])
def test_torch_backend_matches_kernel_plain_versions(layout):
    _, tcfg, _, plan, spec = _plan(layout, empty_row=True)
    tb, kb = TB.TorchBackend(), TB.KernelBackend()
    rng = np.random.default_rng(9)
    q, k, v, o = (_t(_rand(rng, B, H, N, DH)) for _ in range(4))
    empty = _empty_rows(plan, N)
    assert empty.any()
    got, want = (be.attention(q, k, v, o, plan, spec) for be in (tb, kb))
    # The twin gives an empty row a uniform softmax, the kernels zeros (C.4).
    assert float(got[empty].abs().max()) > 0 and float(want[empty].abs().max()) == 0
    zero = lambda a: torch.where(empty[..., None], 0.0, a)
    np.testing.assert_allclose(zero(got).numpy(), zero(want).numpy(), **ATOL)
    # GEMM-Q: the twin's full rows at the kernel's compact slots.
    x, wq = _t(_rand(rng, B, N, DM)), _t(_rand(rng, DM, H * DH))
    full, compact = tb.gemm_q(x, wq, plan, block=32), kb.gemm_q(x, wq, plan, block=32)
    p = plan.widen()
    for bi in range(B):
        for slot in range(int(p.row_cnt[bi])):
            r = int(p.row_ids[bi, slot])
            np.testing.assert_allclose(compact[bi, slot * 32:(slot + 1) * 32].numpy(),
                                       full[bi, r * 32:(r + 1) * 32].numpy(), **ATOL)
    o_tok, wo, bias = (_t(_rand(rng, *s)) for s in ((B, N, H, DH), (H, DH, DM), (B, N, DM)))
    np.testing.assert_allclose(tb.gemm_o(o_tok, wo, plan, bias, block=32, spec=spec).numpy(),
                               kb.gemm_o(o_tok, wo, plan, bias, block=32, spec=spec).numpy(),
                               **OTOL)


def test_get_backend_routing():
    assert TB.available_backends() == ("torch", "kernels")
    assert isinstance(TB.get_backend(TE.EngineConfig()), TB.KernelBackend)     # default
    assert isinstance(TB.get_backend(TE.EngineConfig(backend="torch")), TB.TorchBackend)
    assert isinstance(TB.get_backend(TE.EngineConfig(backend="kernels")), TB.KernelBackend)
    for name in ("auto", "xla", "pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown engine backend"):
            TB.get_backend(TE.EngineConfig(backend=name))
