"""Port parity: the plain versions of GEMM-Q, CSR attention and GEMM-O
(what each repro_torch kernel wrapper runs on a CPU tensor) against the JAX
Pallas kernels in interpret mode and against ``repro.kernels.ref``, on
JAX-built DispatchPlans.

The plan is built so that every edge case of the kernels occurs: padded
row slots (GEMM-Q zeros, GEMM-O ``head_cnt == 0``), a (b, h) whose rows are
all cached (attention keeps ``o_reuse``), a live q row with an empty KV
list (``kv_cnt == 0`` writes zeros), and compact-Q reads through
``q_slots``.  Tolerances: f32 rtol = atol = 1e-5; bf16 atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import masks as JM
from repro.core.plan import build_dispatch_plan
from repro.kernels import ref as jref
from repro.kernels.flashomni_attention import flashomni_attention_csr as j_attn
from repro.kernels.gemm_o import gemm_o_sparse_kernel as j_gemm_o
from repro.kernels.gemm_q import gemm_q_sparse_kernel as j_gemm_q
from repro_torch import kernels as TK

B, H, N, DH, D, POOL, BLK = 2, 2, 256, 32, 64, 32, 16
T = N // POOL
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def plan():
    """A JAX plan (ids widened to int32) covering every kernel edge case."""
    cfg = JE.EngineConfig(mask=JM.MaskConfig(block_q=BLK, block_kv=BLK, pool=POOL))
    rng = np.random.default_rng(11)
    m_c = rng.random((B, H, T)) < 0.5
    m_c[0] = False
    m_c[0, 0, [0, 2, 5]] = True          # batch 0: 3 live rows of cap 6 -> padded slots
    m_c[1, 0] = True                     # batch 1: 8 live rows truncate to cap 6
    m_c[1, 1] = False                    # (b=1, h=1): every row cached
    m_s = rng.random((B, H, T, T)) < 0.6
    m_s[0, 0, 2] = False                 # a live row with no live KV block
    p = build_dispatch_plan(jnp.asarray(m_c), jnp.asarray(m_s), cfg, N).widen()
    p = {f: np.asarray(getattr(p, f)) for f in p._fields if getattr(p, f) is not None}
    cr = p["row_ids"].shape[-1]
    assert (p["row_cnt"] < cr).any() and (p["head_cnt"] == 0).any()
    assert (p["q_cnt"] == 0).any()
    live = np.arange(p["q_ids"].shape[-1]) < p["q_cnt"][..., None]
    assert ((p["kv_row_cnt"] == 0) & live).any()
    assert (p["q_slots"] != p["q_ids"]).any()           # compact reads differ
    return p


def _rand(seed, *shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _check(got, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_q_plain_matches_pallas_and_ref(plan, dtype):
    jx, tx = _pair(_rand(1, B, N, D), dtype)
    jw, tw = _pair(_rand(2, D, H * DH, std=D ** -0.5), dtype)
    launches = TK.gemm_q_sparse_kernel.launches
    got = TK.gemm_q_sparse_kernel(tx, tw, _t(plan["row_ids"]), _t(plan["row_cnt"]),
                                  block_rows=POOL)
    assert TK.gemm_q_sparse_kernel.launches == launches      # CPU: plain version
    pallas = j_gemm_q(jx, jw, jnp.asarray(plan["row_ids"]), block_rows=POOL,
                      row_cnt=jnp.asarray(plan["row_cnt"]), interpret=True)
    _check(got, pallas, dtype)
    for b in range(B):
        want = jref.gemm_q_ref(jx[b], jw, jnp.asarray(plan["row_ids"][b]),
                               jnp.asarray(plan["row_cnt"][b]), block=POOL)
        _check(got[b], want, dtype)


def _flat(a):
    return a.reshape(B * H, *a.shape[2:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_compact_q(plan, dtype):
    cr = plan["row_ids"].shape[-1]
    jq, tq = _pair(_rand(3, B * H, cr * POOL, DH), dtype)
    jk, tk = _pair(_rand(4, B * H, N, DH), dtype)
    jv, tv = _pair(_rand(5, B * H, N, DH), dtype)
    jo, to = _pair(_rand(6, B * H, N, DH), dtype)
    q_ids, q_slots, q_cnt = (_flat(plan[f]) for f in ("q_ids", "q_slots", "q_cnt"))
    kv_ids, kv_cnt = _flat(plan["kv_row_ids"]), _flat(plan["kv_row_cnt"])
    got = TK.flashomni_attention_csr(tq, tk, tv, to, _t(q_ids), _t(q_slots), _t(q_cnt),
                                     _t(kv_ids), _t(kv_cnt), block_q=BLK, block_kv=BLK)
    pallas = j_attn(jq, jk, jv, jo, jnp.asarray(q_ids), jnp.asarray(kv_ids),
                    jnp.asarray(kv_cnt), block_q=BLK, block_kv=BLK, interpret=True,
                    q_src_ids=jnp.asarray(q_slots))
    # The reference backend's all-cached guard (backend.py:155-159).
    pallas = jnp.where(jnp.asarray(q_cnt > 0)[:, None, None], pallas, jo)
    _check(got, pallas, dtype)
    np.testing.assert_array_equal(got[q_cnt == 0].to(torch.float32).numpy(),
                                  to[q_cnt == 0].to(torch.float32).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_ref_full_layout(plan, dtype):
    """Full-layout Q (q_src = q_ids) against the mask oracle ``attention_ref``."""
    jq, tq = _pair(_rand(7, B * H, N, DH), dtype)
    jk, tk = _pair(_rand(8, B * H, N, DH), dtype)
    jv, tv = _pair(_rand(9, B * H, N, DH), dtype)
    jo, to = _pair(_rand(10, B * H, N, DH), dtype)
    q_ids, q_cnt = _flat(plan["q_ids"]), _flat(plan["q_cnt"])
    kv_ids, kv_cnt = _flat(plan["kv_row_ids"]), _flat(plan["kv_row_cnt"])
    t_q = N // BLK
    m_c = np.zeros((B * H, t_q), bool)
    m_s = np.zeros((B * H, t_q, t_q), bool)
    for bh in range(B * H):
        for c in range(q_cnt[bh]):
            m_c[bh, q_ids[bh, c]] = True
            m_s[bh, q_ids[bh, c], kv_ids[bh, c, :kv_cnt[bh, c]]] = True
    got = TK.flashomni_attention_csr(tq, tk, tv, to, _t(q_ids), _t(q_ids), _t(q_cnt),
                                     _t(kv_ids), _t(kv_cnt), block_q=BLK, block_kv=BLK)
    want = jref.attention_ref(jq, jk, jv, jnp.asarray(m_c), jnp.asarray(m_s), jo,
                              block_q=BLK, block_kv=BLK)
    # attention_ref spreads an empty row's softmax uniformly; the kernels
    # (and the port) write zeros there (the l == 0 guard).
    empty = np.zeros((B * H, N), bool)
    for bh in range(B * H):
        for c in range(q_cnt[bh]):
            if kv_cnt[bh, c] == 0:
                empty[bh, q_ids[bh, c] * BLK:(q_ids[bh, c] + 1) * BLK] = True
    assert empty.any()
    want = jnp.where(jnp.asarray(empty)[..., None], 0, want)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_o_plain_matches_pallas_and_ref(plan, dtype):
    jo, to = _pair(_rand(12, B, H, N, DH), dtype)
    jw, tw = _pair(_rand(13, H, DH, D, std=(H * DH) ** -0.5), dtype)
    jb, tb = _pair(_rand(14, B, N, D), dtype)
    args = [plan[f] for f in ("row_ids", "head_ids", "head_cnt")]
    launches = TK.gemm_o_sparse_kernel.launches
    got = TK.gemm_o_sparse_kernel(to, tw, tb, *map(_t, args), block_rows=POOL)
    assert TK.gemm_o_sparse_kernel.launches == launches
    pallas = j_gemm_o(jo, jw, jb, *map(jnp.asarray, args), block_rows=POOL, interpret=True)
    _check(got, pallas, dtype)
    for b in range(B):
        want = jref.gemm_o_ref(jo[b], jw, jb[b], jnp.asarray(plan["row_ids"][b]),
                               jnp.asarray(plan["row_cnt"][b]),
                               jnp.asarray(plan["head_ids"][b]),
                               jnp.asarray(plan["head_cnt"][b]), block=POOL)
        _check(got[b], want, dtype)


def _heads_in(plan, lo: int, hi: int):
    """The plan's GEMM-O head lists cut to heads ``[lo, hi)`` and renumbered
    from ``lo`` (what one device's lists say of a head range)."""
    ids, cnt = plan["head_ids"], plan["head_cnt"]
    out_ids = np.zeros((*ids.shape[:-1], hi - lo), np.int32)
    out_cnt = np.zeros_like(cnt)
    for b, c in np.ndindex(cnt.shape):
        keep = [h - lo for h in ids[b, c, :cnt[b, c]] if lo <= h < hi]
        out_ids[b, c, :len(keep)] = keep
        out_cnt[b, c] = len(keep)
    return out_ids, out_cnt


def test_gemm_o_plain_over_a_head_range(plan):
    """B3's plain version over each head of the row (O and W that head's,
    the lists the whole plan's) against ``ref.gemm_o_ref`` on the sliced
    heads with the lists cut to them; the full range ``torch.equal`` to
    the call without one; the ranges' results, the bias on the first only,
    summed to the whole within f32 tolerance."""
    dtype = "float32"
    jo, to = _pair(_rand(12, B, H, N, DH), dtype)
    jw, tw = _pair(_rand(13, H, DH, D, std=(H * DH) ** -0.5), dtype)
    jb, tb = _pair(_rand(14, B, N, D), dtype)
    args = [_t(plan[f]) for f in ("row_ids", "head_ids", "head_cnt")]
    whole = TK.gemm_o_sparse_kernel(to, tw, tb, *args, block_rows=POOL)
    assert torch.equal(TK.gemm_o_sparse_kernel(to, tw, tb, *args, block_rows=POOL, h_lo=0),
                       whole)
    parts = []
    for lo in range(H):
        bias = tb if lo == 0 else torch.zeros_like(tb)
        got = TK.gemm_o_sparse_kernel(to[:, lo:lo + 1].contiguous(), tw[lo:lo + 1], bias,
                                      *args, block_rows=POOL, h_lo=lo)
        ids, cnt = _heads_in(plan, lo, lo + 1)
        for b in range(B):
            want = jref.gemm_o_ref(jo[b, lo:lo + 1], jw[lo:lo + 1], jnp.asarray(bias[b].numpy()),
                                   jnp.asarray(plan["row_ids"][b]),
                                   jnp.asarray(plan["row_cnt"][b]), jnp.asarray(ids[b]),
                                   jnp.asarray(cnt[b]), block=POOL)
            _check(got[b], want, dtype)
        parts.append(got)
    _check(sum(parts), whole.numpy(), dtype)
    with pytest.raises(ValueError, match="head range"):
        TK.gemm_o_sparse_kernel(to.to("meta"), tw.to("meta"), tb.to("meta"),
                                *(a.to("meta") for a in args), block_rows=POOL, h_lo=1)
