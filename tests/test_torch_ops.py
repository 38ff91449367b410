"""Port parity: the unified kernel entry ``repro_torch.kernels.ops`` (on CPU
tensors each kernel wrapper runs its plain version) against
``repro.kernels.ops`` (the Pallas kernels in interpret mode), and the
reference's oracles ``attention_ref`` / ``taylor_reuse_ref``.

Inputs are numpy draws from a seed handed to both.  The masks hold every
edge case the entries handle: an all-cached (b, h), a live row with no live
KV block, capacity truncation, padded row slots, an all-uncached Taylor
mask.  Tolerances are the reference's own sweep tolerances
(tests/test_kernels.py): f32 rtol = atol = 2e-5, bf16 3e-2; integer index
lists and layouts exact.  Last, the port's quickstart runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import bucket_geometry as j_bucket_geometry
from repro.core.plan import bucket_layout as j_bucket_layout
from repro.core.symbols import active_indices as j_active_indices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a, copy=True)).to(tdt)


def _close(got, want, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _same(name, want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape, (name, want.shape, got.shape)
    assert np.array_equal(want.astype(np.int64), got.astype(np.int64)), name


def _attn_inputs(seed, bh, n, d, bq, bk, p_c=0.6, p_s=0.6):
    """q, k, v, o_reuse and masks with an all-cached head (bh 1) and a live
    row with an empty KV list (head 0's first live row)."""
    rng = np.random.default_rng(seed)
    tq, tkv = n // bq, n // bk
    q, k, v, o = (rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(4))
    m_c = rng.random((bh, tq)) < p_c
    m_c[0, 0] = True
    m_c[1 % bh] = False
    m_s = rng.random((bh, tq, tkv)) < p_s
    m_s[0, 0] = False
    return q, k, v, o, m_c, m_s


ATTN_SWEEP = [
    # (BH, N, d, bq, bk, dtype)
    (2, 128, 32, 16, 16, "float32"),
    (3, 256, 64, 32, 16, "float32"),
    (3, 256, 128, 64, 64, "float32"),
    (2, 128, 64, 16, 32, "bfloat16"),
]


@pytest.mark.parametrize("variant", ["csr", "symbols"])
@pytest.mark.parametrize("bh,n,d,bq,bk,dtype", ATTN_SWEEP)
def test_flashomni_attention_matches_reference(variant, bh, n, d, bq, bk, dtype):
    q, k, v, o, m_c, m_s = _attn_inputs(bh * n + d, bh, n, d, bq, bk)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jo, to = _pair(o, dtype)
    kw = dict(block_q=bq, block_kv=bk, variant=variant)
    want = jops.flashomni_attention(jq, jk, jv, jnp.asarray(m_c), jnp.asarray(m_s), jo, **kw)
    got = tops.flashomni_attention(tq, tk, tv, torch.from_numpy(m_c), torch.from_numpy(m_s),
                                   to, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    assert torch.equal(got[1 % bh], to[1 % bh])                  # all-cached head
    assert not got[0, :bq].float().any()                         # empty live row: zeros
    # The symbols variant runs the CSR body on the same lists: same bits.
    other = "csr" if variant == "symbols" else "symbols"
    assert torch.equal(got, tops.flashomni_attention(
        tq, tk, tv, torch.from_numpy(m_c), torch.from_numpy(m_s), to, block_q=bq,
        block_kv=bk, variant=other))


@pytest.mark.parametrize("cap_q,cap_kv", [(None, None), (3, 5), (8, 2)])
def test_csr_layout_and_capacity_match_reference(cap_q, cap_kv):
    q, k, v, o, m_c, m_s = _attn_inputs(5, 3, 256, 32, 32, 32)
    jm_c, jm_s = jnp.asarray(m_c), jnp.asarray(m_s)
    tm_c, tm_s = torch.from_numpy(m_c), torch.from_numpy(m_s)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = tops.csr_layout(tm_c, tm_s, cap_q, cap_kv)
    jq_ids, jq_cnt = j_active_indices(jm_c, cap_q or m_c.shape[-1])
    rows = jnp.take_along_axis(jm_s, jq_ids[..., None], axis=-2)
    jkv_ids, jkv_cnt = j_active_indices(rows, cap_kv or m_s.shape[-1])
    for name, want, got in (("q_ids", jq_ids, q_ids), ("q_cnt", jq_cnt, q_cnt),
                            ("kv_ids", jkv_ids, kv_ids), ("kv_cnt", jkv_cnt, kv_cnt)):
        _same(name, want, got)
    kw = dict(block_q=32, block_kv=32, cap_q=cap_q, cap_kv=cap_kv)
    want = jops.flashomni_attention(*(jnp.asarray(a) for a in (q, k, v)), jm_c, jm_s,
                                    jnp.asarray(o), **kw)
    got = tops.flashomni_attention(*(torch.from_numpy(a) for a in (q, k, v)), tm_c, tm_s,
                                   torch.from_numpy(o), **kw)
    _close(got, want)


@pytest.mark.parametrize("variant", ["csr", "symbols"])
def test_attention_all_cached_and_all_live(variant):
    q, k, v, o, m_c, m_s = _attn_inputs(7, 2, 128, 32, 16, 16)
    m_s[..., 0] = True                                           # no empty row
    args = [torch.from_numpy(a) for a in (q, k, v)]
    for mc in (np.zeros_like(m_c), np.ones_like(m_c)):
        want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v, mc, m_s, o)),
                                  block_q=16, block_kv=16)
        got = tops.flashomni_attention(*args, torch.from_numpy(mc), torch.from_numpy(m_s),
                                       torch.from_numpy(o), block_q=16, block_kv=16,
                                       variant=variant)
        _close(got, want)


@pytest.mark.parametrize("kv_buckets,cap_kv", [(2, None), (3, None), (2, 5)])
def test_bucketed_attention_matches_reference(kv_buckets, cap_kv):
    heads, b, n, d, blk = 2, 2, 256, 32, 16
    q, k, v, o, m_c, m_s = _attn_inputs(40 + kv_buckets, b * heads, n, d, blk, blk)
    m_s[2] = True                                                # one dense head
    jm_c, jm_s = jnp.asarray(m_c), jnp.asarray(m_s)
    tm_c, tm_s = torch.from_numpy(m_c), torch.from_numpy(m_s)
    kw = dict(block_q=blk, block_kv=blk, kv_buckets=kv_buckets, heads=heads, cap_kv=cap_kv)
    want = jops.flashomni_attention(*(jnp.asarray(a) for a in (q, k, v)), jm_c, jm_s,
                                    jnp.asarray(o), **kw)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    got = tops.flashomni_attention(*targs, tm_c, tm_s, torch.from_numpy(o), **kw)
    _close(got, want)
    # The layout: every bkt_* field exact against the reference's, built as
    # the reference's entry builds it.
    t_q, t_kv = m_c.shape[-1], m_s.shape[-1]
    cap = t_kv if cap_kv is None else cap_kv
    bkt, geometry = tops.bucketed_layout(tm_c, tm_s, cap_kv=cap_kv, kv_buckets=kv_buckets,
                                         heads=heads)
    assert geometry == j_bucket_geometry(t_q, cap, heads, kv_buckets)
    jq_ids, jq_cnt = j_active_indices(jm_c, t_q)
    rows = jnp.take_along_axis(jm_s, jq_ids[..., None], axis=-2)
    jkv_ids, jkv_cnt = j_active_indices(rows, cap)
    shp = lambda a: a.reshape(b, heads, *a.shape[1:])
    jbkt, _ = j_bucket_layout(shp(jq_ids), shp(jq_cnt), shp(jq_ids), shp(jkv_ids),
                              shp(jkv_cnt), shp(jnp.sum(rows, -1).astype(jnp.float32)),
                              geometry, t_q)
    for f in ("bkt_head", "bkt_q_ids", "bkt_q_src", "bkt_kv_ids", "bkt_kv_cnt"):
        _same(f, jbkt[f], bkt[f])
    plain = tref.attention_csr_bucketed_ref(
        *targs, torch.from_numpy(o), bkt["bkt_head"], bkt["bkt_q_ids"], bkt["bkt_q_src"],
        bkt["bkt_kv_ids"], bkt["bkt_kv_cnt"], geometry, heads=heads, block_q=blk,
        block_kv=blk)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracles_match_reference(dtype):
    q, k, v, o, m_c, m_s = _attn_inputs(3, 3, 128, 32, 16, 32)
    pairs = [_pair(a, dtype) for a in (q, k, v)]
    jo, to = _pair(o, dtype)
    want = jref.attention_ref(*(p[0] for p in pairs), jnp.asarray(m_c), jnp.asarray(m_s), jo,
                              block_q=16, block_kv=32)
    got = tref.attention_ref(*(p[1] for p in pairs), torch.from_numpy(m_c),
                             torch.from_numpy(m_s), to, block_q=16, block_kv=32)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)                # the empty live row's uniform softmax too
    rng = np.random.default_rng(4)
    jd, td = _pair(rng.standard_normal((3, 2, 64, 16)).astype(np.float32), dtype)
    coef = rng.standard_normal(3).astype(np.float32)
    want = jref.taylor_reuse_ref(jd, jnp.asarray(coef))
    got = tref.taylor_reuse_ref(td, torch.from_numpy(coef))
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n,k,f,blk,cap,dtype", [
    (128, 64, 128, 16, None, "float32"),
    (256, 128, 256, 32, 3, "float32"),                # capacity truncates
    (128, 64, 128, 16, 6, "bfloat16"),                # padded slots
])
def test_gemm_q_matches_reference(n, k, f, blk, cap, dtype, compact):
    rng = np.random.default_rng(n + k)
    jx, tx = _pair(rng.standard_normal((n, k)).astype(np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((k, f)).astype(np.float32), dtype)
    rm = rng.random(n // blk) < 0.5
    rm[0] = True
    y, ids, cnt = jops.gemm_q(jx, jw, jnp.asarray(rm), block_rows=blk, cap=cap,
                              compact=compact)
    ty, tids, tcnt = tops.gemm_q(tx, tw, torch.from_numpy(rm), block_rows=blk, cap=cap,
                                 compact=compact)
    _same("row_ids", ids, tids)
    _same("row_cnt", cnt, tcnt)
    assert ty.shape == y.shape and ty.dtype == DTYPES[dtype][1]
    _close(ty, y, dtype)


@pytest.mark.parametrize("hc_buckets", [1, 2])
@pytest.mark.parametrize("h,n,dh,f,blk,cap_rows,cap_heads,dtype", [
    (4, 128, 32, 64, 16, None, None, "float32"),
    (8, 256, 64, 128, 32, 6, 5, "float32"),           # row and head capacities truncate
    (4, 128, 64, 64, 16, None, None, "bfloat16"),
])
def test_gemm_o_matches_reference(h, n, dh, f, blk, cap_rows, cap_heads, dtype, hc_buckets):
    rng = np.random.default_rng(h * n)
    jo, to = _pair(rng.standard_normal((h, n, dh)).astype(np.float32), dtype)
    jw, tw = _pair((rng.standard_normal((h, dh, f)) * (h * dh) ** -0.5).astype(np.float32),
                   dtype)
    jb, tb = _pair(rng.standard_normal((n, f)).astype(np.float32), dtype)
    m_ch = rng.random((n // blk, h)) < 0.6
    m_ch[1] = True                                    # a row with every head live
    m_ch[2] = False                                   # a row with none
    kw = dict(block_rows=blk, cap_rows=cap_rows, cap_heads=cap_heads, hc_buckets=hc_buckets)
    want = jops.gemm_o(jo, jw, jb, jnp.asarray(m_ch), **kw)
    got = tops.gemm_o(to, tw, tb, torch.from_numpy(m_ch), **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    assert torch.equal(got[2 * blk:3 * blk], tb[2 * blk:3 * blk])     # no live head: bias
    none = np.zeros_like(m_ch)                        # row_cnt == 0: bias
    assert torch.equal(tops.gemm_o(to, tw, tb, torch.from_numpy(none), **kw), tb)


@pytest.mark.parametrize("d1,bh,n,d,blk,cap,p,dtype", [
    (2, 2, 128, 32, 16, None, 0.5, "float32"),
    (4, 1, 64, 64, 16, 2, 0.5, "float32"),            # capacity truncates
    (3, 3, 64, 32, 32, None, 0.0, "float32"),         # nothing cached: base
    (2, 2, 128, 32, 16, None, 0.5, "bfloat16"),
])
def test_taylor_reuse_matches_reference(d1, bh, n, d, blk, cap, p, dtype):
    rng = np.random.default_rng(d1 * 10 + bh)
    jd, td = _pair(rng.standard_normal((d1, bh, n, d)).astype(np.float32), dtype)
    coef = rng.standard_normal(d1).astype(np.float32)
    jb, tb = _pair(rng.standard_normal((bh, n, d)).astype(np.float32), dtype)
    cmask = rng.random((bh, n // blk)) < p
    if p:
        cmask[0, :3] = True
    want = jops.taylor_reuse(jd, jnp.asarray(coef), jb, jnp.asarray(cmask), block=blk, cap=cap)
    got = tops.taylor_reuse(td, torch.from_numpy(coef), tb, torch.from_numpy(cmask),
                            block=blk, cap=cap)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    if not p:
        assert torch.equal(got, tb)


def test_scatter_rows_matches_reference():
    rng = np.random.default_rng(9)
    base = rng.standard_normal((64, 8)).astype(np.float32)
    compact = rng.standard_normal((3 * 16, 8)).astype(np.float32)
    ids = np.array([1, 3, 3], np.int32)
    want = jops.scatter_rows(jnp.asarray(compact), jnp.asarray(ids), jnp.int32(2),
                             jnp.asarray(base), 16)
    got = tops.scatter_rows(torch.from_numpy(compact), torch.from_numpy(ids),
                            torch.tensor(2, dtype=torch.int32), torch.from_numpy(base), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv", [
    ["--device", "cpu"],
    ["--device", "cpu", "--strategy", "cache-all", "--schedule", "step-ramp"],
])
def test_quickstart_runs_on_cpu(argv, capsys):
    from repro_torch import quickstart
    report = quickstart.main(argv)
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    ops = report["ops"]
    assert ops["symbols_equal_csr"]
    for key in ("symbols", "csr", "bucketed", "taylor_reuse", "gemm_q", "gemm_o",
                "gemm_o_bucketed"):
        assert ops[key]["max_abs_err"] <= 1e-4, (key, ops[key])
