"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device; on a machine with an H100 and nvcc run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The sweep covers every built size: head_dim 32/64/128 and block sizes
16/32/64/128, in float32 (rtol = atol = 1e-4, the sum order differs from the
plain version's) and bfloat16 (2e-2), on random CSR lists with padded
slots, an all-cached (b, h) and empty KV rows.  The bucketed kernels (B4,
B5) run on bucketed plans whose buckets clamp, against their plain versions
and ``torch.equal`` to the uniform kernels fed the same clamped counts.  The
symbols attention (B6) runs on packed masks with empty rows, all-cached and
all-live rows, against its plain version and ``torch.equal`` to B2 on the
CSR lists of the same masks; the Taylor reuse (B7) over orders 1-3 and
widths 32-3072 against its plain version.
"""

import pytest
import torch

from repro_torch import kernels as TK
from repro_torch.core.engine import EngineConfig
from repro_torch.core.masks import MaskConfig
from repro_torch.core.plan import bucket_geometry, build_dispatch_plan
from repro_torch.core.symbols import active_indices, pack_bits
from repro_torch.kernels.ref import (attention_csr_bucketed_ref, attention_csr_ref,
                                     attention_symbols_ref, csr_layout, gemm_o_bucketed_ref,
                                     gemm_o_ref,
                                     gemm_q_ref, taylor_reuse_blocks_ref)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _close(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bq,bkv", [(16, 16), (32, 64), (64, 32), (128, 128), (16, 128)])
def test_attention_kernel_matches_plain(dev, dtype, d, bq, bkv):
    g = _gen(d * 1000 + bq * 10 + bkv)
    bh, n = 4, 512
    tq, tkv = n // bq, n // bkv
    m_c = torch.rand((bh, tq), generator=g) < 0.6
    m_c[1] = False                                        # all-cached (b, h)
    q_ids, q_cnt = active_indices(m_c, tq)
    m_s = torch.rand((bh, tq, tkv), generator=g) < 0.5
    m_s[0, q_ids[0, 0]] = False                           # a live row with no KV block
    rows = torch.gather(m_s, 1, q_ids.long()[..., None].expand(bh, tq, tkv))
    kv_ids, kv_cnt = active_indices(rows, tkv)
    q_src = torch.stack([torch.randperm(tq, generator=g) for _ in range(bh)]).int()
    q, k, v, o = (torch.randn((bh, n, d), generator=g).to(dtype) for _ in range(4))
    args = [t.to(dev) for t in (q, k, v, o, q_ids, q_src, q_cnt, kv_ids, kv_cnt)]
    launches = TK.flashomni_attention_csr.launches
    got = TK.flashomni_attention_csr(*args, block_q=bq, block_kv=bkv)
    assert TK.flashomni_attention_csr.launches == launches + 1
    _close(got, attention_csr_ref(*args, block_q=bq, block_kv=bkv), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [16, 32, 64, 128])
def test_gemm_q_kernel_matches_plain(dev, dtype, bm):
    g = _gen(bm)
    b, n, k, f = 2, 1024, 100, 200                        # ragged K and F tiles
    t = n // bm
    live = torch.rand((b, t), generator=g) < 0.5
    row_ids, row_cnt = active_indices(live, t - 1)        # padded slots
    x = torch.randn((b, n, k), generator=g).to(dtype)
    w = (torch.randn((k, f), generator=g) * k ** -0.5).to(dtype)
    args = [a.to(dev) for a in (x, w, row_ids, row_cnt)]
    got = TK.gemm_q_sparse_kernel(*args, block_rows=bm)
    _close(got, gemm_q_ref(*args, block=bm), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [16, 32, 64, 128])
def test_gemm_o_kernel_matches_plain(dev, dtype, bm):
    g = _gen(100 + bm)
    b, h, n, dh, f = 2, 4, 1024, 64, 200
    t = n // bm
    m_ch = torch.rand((b, t, h), generator=g) < 0.4
    row_ids, row_cnt = active_indices(m_ch.any(-1), t)
    hm = torch.gather(m_ch, 1, row_ids.long()[..., None].expand(b, t, h))
    hm &= (torch.arange(t) < row_cnt[:, None])[..., None]   # padded slots: no heads
    head_ids, head_cnt = active_indices(hm, h)
    o = torch.randn((b, h, n, dh), generator=g).to(dtype)
    w = (torch.randn((h, dh, f), generator=g) * (h * dh) ** -0.5).to(dtype)
    bias = torch.randn((b, n, f), generator=g).to(dtype)
    args = [a.to(dev) for a in (o, w, bias, row_ids, head_ids, head_cnt)]
    got = TK.gemm_o_sparse_kernel(*args, block_rows=bm)
    _close(got, gemm_o_ref(*args, block=bm), dtype)


def _bucketed_plan(seed, b, h, n, bq, bkv, pool, kv_buckets):
    """A bucketed plan with head skew (a diagonal head among near-full ones),
    an all-cached (b, h) and clamping buckets, ids widened to int32."""
    cfg = EngineConfig(mask=MaskConfig(block_q=bq, block_kv=bkv, pool=pool),
                       cap_q_frac=1.0, cap_kv_frac=1.0, kv_buckets=kv_buckets)
    g = _gen(seed)
    t = n // pool
    m_c = torch.rand((b, h, t), generator=g) < 0.7
    m_c[:, 0] = True
    m_c[-1, -1] = False
    m_s = torch.rand((b, h, t, t), generator=g) < 0.9
    m_s[:, 1] = torch.eye(t, dtype=torch.bool)
    return cfg.caps(n), build_dispatch_plan(m_c, m_s, cfg, n).widen()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bq,bkv,kb", [(16, 16, 2), (16, 16, 3), (32, 64, 3), (64, 32, 2),
                                       (128, 128, 2)])
def test_attention_bucketed_kernel_matches_plain_and_uniform(dev, dtype, d, bq, bkv, kb):
    b, h, n = 2, 4, 1024
    spec, plan = _bucketed_plan(d + bq + kb, b, h, n, bq, bkv, max(bq, bkv), kb)
    geo = bucket_geometry(spec.cap_q, spec.cap_kv, h, kb)
    g = _gen(d * 7 + bq)
    q, k, v, o = (torch.randn((b * h, n, d), generator=g).to(dtype).to(dev) for _ in range(4))
    bkt = [t.to(dev) for t in (plan.bkt_head, plan.bkt_q_ids, plan.bkt_q_src,
                               plan.bkt_kv_ids, plan.bkt_kv_cnt)]
    kw = dict(heads=h, block_q=bq, block_kv=bkv)
    launches = TK.flashomni_attention_csr_bucketed.launches
    got = TK.flashomni_attention_csr_bucketed(q, k, v, o, *bkt, geo, **kw)
    assert TK.flashomni_attention_csr_bucketed.launches == launches + 1
    _close(got, attention_csr_bucketed_ref(q, k, v, o, *bkt, geo, **kw), dtype)
    flat = lambda a: a.reshape(b * h, *a.shape[2:]).contiguous().to(dev)
    uni = TK.flashomni_attention_csr(q, k, v, o, flat(plan.q_ids), flat(plan.q_ids),
                                     flat(plan.q_cnt), flat(plan.kv_row_ids),
                                     flat(plan.kv_row_cnt), block_q=bq, block_kv=bkv)
    assert torch.equal(got, uni)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,kb", [(16, 2), (32, 3), (64, 2), (128, 3)])
def test_gemm_o_bucketed_kernel_matches_plain_and_uniform(dev, dtype, bm, kb):
    b, h, n, dh, f = 2, 6, 2048, 64, 200
    _, plan = _bucketed_plan(300 + bm, b, h, n, bm, bm, bm, kb)
    cr = plan.row_ids.shape[-1]
    geo = bucket_geometry(cr, h, 1, kb)
    g = _gen(bm + kb)
    o = torch.randn((b, h, n, dh), generator=g).to(dtype).to(dev)
    w = (torch.randn((h, dh, f), generator=g) * (h * dh) ** -0.5).to(dtype).to(dev)
    bias = torch.randn((b, n, f), generator=g).to(dtype).to(dev)
    gmo = [t.to(dev) for t in (plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids,
                               plan.gmo_head_cnt)]
    got = TK.gemm_o_sparse_bucketed_kernel(o, w, bias, *gmo, geo, block_rows=bm)
    _close(got, gemm_o_bucketed_ref(o, w, bias, *gmo, geo, block=bm), dtype)
    uni = TK.gemm_o_sparse_kernel(o, w, bias, plan.row_ids.to(dev), plan.head_ids.to(dev),
                                  plan.head_cnt.to(dev), block_rows=bm)
    assert torch.equal(got, uni)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("bq,bkv", [(16, 16), (32, 16), (16, 64), (64, 32), (64, 64)])
@pytest.mark.parametrize("masks", ["random", "all-cached", "all-live"])
def test_symbols_kernel_matches_plain_and_csr(dev, dtype, d, bq, bkv, masks):
    g = _gen(d * 100 + bq * 10 + bkv)
    bh, n, n_kv = 4, 512, 384                             # T_q * T_kv bits not byte-aligned
    tq, tkv = n // bq, n_kv // bkv
    m_c = torch.rand((bh, tq), generator=g) < 0.6
    m_c[1] = False                                        # an all-cached (b, h)
    m_c[0, :2] = True
    if masks != "random":
        m_c[:] = masks == "all-live"
    m_s = torch.rand((bh, tq, tkv), generator=g) < 0.5
    m_s[0, 0] = False                                     # a live row with no KV block
    q, o = (torch.randn((bh, n, d), generator=g).to(dtype).to(dev) for _ in range(2))
    k, v = (torch.randn((bh, n_kv, d), generator=g).to(dtype).to(dev) for _ in range(2))
    s_c = pack_bits(m_c).to(dev)
    s_s = pack_bits(m_s.reshape(bh, -1)).to(dev)
    kw = dict(block_q=bq, block_kv=bkv)
    launches = TK.flashomni_attention_symbols.launches
    got = TK.flashomni_attention_symbols(q, k, v, o, s_c, s_s, **kw)
    assert TK.flashomni_attention_symbols.launches == launches + 1
    _close(got, attention_symbols_ref(q, k, v, o, s_c, s_s, **kw), dtype)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s)
    lists = [t.to(dev) for t in (q_ids, q_ids, q_cnt, kv_ids, kv_cnt)]
    assert torch.equal(got, TK.flashomni_attention_csr(q, k, v, o, *lists, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("d,block", [(32, 16), (128, 16), (200, 32), (3072, 32)])
def test_taylor_reuse_kernel_matches_plain(dev, dtype, order, d, block):
    g = _gen(order * 1000 + d)
    bh, n = 3, 256
    t = n // block
    derivs = torch.randn((order + 1, bh, n, d), generator=g).to(dtype).to(dev)
    base = torch.randn((bh, n, d), generator=g).to(dtype).to(dev)
    coef = torch.randn((order + 1,), generator=g).to(dev)
    cached = torch.rand((bh, t), generator=g) < 0.5
    cached[1] = False                                     # nothing cached: base
    ids, cnt = active_indices(cached, t - 1)              # padded and truncated lists
    ids, cnt = ids.to(dev), cnt.to(dev)
    launches = TK.taylor_reuse_kernel.launches
    got = TK.taylor_reuse_kernel(derivs, coef, base, ids, cnt, block=block)
    assert TK.taylor_reuse_kernel.launches == launches + 1
    _close(got, taylor_reuse_blocks_ref(derivs, coef, base, ids, cnt, block=block), dtype)
    assert torch.equal(got[1], base[1])
    mixed = TK.taylor_reuse_kernel(derivs.float(), coef, base, ids, cnt, block=block)
    _close(mixed, taylor_reuse_blocks_ref(derivs.float(), coef, base, ids, cnt, block=block),
           dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn((2, 64, 32), device=dev)
    w = torch.randn((32, 32), device=dev)
    ids = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    cnt = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        TK.gemm_q_sparse_kernel(x.transpose(1, 2).contiguous().transpose(1, 2), w, ids, cnt,
                                block_rows=32)
    with pytest.raises(TypeError):
        TK.gemm_q_sparse_kernel(x.half(), w.half(), ids, cnt, block_rows=32)
    with pytest.raises(TypeError):
        TK.gemm_q_sparse_kernel(x, w, ids.long(), cnt, block_rows=32)
    with pytest.raises(ValueError, match="CUDA"):
        TK.gemm_q_sparse_kernel(x, w.cpu(), ids, cnt, block_rows=32)
