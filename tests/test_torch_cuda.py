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
widths 32-3072 against its plain version.  The grouped walk of the
attention kernels (8 warps of one (b, h) sharing each staged KV block) runs
on lists that stress it: live counts that leave the last group part idle,
an empty row among live ones, disjoint and identical lists within a group,
full lists; B4 and B6 ``torch.equal`` to B2 on each, and B2 unchanged bit
for bit when its live slots are permuted into other groups.  The walk
counters (``count_walk``) read one staged KV block per block of a group's
union and one update per listed block of each 16-row warp; the attention
wrappers refuse a view whose data does not start on a 16-byte boundary.
The sparse-GEMM tile (B1, B3, B5) runs at the served width (K = F = 3072,
24 heads x 128) against the plain f32 version at 1e-4, on padding tiles
that must store zeros, on groups of GEMM-O slots whose head lists are
disjoint, identical or dead (dead rows keep the bias bit for bit; permuted
slots and B5 give the same bits), on rows of 200 bytes and on misaligned
views, which stage element by element and give the 16-byte path's bits.
B2 also runs at hunyuan-video-dit's width (33 024 tokens, T_kv = 2064, with
a full and an empty KV list), and the chunked dense attention of the Update
step runs on the card against the CPU at widths that span several chunks.
The continuous batcher serves a mixed-step queue at smoke size on the card
(grouped and scan ticks, lane refills) against the same run on the CPU.
Update and Dispatch with RoPE (``freqs=``) run the kernels on rotated
inputs against the twin (B1-B3, B1/B4/B5, and B1/B2 in ``o_cache`` mode).
The invariant analyzer runs green with the engine on the card, its
Dispatch records hold the kernels that launched, and the plan validator
reads a plan on the card as it reads its copy on the CPU.  The dense
attention's grad branch (training) gives the gradients of the unchunked
attention on the card, and one training step of flux-mmdit at full width and
2 blocks runs with no kernel launched.  The LM smoke configs (gemma3-1b,
granite-moe-3b-a800m, mamba2-370m, recurrentgemma-2b, whisper-large-v3 and
llama-3.2-vision-11b) run on the card against the CPU, and one MoE layer
at granite-moe's full width routes as on the CPU.  Each of the seven
wrappers launches its kernel on CUDA tensors (its count +1) and never on
``meta`` tensors (the dry run's shapes-only route).
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import kernels as TK
from repro_torch.core.engine import EngineConfig
from repro_torch.core.masks import MaskConfig
from repro_torch.core.plan import bucket_geometry, build_dispatch_plan
from repro_torch.core.symbols import active_indices, pack_bits
from repro_torch.kernels.flashomni_attention import count_walk
from repro_torch.kernels.ref import (attention_csr_bucketed_ref, attention_csr_ref,
                                     attention_symbols_ref, csr_layout, gemm_o_bucketed_ref,
                                     gemm_o_ref,
                                     gemm_q_ref, taylor_reuse_blocks_ref)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _kernel_cases import KERNEL_NAMES, kernel_call, on  # noqa: E402

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


def _group_masks(case, bh, tq, tkv, group, g):
    """Block masks (m_c (BH, T_q), m_s (BH, T_q, T_kv)) that stress the
    grouped walk, in which a block of ``group`` consecutive q slots (or q
    blocks) of one (b, h) stages the union of their KV lists."""
    m_c = torch.ones((bh, tq), dtype=torch.bool)
    m_s = torch.rand((bh, tq, tkv), generator=g) < 0.5
    if case == "ragged":                  # live counts that are no multiple of the group
        m_c[:] = False
        for i, live in enumerate((2 * group + 3, group - 1, tq, tq // 2 + 1)):
            m_c[i, torch.randperm(tq, generator=g)[:min(live, tq)]] = True
    elif case == "empty-row":             # one live row with no KV block among live rows
        m_s[:, 1] = False
        m_s[:, group + 2] = False
    elif case == "disjoint":              # the rows of a group share no KV block
        j = torch.arange(tkv)
        m_s = (j[None, :] % group == torch.arange(tq)[:, None] % group).expand(bh, tq, tkv)
        m_s = m_s.clone()
    elif case == "identical":             # the rows of a group share one list
        m_s = m_s[:, ::group].repeat_interleave(group, dim=1)[:, :tq].clone()
    elif case == "full":                  # every row lists every KV block
        m_c = torch.rand((bh, tq), generator=g) < 0.7
        m_s[:] = True
    m_c[-1, 0] = True
    return m_c, m_s


def _as_layout(q_ids, q_src, q_cnt, kv_ids, kv_cnt, heads, n_blocks, g):
    """The uniform CSR lists as a one-bucket layout for B4, its rows in a
    random order: (bkt_head, bkt_q_ids, bkt_q_src, bkt_kv_ids, bkt_kv_cnt)
    and the geometry."""
    bh, cq = q_ids.shape
    ckv, b, r = kv_ids.shape[-1], bh // heads, heads * cq
    live = torch.arange(cq) < q_cnt[:, None]
    head = torch.arange(heads).repeat_interleave(cq).expand(b, r)
    q_write = torch.where(live, q_ids, n_blocks).reshape(b, r)
    cnt = torch.where(live, kv_cnt, 0).reshape(b, r)
    perm = torch.randperm(r, generator=g)
    rows = [t[:, perm] for t in (head, q_write, q_src.reshape(b, r), cnt)]
    ids = kv_ids.reshape(b, r, ckv)[:, perm].reshape(b, r * ckv)
    return [t.int().contiguous() for t in (*rows[:3], ids, rows[3])], ((r, ckv),)


GROUP_CASES = ["ragged", "empty-row", "disjoint", "identical", "full"]
GROUP_SHAPES = [(128, 16, 16), (64, 32, 64), (32, 64, 32), (128, 128, 128), (128, 16, 128)]


def _group_inputs(case, dtype, d, bq, bkv, dev):
    g = _gen(GROUP_CASES.index(case) * 1000 + d + bq + bkv)
    heads, b, n = 2, 2, 1024
    bh, tq, tkv = b * heads, n // bq, n // bkv
    m_c, m_s = _group_masks(case, bh, tq, tkv, 128 // bq, g)
    q, k, v, o = (torch.randn((bh, n, d), generator=g).to(dtype).to(dev) for _ in range(4))
    return g, heads, n, m_c, m_s, (q, k, v, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bq,bkv", GROUP_SHAPES)
@pytest.mark.parametrize("case", GROUP_CASES)
def test_grouped_walk_b2_b4_b6_agree(dev, dtype, d, bq, bkv, case):
    """B2 against its plain version on lists that stress the grouped walk;
    B4 (the same lists as a shuffled one-bucket layout) and B6 (the packed
    masks) ``torch.equal`` to B2."""
    g, heads, n, m_c, m_s, (q, k, v, o) = _group_inputs(case, dtype, d, bq, bkv, dev)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s)
    lists = [t.to(dev) for t in (q_ids, q_ids, q_cnt, kv_ids, kv_cnt)]
    kw = dict(block_q=bq, block_kv=bkv)
    uni = TK.flashomni_attention_csr(q, k, v, o, *lists, **kw)
    _close(uni, attention_csr_ref(q, k, v, o, *lists, **kw), dtype)
    empty = m_c & ~m_s.any(-1)            # live rows with no KV block write zeros
    rows = empty.repeat_interleave(bq, dim=1).to(dev)
    assert not uni[rows].any()
    assert torch.equal(uni[~m_c.repeat_interleave(bq, dim=1).to(dev)],
                       o[~m_c.repeat_interleave(bq, dim=1).to(dev)])
    bkt, geo = _as_layout(q_ids, q_ids, q_cnt, kv_ids, kv_cnt, heads, n // bq, g)
    got = TK.flashomni_attention_csr_bucketed(q, k, v, o, *[t.to(dev) for t in bkt], geo,
                                              heads=heads, **kw)
    assert torch.equal(got, uni)
    bh = q.shape[0]
    sym = TK.flashomni_attention_symbols(q, k, v, o, pack_bits(m_c).to(dev),
                                         pack_bits(m_s.reshape(bh, -1)).to(dev), **kw)
    assert torch.equal(sym, uni)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bq,bkv", GROUP_SHAPES)
@pytest.mark.parametrize("case", GROUP_CASES)
def test_regrouped_slots_give_the_same_bits(dev, dtype, d, bq, bkv, case):
    """Permuting the live slots of each (b, h) (and the compact Q blocks
    they read) puts the same rows in other groups of B2's walk: the output
    does not change by one bit."""
    g, _, _, m_c, m_s, (q, k, v, o) = _group_inputs(case, dtype, d, bq, bkv, dev)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s)
    bh, cq = q_ids.shape
    # A compact Q layout: slot c reads block q_src[c] of a shuffled copy.
    src = torch.stack([torch.randperm(cq, generator=g) for _ in range(bh)]).int()
    qc = torch.empty_like(q).reshape(bh, cq, bq, d)
    qc[torch.arange(bh)[:, None], src.long()] = q.reshape(bh, cq, bq, d)[
        torch.arange(bh)[:, None], q_ids.long()]
    qc = qc.reshape(q.shape)
    kw = dict(block_q=bq, block_kv=bkv)
    base = TK.flashomni_attention_csr(
        qc, k, v, o, *[t.to(dev) for t in (q_ids, src, q_cnt, kv_ids, kv_cnt)], **kw)
    perm = torch.stack([torch.cat([torch.randperm(int(c), generator=g),
                                   torch.arange(int(c), cq)]) for c in q_cnt])
    take = lambda t: torch.gather(t, 1, perm if t.dim() == 2 else
                                  perm[..., None].expand_as(t)).contiguous()
    moved = TK.flashomni_attention_csr(
        qc, k, v, o, *[t.to(dev) for t in (take(q_ids), take(src), q_cnt, take(kv_ids),
                                           take(kv_cnt))], **kw)
    assert torch.equal(moved, base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bq,bkv", GROUP_SHAPES)
@pytest.mark.parametrize("case", GROUP_CASES)
def test_walk_counters_count_the_grouped_walk(dev, dtype, d, bq, bkv, case):
    """Inside ``count_walk`` B2 and B6 stage one KV block per block of the
    union of each group of 128 / BQ consecutive live q blocks, B4 one per
    listed block of each layout row, and all three make one update per
    listed block of each 16-row warp; the counted launch gives the same bits."""
    g, heads, n, m_c, m_s, (q, k, v, o) = _group_inputs(case, dtype, d, bq, bkv, dev)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s)
    lists = [t.to(dev) for t in (q_ids, q_ids, q_cnt, kv_ids, kv_cnt)]
    kw = dict(block_q=bq, block_kv=bkv)
    live = m_s & m_c[..., None]
    group = 128 // bq
    staged = sum(int(rows[s:s + group].any(0).sum())
                 for rows in (live[i][m_c[i]] for i in range(live.shape[0]))
                 for s in range(0, rows.shape[0], group))
    pairs = int(live.sum())
    updates = pairs * bq // 16
    uni = TK.flashomni_attention_csr(q, k, v, o, *lists, **kw)
    with count_walk(dev) as counts:
        got = TK.flashomni_attention_csr(q, k, v, o, *lists, **kw)
        assert counts.tolist() == [staged, updates]
    assert torch.equal(got, uni)
    bkt, geo = _as_layout(q_ids, q_ids, q_cnt, kv_ids, kv_cnt, heads, n // bq, g)
    with count_walk(dev) as counts:
        got = TK.flashomni_attention_csr_bucketed(q, k, v, o, *[t.to(dev) for t in bkt], geo,
                                                  heads=heads, **kw)
        assert counts.tolist() == [pairs, updates]
    assert torch.equal(got, uni)
    bh = q.shape[0]
    with count_walk(dev) as counts:
        got = TK.flashomni_attention_symbols(q, k, v, o, pack_bits(m_c).to(dev),
                                             pack_bits(m_s.reshape(bh, -1)).to(dev), **kw)
        assert counts.tolist() == [staged, updates]
    assert torch.equal(got, uni)
    TK.flashomni_attention_csr(q, k, v, o, *lists, **kw)
    assert counts.tolist() == [staged, updates]          # nothing counted outside


@pytest.mark.parametrize("arg", ["q", "k", "v", "o_reuse"])
def test_attention_wrappers_refuse_a_misaligned_view(dev, arg):
    bh, n, d = 2, 64, 32
    m_c = torch.ones((bh, 4), dtype=torch.bool)
    m_s = torch.ones((bh, 4, 4), dtype=torch.bool)
    q_ids, q_cnt, kv_ids, kv_cnt, _ = csr_layout(m_c, m_s)
    lists = [t.to(dev) for t in (q_ids, q_ids, q_cnt, kv_ids, kv_cnt)]
    t = {name: torch.randn((bh, n, d), device=dev) for name in ("q", "k", "v", "o_reuse")}
    t[arg] = torch.randn(bh * n * d + 1, device=dev)[1:].view(bh, n, d)    # 4 bytes off
    assert t[arg].is_contiguous()
    args = (t["q"], t["k"], t["v"], t["o_reuse"])
    kw = dict(block_q=16, block_kv=16)
    bkt, geo = _as_layout(q_ids, q_ids, q_cnt, kv_ids, kv_cnt, 1, 4, _gen(0))
    calls = [
        lambda: TK.flashomni_attention_csr(*args, *lists, **kw),
        lambda: TK.flashomni_attention_csr_bucketed(*args, *[x.to(dev) for x in bkt], geo,
                                                    heads=1, **kw),
        lambda: TK.flashomni_attention_symbols(*args, pack_bits(m_c).to(dev),
                                               pack_bits(m_s.reshape(bh, -1)).to(dev), **kw)]
    for call in calls:
        with pytest.raises(ValueError, match=f"{arg}: .*16-byte boundary"):
            call()


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


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_launches_on_the_card_and_never_on_meta(dev, name):
    fn, args, kw = kernel_call(name)
    launches = fn.launches
    got = fn(*on(dev, args), **kw)
    assert got.is_cuda and fn.launches == launches + 1
    shape = fn(*on("meta", args), **kw)
    assert shape.is_meta and (shape.shape, shape.dtype) == (got.shape, got.dtype)
    assert fn.launches == launches + 1


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


def _nan_filled_cache(dev, nbytes=64 << 20):
    """Leave NaN in the allocator's free blocks, so that an output the
    kernel fails to write shows."""
    torch.full((nbytes // 4,), float("nan"), device=dev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_q_serving_width_sum(dev, dtype):
    """K = F = 3072 (the served d_model): the 3xTF32 sum stays within 1e-4
    of the plain f32 product (plain TF32 would not)."""
    g = _gen(3072)
    b, n, k, bm = 2, 1024, 3072, 32
    t = n // bm
    live = torch.zeros((b, t), dtype=torch.bool)
    live[0, torch.randperm(t, generator=g)[:5]] = True
    live[1, torch.randperm(t, generator=g)[:9]] = True
    row_ids, row_cnt = active_indices(live, t)
    x = torch.randn((b, n, k), generator=g).to(dtype)
    w = (torch.randn((k, k), generator=g) * k ** -0.5).to(dtype)
    args = [a.to(dev) for a in (x, w, row_ids, row_cnt)]
    _close(TK.gemm_q_sparse_kernel(*args, block_rows=bm), gemm_q_ref(*args, block=bm), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_o_serving_width_sum(dev, dtype):
    """24 heads x 128 into F = 3072: the 3xTF32 sum over up to 3072 products
    a row stays within 1e-4 of the plain f32 version."""
    g = _gen(24128)
    b, h, n, dh, f, bm = 2, 24, 512, 128, 3072, 32
    t = n // bm
    m_ch = torch.rand((b, t, h), generator=g) < 0.8
    m_ch[:, ::3] = False                                  # some rows keep no head
    row_ids, _ = active_indices(m_ch.any(-1), t)
    hm = torch.gather(m_ch, 1, row_ids.long()[..., None].expand(b, t, h))
    head_ids, head_cnt = active_indices(hm, h)
    o = torch.randn((b, h, n, dh), generator=g).to(dtype)
    w = (torch.randn((h, dh, f), generator=g) * (h * dh) ** -0.5).to(dtype)
    bias = torch.randn((b, n, f), generator=g).to(dtype)
    args = [a.to(dev) for a in (o, w, bias, row_ids, head_ids, head_cnt)]
    _close(TK.gemm_o_sparse_kernel(*args, block_rows=bm), gemm_o_ref(*args, block=bm), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [16, 32, 64])
def test_gemm_q_padding_tiles_store_zeros(dev, dtype, bm):
    """Tiles made only of padding slots (a batch with no live slot, and the
    tiles past the live prefix) skip the reduction and store zeros."""
    g = _gen(7 + bm)
    b, n, k, f = 2, 2048, 96, 520
    t = n // bm
    live = torch.zeros((b, t), dtype=torch.bool)
    live[0, torch.randperm(t, generator=g)[:3]] = True    # one partial tile, then padding
    row_ids, row_cnt = active_indices(live, t)
    x = torch.randn((b, n, k), generator=g).to(dtype).to(dev)
    w = (torch.randn((k, f), generator=g) * k ** -0.5).to(dtype).to(dev)
    row_ids, row_cnt = row_ids.to(dev), row_cnt.to(dev)
    _nan_filled_cache(dev)
    got = TK.gemm_q_sparse_kernel(x, w, row_ids, row_cnt, block_rows=bm)
    _close(got, gemm_q_ref(x, w, row_ids, row_cnt, block=bm), dtype)
    assert not got[0, 3 * bm:].any() and not got[1].any()


def _head_groups(case, b, h, t, group, g):
    """(B, T, H) head masks of T slots, laid out so that the groups of
    ``group`` consecutive slots GEMM-O's tile takes hold disjoint or
    identical head lists, or dead slots among live ones."""
    m = torch.rand((b, t, h), generator=g) < 0.6
    if case == "disjoint":
        m = (torch.arange(h)[None, None, :] % group
             == torch.arange(t)[None, :, None] % group).expand(b, t, h).clone()
    elif case == "identical":
        m = m[:, ::group].repeat_interleave(group, dim=1)[:, :t].clone()
    elif case == "dead":
        m[:, 1::3] = False                                # dead slots inside groups
        m[:, group:2 * group] = False                     # a whole group dead
    m[:, 0, 0] = True
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["disjoint", "identical", "dead", "random"])
def test_gemm_o_head_groups(dev, dtype, bm, case):
    """GEMM-O over groups of slots whose head lists are disjoint, identical,
    or hold dead slots: within tolerance of the plain version, every row no
    live slot covers keeps the bias bit for bit, the same lists with the
    slots permuted (other groups) give the same bits, and so does B5 on them
    as a one-bucket layout in another order."""
    g = _gen(["disjoint", "identical", "dead", "random"].index(case) * 100 + bm)
    b, h, n, dh, f = 2, 6, 2048, 64, 264
    t, group = n // bm, 128 // bm
    hm = _head_groups(case, b, h, t, group, g)            # in slot order
    row_ids = torch.stack([torch.randperm(t, generator=g) for _ in range(b)]).int()
    head_ids, head_cnt = active_indices(hm, h)
    o = torch.randn((b, h, n, dh), generator=g).to(dtype).to(dev)
    w = (torch.randn((h, dh, f), generator=g) * (h * dh) ** -0.5).to(dtype).to(dev)
    bias = torch.randn((b, n, f), generator=g).to(dtype).to(dev)
    lists = [a.to(dev) for a in (row_ids, head_ids, head_cnt)]
    got = TK.gemm_o_sparse_kernel(o, w, bias, *lists, block_rows=bm)
    _close(got, gemm_o_ref(o, w, bias, *lists, block=bm), dtype)
    dead = torch.zeros((b, t), dtype=torch.bool)
    dead.scatter_(1, row_ids.long(), head_cnt == 0)
    keep = dead.repeat_interleave(bm, dim=1).to(dev)
    assert torch.equal(got[keep], bias[keep])
    perm = torch.stack([torch.randperm(t, generator=g) for _ in range(b)])
    take = lambda a: torch.gather(a, 1, perm if a.dim() == 2 else
                                  perm[..., None].expand_as(a)).contiguous()
    moved = TK.gemm_o_sparse_kernel(o, w, bias, *[take(a).to(dev) for a in
                                                  (row_ids, head_ids, head_cnt)], block_rows=bm)
    assert torch.equal(moved, got)
    rows = torch.where(head_cnt > 0, row_ids, n // bm)
    gmo = [take(a).to(dev) for a in (rows, row_ids)]
    gmo += [take(head_ids).reshape(b, t * h).to(dev), take(head_cnt).to(dev)]
    geo = ((t, h),)
    bkt = TK.gemm_o_sparse_bucketed_kernel(o, w, bias, *gmo, geo, block_rows=bm)
    assert torch.equal(bkt, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_short_rows_take_the_element_path(dev, dtype):
    """Rows of 100 elements (200 bytes in bfloat16: no 16-byte cp.async)
    stage element by element; GEMM-Q, GEMM-O and B5 stay within tolerance of
    their plain versions."""
    from repro_torch.kernels import _build
    g = _gen(100)
    b, h, n, d, bm = 2, 3, 256, 100, 32
    t = n // bm
    x = torch.randn((b, n, d), generator=g).to(dtype).to(dev)
    wq = (torch.randn((d, d), generator=g) * d ** -0.5).to(dtype).to(dev)
    assert _build.aligned_rows((x, d)) == (dtype == torch.float32)
    live = torch.rand((b, t), generator=g) < 0.5
    row_ids, row_cnt = [a.to(dev) for a in active_indices(live, t)]
    _close(TK.gemm_q_sparse_kernel(x, wq, row_ids, row_cnt, block_rows=bm),
           gemm_q_ref(x, wq, row_ids, row_cnt, block=bm), dtype)
    o = torch.randn((b, h, n, d), generator=g).to(dtype).to(dev)
    wo = (torch.randn((h, d, d), generator=g) * (h * d) ** -0.5).to(dtype).to(dev)
    bias = torch.randn((b, n, d), generator=g).to(dtype).to(dev)
    hm = torch.rand((b, t, h), generator=g) < 0.6
    head_ids, head_cnt = active_indices(hm, h)
    lists = [a.to(dev) for a in (torch.arange(t).expand(b, t).int(), head_ids, head_cnt)]
    got = TK.gemm_o_sparse_kernel(o, wo, bias, *lists, block_rows=bm)
    _close(got, gemm_o_ref(o, wo, bias, *lists, block=bm), dtype)
    gmo = [torch.where(lists[2] > 0, lists[0], n // bm), lists[0],
           lists[1].reshape(b, t * h).contiguous(), lists[2]]
    assert torch.equal(TK.gemm_o_sparse_bucketed_kernel(o, wo, bias, *gmo, ((t, h),),
                                                        block_rows=bm), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arg", ["x", "w_q", "o_heads", "w_o"])
def test_gemm_misaligned_view_gives_the_aligned_bits(dev, dtype, arg):
    """A view whose data does not start on a 16-byte boundary stages element
    by element and gives the 16-byte path's bits."""
    g = _gen(16)
    b, h, n, d, f, bm = 2, 4, 512, 128, 256, 32
    t = n // bm
    shapes = {"x": (b, n, d), "w_q": (d, f), "o_heads": (b, h, n, d), "w_o": (h, d, f)}
    vals = {k: torch.randn(s, generator=g).to(dtype).to(dev) for k, s in shapes.items()}
    shifted = dict(vals)
    flat = torch.empty(vals[arg].numel() + 1, dtype=dtype, device=dev)[1:]
    shifted[arg] = flat.view(shapes[arg]).copy_(vals[arg])
    assert shifted[arg].data_ptr() % 16 and shifted[arg].is_contiguous()
    live = torch.rand((b, t), generator=g) < 0.5
    row_ids, row_cnt = [a.to(dev) for a in active_indices(live, t)]
    hm = torch.rand((b, t, h), generator=g) < 0.6
    head_ids, head_cnt = [a.to(dev) for a in active_indices(hm, h)]
    ids = torch.arange(t, device=dev).expand(b, t).int().contiguous()
    bias = torch.randn((b, n, f), generator=g).to(dtype).to(dev)
    runs = [(TK.gemm_q_sparse_kernel(v["x"], v["w_q"], row_ids, row_cnt, block_rows=bm),
             TK.gemm_o_sparse_kernel(v["o_heads"], v["w_o"], bias, ids, head_ids, head_cnt,
                                     block_rows=bm)) for v in (vals, shifted)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_the_33k_width(dev, dtype):
    """B2 at hunyuan-video-dit's 33 024 tokens: T_kv = 2064 KV blocks of 16
    (the widest KV mask the row body holds), with a full list, an empty
    list and random half-full ones over ~10 % live q blocks."""
    g = _gen(33024)
    bh, n, d, bq, bkv = 2, 33024, 128, 16, 16
    tq, tkv = n // bq, n // bkv
    m_c = torch.rand((bh, tq), generator=g) < 0.1
    q_ids, q_cnt = active_indices(m_c, 320)
    m_s = torch.rand((bh, tq, tkv), generator=g) < 0.5
    m_s[0, q_ids[0, 0]] = True                            # a row over every KV block
    m_s[1, q_ids[1, 1]] = False                           # a live row with no KV block
    rows = torch.gather(m_s, 1, q_ids.long()[..., None].expand(bh, q_ids.shape[1], tkv))
    kv_ids, kv_cnt = active_indices(rows, tkv)
    assert int(kv_cnt[0, 0]) == tkv
    q, k, v, o = (torch.randn((bh, n, d), generator=g).to(dtype) for _ in range(4))
    args = [t.to(dev) for t in (q, k, v, o, q_ids, q_ids, q_cnt, kv_ids, kv_cnt)]
    got = TK.flashomni_attention_csr(*args, block_q=bq, block_kv=bkv)
    _close(got, attention_csr_ref(*args, block_q=bq, block_kv=bkv), dtype)


@pytest.mark.parametrize("budget,lead,n", [(None, (1, 1), 17000), (1 << 20, (2, 3), 3000)])
def test_chunked_dense_attention_on_the_card_matches_the_cpu(dev, monkeypatch, budget,
                                                             lead, n):
    """The Update step's dense attention in f32 on the card against the same
    call on the CPU, at an N that spans several chunks of the score budget
    (the real one at 17 000 tokens: 2 row chunks; a small one: 9)."""
    from repro_torch.core import attention
    if budget is not None:
        monkeypatch.setattr(attention, "_SCORE_ELEMS", budget)
    g = _gen(n)
    q, k, v = (torch.randn((*lead, n, 128), generator=g) for _ in range(3))
    want = attention.dense_attention(q, k, v)
    got = attention.dense_attention(q.to(dev), k.to(dev), v.to(dev))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    _close(got.cpu(), want, torch.float32)


@pytest.mark.parametrize("grouped", ["auto", True])
def test_continuous_batcher_on_the_card_matches_the_cpu(dev, grouped):
    """The continuous batcher at smoke size (lanes refill, mixed step counts,
    grouped and scan ticks) on the card (the kernels) against the same run on
    the CPU (their plain versions): latents at the smoke samplers' 1e-3 /
    1e-4, trace modes exactly, and the Dispatch kernels launched."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.serve import serving_engine_config, serving_inputs
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    params, pe, reqs = serving_inputs(cfg, n_vision=96, batch=1, num_requests=5, num_steps=8,
                                      mixed_steps=True, device="cpu")
    res = {}
    for d in ("cpu", dev):
        to = lambda t: t.to(d)
        p = {k: ({kk: to(vv) for kk, vv in v.items()} if isinstance(v, dict) else to(v))
             for k, v in params.items()}
        TK.reset_launches()
        bat = ContinuousBatcher(p, cfg, ecfg, patch_embed=to(pe), lanes=3, grouped=grouped)
        bat.submit_all([dataclasses.replace(r, x0=to(r.x0), text_emb=to(r.text_emb))
                        for r in reqs])
        res[str(d)] = (bat.run(), bat.stats)
    launches = {fn.__name__: fn.launches for fn in TK.KERNELS}
    (cpu, cpu_stats), (card, card_stats) = res["cpu"], res[str(dev)]
    assert card_stats["grouped_ticks"] == cpu_stats["grouped_ticks"] > 0
    assert card_stats["scan_ticks"] == cpu_stats["scan_ticks"] > 0
    for r in reqs:
        assert card[r.rid]["out"].device.type == "cuda"
        torch.testing.assert_close(card[r.rid]["out"].cpu(), cpu[r.rid]["out"], rtol=1e-3,
                                   atol=1e-4)
        assert [s["kind"] for s in card[r.rid]["trace"]] == \
            [s["kind"] for s in cpu[r.rid]["trace"]]
    want = cfg.n_layers * card_stats["denoise_calls"]["dispatch"]
    assert launches["gemm_q_sparse_kernel"] == launches["flashomni_attention_csr"] == want


def test_analyzer_green_on_the_card(dev):
    """``run_analysis`` with the engine on the card (the kernels launch at
    the analyzer geometry): no finding."""
    from repro_torch.analysis import run_analysis
    assert run_analysis(device="cuda", verbose=False) == []


@pytest.mark.parametrize("kv_buckets", [1, 3])
def test_dispatch_record_on_the_card_holds_its_launched_kernels(dev, kv_buckets):
    """On the card a Dispatch record shows its three kernels as regions,
    each of which launched once, and no decode op."""
    from repro_torch.analysis.op_walk import kernel_regions
    from repro_torch.analysis.passes import _N, DispatchPurity, _engine_cfg, trace_pair
    cfg = dataclasses.replace(_engine_cfg(kv_buckets=kv_buckets), cap_kv_frac=0.85)
    trace_pair.cache_clear()
    TK.reset_launches()
    assert DispatchPurity().check("card", cfg, "cuda") == []
    regions = kernel_regions(trace_pair(cfg, _N, "cuda")[1])
    assert len(regions) == 3
    assert all({fn.__name__: fn.launches for fn in TK.KERNELS}[name] == 1 for name in regions)


def test_plan_validator_on_a_card_plan(dev):
    """A plan built on the card validates, and a corrupted copy gives the
    findings of the same corruption on the CPU."""
    from repro_torch.analysis import PlanValidator
    from repro_torch.analysis.passes import _N, _engine_cfg
    from repro_torch.analysis.plan_check import check_plan
    cfg = _engine_cfg(kv_buckets=3)
    plan = PlanValidator.plan(cfg, "cuda")
    assert plan.q_ids.device.type == "cuda"
    assert check_plan(plan, cfg, _N) == []
    bad = plan._replace(bkt_kv_cnt=plan.bkt_kv_cnt + 7)
    cpu = bad._replace(**{f: None if v is None else v.cpu() for f, v in zip(bad._fields, bad)})
    assert check_plan(bad, cfg, _N) == check_plan(cpu, cfg, _N) != []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_mesh_shard_shapes(dev, dtype):
    """B2 as a seq-mesh shard calls it: Q the replicated compact projection
    (N_q), K/V the shard's exchange buffer (N_kv), the output its token
    shard (N), all three different; against the plain version."""
    g = _gen(4242)
    bh, d, bq, bkv = 6, 128, 16, 16
    n_q, n_kv, n = 27 * bq, 19 * bkv, 9 * bq                 # compact Q, buffer, shard
    tq, tkv, cq = n // bq, n_kv // bkv, 7
    q_ids, q_cnt = active_indices(torch.rand((bh, tq), generator=g) < 0.7, cq)
    q_cnt[2] = 0                                             # a (b, h) with no row here
    q_src = torch.randint(0, n_q // bq, (bh, cq), generator=g).int()
    kv_ids, kv_cnt = active_indices(torch.rand((bh, cq, tkv), generator=g) < 0.5, 12)
    q, k, v = (torch.randn((bh, m, d), generator=g).to(dtype) for m in (n_q, n_kv, n_kv))
    o = torch.randn((bh, n, d), generator=g).to(dtype)
    args = [t.to(dev) for t in (q, k, v, o, q_ids, q_src, q_cnt, kv_ids, kv_cnt)]
    got = TK.flashomni_attention_csr(*args, block_q=bq, block_kv=bkv)
    _close(got, attention_csr_ref(*args, block_q=bq, block_kv=bkv), dtype)
    assert torch.equal(got[2], args[3][2])                   # o_reuse kept


def _card_mesh_rank(rank):
    """One Dispatch layer on the card across mesh (1, 2) over gloo against
    one device on the same state: (torch.equal, B2 launches of the mesh run)."""
    from repro_torch.core.engine import (AttnParams, dispatch_layer, init_layer_state,
                                         update_layer)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    b, h, n, dm, dh = 2, 4, 512, 128, 64
    rnd = lambda *s: torch.randn(s, generator=g, device=dev) * 0.05
    p = AttnParams(wq=rnd(dm, h * dh), wk=rnd(dm, h * dh), wv=rnd(dm, h * dh),
                   wo=rnd(h * dh, dm), q_scale=torch.ones(dh, device=dev),
                   k_scale=torch.ones(dh, device=dev))
    x = torch.randn((b, n, dm), generator=g, device=dev)
    out = []
    for kvb, slack in ((1, 1.5), (3, 0.5)):
        cfg = EngineConfig(mask=MaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1,
                                           degrade=0.3, block_q=16, block_kv=16, pool=32),
                           kv_buckets=kvb, mesh_dp=1, mesh_sp=2, mesh_pair_slack=slack)
        _, st = update_layer(p, x, init_layer_state(b, h, n, dm, dh, cfg, dev), cfg, heads=h)
        TK.reset_launches()
        om, _ = dispatch_layer(p, x, st, cfg, heads=h)
        launches = TK.flashomni_attention_csr.launches
        o1, _ = dispatch_layer(p, x, st, dataclasses.replace(cfg, mesh_sp=1), heads=h)
        out.append((bool(torch.equal(om, o1)), launches))
    return out


def test_mesh_dispatch_layer_on_the_card(dev):
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_local_mesh
    _build.load()                         # build once here: the ranks only load it
    for rank in run_local_mesh(_card_mesh_rank, 1, 2, timeout=120):
        assert rank == [(True, 1), (True, 1)], rank


@pytest.mark.parametrize("mode,strategy,kv_buckets,want", [
    ("bias", "flashomni", 1, ("gemm_q_sparse_kernel", "flashomni_attention_csr",
                              "gemm_o_sparse_kernel")),
    ("bias", "sliding-window", 2, ("gemm_q_sparse_kernel", "flashomni_attention_csr_bucketed",
                                   "gemm_o_sparse_bucketed_kernel")),
    ("o_cache", "flashomni", 1, ("gemm_q_sparse_kernel", "flashomni_attention_csr"))])
def test_dispatch_with_rope_kernels_match_the_twin_on_the_card(dev, mode, strategy,
                                                               kv_buckets, want):
    """Update and Dispatch with ``freqs`` on the card at capacity-truncated
    gathers (``cap_q_frac`` 0.75): the kernels, fed compact GEMM-Q rows
    rotated at their original positions, against the twin within 1e-4 once
    the rows of live blocks with an empty KV list are zeroed (the twin gives
    them a uniform softmax, the kernels zeros); each kernel of the path
    launched once, and the run without ``freqs`` differs."""
    from repro_torch.core.engine import (AttnParams, dispatch_layer, init_layer_state,
                                         rope_freqs, update_layer)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    b, h, n, dm, dh = 2, 4, 512, 256, 64
    rnd = lambda *s: torch.randn(s, generator=g, device=dev) * dm ** -0.5
    p = AttnParams(wq=rnd(dm, h * dh), wk=rnd(dm, h * dh), wv=rnd(dm, h * dh),
                   wo=rnd(h * dh, dm), q_scale=torch.ones(dh, device=dev),
                   k_scale=torch.ones(dh, device=dev))
    x = torch.randn((b, n, dm), generator=g, device=dev)
    cfg = EngineConfig(mask=MaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1,
                                       degrade=0.3, block_q=16, block_kv=16, pool=32),
                       cache_mode=mode, strategy=strategy, kv_buckets=kv_buckets,
                       cap_q_frac=0.75, cache_dtype=torch.float32)
    freqs = rope_freqs(n, dh, device=dev)
    st = init_layer_state(b, h, n, dm, dh, cfg, dev)
    for _ in range(2):
        _, st = update_layer(p, x, st, cfg, n_text=64, heads=h, freqs=freqs)
    TK.reset_launches()
    got, _ = dispatch_layer(p, x, st, cfg, n_text=64, heads=h, freqs=freqs)
    launches = {fn.__name__: fn.launches for fn in TK.KERNELS}
    assert {k: v for k, v in launches.items() if v} == dict.fromkeys(want, 1)
    twin, _ = dispatch_layer(p, x, st, dataclasses.replace(cfg, backend="torch"), n_text=64,
                             heads=h, freqs=freqs)
    plan = st.plan.widen()
    live = torch.arange(plan.q_ids.shape[-1], device=dev) < plan.q_cnt[..., None]
    empty = live & (plan.kv_row_cnt == 0)
    blocks = torch.zeros((b, h, n // 16 + 1), dtype=torch.bool, device=dev)
    blocks.scatter_(-1, torch.where(empty, plan.q_ids.long(), n // 16), True)
    bad = blocks[..., :-1].any(dim=1).repeat_interleave(16, dim=-1)
    zero = lambda o: torch.where(bad[..., None], 0.0, o)
    _close(zero(got), zero(twin), torch.float32)
    bare, _ = dispatch_layer(p, x, st, cfg, n_text=64, heads=h)
    assert float((bare - got).norm() / got.norm()) > 1e-2


@pytest.mark.parametrize("budget,n", [(None, 2048), (1 << 20, 1500)])
def test_dense_attention_grads_on_the_card(dev, monkeypatch, budget, n):
    """The grad branch of the dense attention on the card (at the real score
    budget: one chunk; at 2^20 elements: chunks of one head and 699 rows)
    against autograd of the unchunked softmax(q k^T s) v on the same card
    tensors, f32 at 1e-4."""
    from repro_torch.core import attention
    if budget is not None:
        monkeypatch.setattr(attention, "_SCORE_ELEMS", budget)
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    q, k, v, cot = (torch.randn((1, 4, n, 128), generator=g, device=dev) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(attention.dense_attention(*leaves), leaves, cot)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = torch.softmax((qs @ ks.transpose(-1, -2)) * 128 ** -0.5, dim=-1) @ vs
    want = torch.autograd.grad(out, (qs, ks, vs), cot)
    for a, w in zip(got, want):
        _close(a, w, torch.float32)


def test_one_full_width_training_step_on_the_card(dev, tmp_path):
    """flux-mmdit at every published width and 2 blocks, batch 1, 4096 + 512
    tokens: one train step gives a finite loss and gradient norm and launches
    no kernel (the engine is off in training); the full 38 blocks refuse
    before allocating (their f32 training state does not fit one card)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=2)
    TK.reset_launches()
    _, res = train(cfg, steps=1, batch=1, seq_len=4096, ckpt_dir=str(tmp_path), device=dev)
    assert all(fn.launches == 0 for fn in TK.KERNELS)
    m = res.metrics[0]
    assert torch.isfinite(torch.tensor([m["loss"], m["grad_norm"]])).all(), m
    with pytest.raises(ValueError, match="sharded"):
        train("flux-mmdit", smoke=False, steps=1, ckpt_dir=str(tmp_path), device=dev)


def _lm_logits(params, cfg, batch, steps):
    """forward's logits, ``steps`` teacher-forced decode logits and prefill's
    last row, in f32."""
    from repro_torch.models.registry import get_model
    f32 = torch.float32
    model = get_model(cfg)
    tokens = batch["tokens"]
    logits, _ = model.forward(params, batch, dtype=f32)
    cache = model.init_cache(tokens.shape[0], 64, f32, device=tokens.device)
    dec = []
    for i in range(steps):
        lg, cache = model.decode_step(params, cache, tokens[:, i], i, dtype=f32)
        dec.append(lg)
    return logits, torch.stack(dec, dim=1), model.prefill(params, batch, dtype=f32)


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_lm_smoke_on_the_card_matches_the_cpu(dev, arch):
    """The LM smoke config on the card against the CPU from the same weights:
    forward on 80 tokens (gemma's and recurrentgemma's windowed layers on
    the banded path), 40 decode steps that wrap the 32-slot rings, prefill,
    with the stub frames or patches where the family takes them; within
    1e-4 of the largest magnitude."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    cfg = get_smoke(arch)
    params = get_model(cfg).init_params(_gen(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 80), generator=_gen(1))}
    stub = {"encdec": ("frames", cfg.encoder_len),
            "vlm": ("patches", cfg.num_image_tokens)}.get(cfg.family)
    if stub:
        batch[stub[0]] = torch.randn((2, stub[1], cfg.d_model), generator=_gen(4))
    with torch.no_grad():
        want = _lm_logits(params, cfg, batch, 40)
        got = _lm_logits(tree_map(lambda t: t.to(dev), params), cfg,
                         {k: v.to(dev) for k, v in batch.items()}, 40)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


def test_moe_mlp_at_granite_moe_width_on_the_card(dev):
    """One ``moe_mlp`` at granite-moe-3b-a800m's width (d_model 1536, 40
    experts of d_ff 512, top-8) on 256 tokens: the card's routing (expert
    ids, positions, keep mask) equals the CPU's and its output is within
    1e-4 of the largest magnitude."""
    from repro_torch.models import layers
    p = layers.init_moe(_gen(2), 1536, 512, 40, device="cpu")
    x = torch.randn((1, 256, 1536), generator=_gen(3))
    cap = int(1.25 * 256 * 8 / 40) + 1
    pd, xd = {k: v.to(dev) for k, v in p.items()}, x.to(dev)
    with torch.no_grad():
        y, aux = layers.moe_mlp(p, x, top_k=8)
        yd, auxd = layers.moe_mlp(pd, xd, top_k=8)
        route = layers.moe_route(torch.softmax(x[0] @ p["router"], dim=-1), 8, cap)
        route_d = layers.moe_route(torch.softmax(xd[0] @ pd["router"], dim=-1), 8, cap)
    for a, w in zip(route_d[1:], route[1:]):
        assert torch.equal(a.cpu(), w)
    assert _rel(yd, y) <= 1e-4 and _rel(auxd, aux) <= 1e-4


TP_SEQ, TP_BATCH = 256, 2


def _tp_inputs(dev):
    """gemma3-1b smoke with remat, its weights and one batch, on ``dev``."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    cfg = dataclasses.replace(get_smoke("gemma3-1b"), remat=True)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = get_model(cfg).init_params(g, dev)
    tok = lambda: torch.randint(0, cfg.vocab, (TP_BATCH, TP_SEQ), generator=g, device=dev,
                                dtype=torch.int32)
    return cfg, params, {"tokens": tok(), "labels": tok()}


def _card_tp_rank(rank):
    """One train step of gemma3-1b smoke split over ``model`` on mesh (1, 2)
    on the card: (loss, AdamW's first moment gathered whole)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import DEFAULT_RULES as R, redistribute
    from repro_torch.launch import specs as S
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import adamw_init, adamw_state_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, params, batch = _tp_inputs(dev)
    model = get_model(cfg)
    mesh = DeviceMesh("cuda", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
    fn = build_train_step(cfg, ShapeSpec("tp", TP_SEQ, TP_BATCH, "train"), mesh, R,
                          dtype=torch.float32)[0]
    p = reshard_state(params, model.param_specs(), mesh, R)
    o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh, R)
    b = reshard_state(batch, S.train_batch_logical(cfg), mesh, R)
    _, o, m = fn(p, o, b)
    whole = [redistribute(x, [Replicate(), Replicate()]).to_local().cpu()
             for x in tree_leaves(o["mu"])]
    return float(m["loss"].to_local()), whole, fn.stats["tp_replicated"]


def test_tensor_parallel_train_step_matches_autograd_on_the_card(dev):
    """S5's pair at smoke width: the loss and every gradient (AdamW's first
    moment after one step) of the step split over ``model`` within 1e-4 of
    the tree's largest magnitude of unsharded autograd on the card."""
    from repro_torch.launch.mesh import run_local_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
    cfg, params, batch = _tp_inputs(dev)
    leaves, tdef = tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    loss = get_model(cfg).train_loss(tree_unflatten(tdef, leaves), batch, dtype=torch.float32)
    grads = tree_unflatten(tdef, torch.autograd.grad(loss, leaves))
    _, o, _ = adamw_update(grads, adamw_init(params), params, AdamWConfig())
    want = [t.cpu() for t in tree_leaves(o["mu"])]
    scale = max(float(t.abs().max()) for t in want)
    loss = float(loss.detach())
    for got_loss, got, replicated in run_local_mesh(_card_tp_rank, 1, 2, timeout=300):
        assert replicated == []
        assert abs(got_loss - loss) <= 1e-4 * abs(loss)
        assert max(float((a - w).abs().max()) for a, w in zip(got, want)) <= 1e-4 * scale
