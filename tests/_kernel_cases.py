"""One small call of each of the seven kernel wrappers (B1-B7), for tests
that drive every wrapper on some device.  Imports no JAX: the card-only
tests share it."""

import torch

from repro_torch import kernels as TK
from repro_torch.core.engine import EngineConfig
from repro_torch.core.masks import MaskConfig
from repro_torch.core.plan import bucket_geometry, build_dispatch_plan
from repro_torch.core.symbols import active_indices, pack_bits


KERNEL_NAMES = [fn.__name__ for fn in TK.KERNELS]


def kernel_call(name: str, seed: int = 0) -> tuple:
    """``(wrapper, args, kwargs)`` of the wrapper ``name`` on CPU tensors."""
    return next(c for c in kernel_calls(seed) if c[0].__name__ == name)


def kernel_calls(seed: int = 0) -> list:
    """``[(wrapper, args, kwargs)]`` on CPU tensors, one a wrapper, at
    shapes every kernel takes (head_dim 32, blocks 16)."""
    g = torch.Generator()
    g.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g)
    b, h, n, d, f, blk = 2, 2, 128, 32, 48, 16
    t = n // blk
    cfg = EngineConfig(mask=MaskConfig(block_q=blk, block_kv=blk, pool=blk),
                       cap_q_frac=1.0, cap_kv_frac=1.0, kv_buckets=2)
    m_c = torch.rand((b, h, t), generator=g) < 0.7
    m_s = torch.rand((b, h, t, t), generator=g) < 0.6
    plan, spec = build_dispatch_plan(m_c, m_s, cfg, n).widen(), cfg.caps(n)
    bh = b * h
    cq, ckv = plan.kv_row_ids.shape[-2:]
    q, k, v, o = (rnd(bh, n, d) for _ in range(4))
    flat = lambda x: x.reshape(bh, *x.shape[2:])
    csr = (flat(plan.q_ids), flat(plan.q_ids), flat(plan.q_cnt),
           flat(plan.kv_row_ids).reshape(bh, cq, ckv), flat(plan.kv_row_cnt).reshape(bh, cq))
    cr = plan.row_ids.shape[-1]
    o_heads, w_o, bias = rnd(b, h, n, d), rnd(h, d, f), rnd(b, n, f)
    x, w_q = rnd(b, n, f), rnd(f, h * d)
    cached = torch.rand((bh, t), generator=g) < 0.5
    ids, cnt = active_indices(cached, t)
    return [
        (TK.gemm_q_sparse_kernel, (x, w_q, plan.row_ids, plan.row_cnt), dict(block_rows=blk)),
        (TK.flashomni_attention_csr, (q, k, v, o, *csr), dict(block_q=blk, block_kv=blk)),
        (TK.flashomni_attention_csr_bucketed,
         (q, k, v, o, plan.bkt_head, plan.bkt_q_ids, plan.bkt_q_src, plan.bkt_kv_ids,
          plan.bkt_kv_cnt, bucket_geometry(spec.cap_q, spec.cap_kv, h, spec.kv_buckets)),
         dict(heads=h, block_q=blk, block_kv=blk)),
        (TK.gemm_o_sparse_kernel, (o_heads, w_o, bias, plan.row_ids, plan.head_ids,
                                   plan.head_cnt), dict(block_rows=blk)),
        (TK.gemm_o_sparse_bucketed_kernel,
         (o_heads, w_o, bias, plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids,
          plan.gmo_head_cnt, bucket_geometry(cr, h, 1, 2)), dict(block_rows=blk)),
        (TK.flashomni_attention_symbols,
         (q, k, v, o, pack_bits(m_c.reshape(bh, t)), pack_bits(m_s.reshape(bh, t * t))),
         dict(block_q=blk, block_kv=blk)),
        (TK.taylor_reuse_kernel, (rnd(2, bh, n, d), rnd(2), rnd(bh, n, d), ids, cnt),
         dict(block=blk)),
    ]


def on(device, args: tuple) -> tuple:
    """``args`` with every tensor moved to ``device``."""
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
