"""Dispatch backend, port of ``repro.core.backend.PallasBackend``.

One Dispatch step is GEMM-Q → CSR sparse attention → GEMM-O plus the
forecast bias, driven by the frozen :class:`~repro_torch.core.plan.
DispatchPlan` and chained through the compact GEMM-Q layout: attention reads
Q straight out of the ``(B, Cr·pool, H·dh)`` projection through
``plan.q_slots``.  Batch and heads are part of each kernel's grid, so one
launch per stage covers the whole batch.  With ``kv_buckets > 1`` the plan
carries the bucketed layouts and attention and GEMM-O run the bucketed
kernels (B4, B5) instead of B2 and B3.  Each kernel wrapper routes by the
tensors' device: CPU tensors run the plain versions, CUDA tensors the
Hopper kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SparseAttentionSpec
from repro_torch.core.plan import DispatchPlan, bucket_geometry
from repro_torch.kernels import (flashomni_attention_csr, flashomni_attention_csr_bucketed,
                                 gemm_o_sparse_bucketed_kernel, gemm_o_sparse_kernel,
                                 gemm_q_sparse_kernel)

__all__ = ["KernelBackend", "get_backend"]


class KernelBackend:
    """The Dispatch kernels, layout-fused through the compact GEMM-Q output."""

    name = "kernels"
    compact_q = True

    def gemm_q(self, x: torch.Tensor, w: torch.Tensor, plan: DispatchPlan, *,
               block: int) -> torch.Tensor:
        """COMPACT (B, Cr·block, F) projection of the live row blocks."""
        plan = plan.widen()
        return gemm_q_sparse_kernel(x, w, plan.row_ids, plan.row_cnt,
                                    block_rows=block)

    def attention(self, q, k, v, o_reuse, plan: DispatchPlan,
                  spec: SparseAttentionSpec, *, scale: Optional[float] = None,
                  compact_q: bool = False) -> torch.Tensor:
        """q (B, H, N_q, dh) [compact when ``compact_q``]; k/v/o_reuse full."""
        plan = plan.widen()
        b, h, _, dh = q.shape
        n = o_reuse.shape[-2]
        # Heads fold into the kernel's leading axis; a view that is not
        # contiguous (the transposed Q projection) is copied once here.
        flat = lambda a: a.reshape(b * h, *a.shape[2:]).contiguous()
        if spec.kv_buckets > 1 and plan.bkt_head is not None:
            # The layout rows fold the heads, so the (B, R) / (B, S) fields
            # stay as they are.  Dead rows are skipped and all-cached heads
            # keep o_reuse: no guard is needed.
            out = flashomni_attention_csr_bucketed(
                flat(q), flat(k), flat(v), flat(o_reuse), plan.bkt_head, plan.bkt_q_ids,
                plan.bkt_q_slots if compact_q else plan.bkt_q_src, plan.bkt_kv_ids,
                plan.bkt_kv_cnt, bucket_geometry(spec.cap_q, spec.cap_kv, h, spec.kv_buckets),
                heads=h, block_q=spec.block_q, block_kv=spec.block_kv, scale=scale)
            return out.reshape(b, h, n, dh)
        out = flashomni_attention_csr(
            flat(q), flat(k), flat(v), flat(o_reuse), flat(plan.q_ids),
            flat(plan.q_slots if compact_q else plan.q_ids), flat(plan.q_cnt),
            flat(plan.kv_row_ids), flat(plan.kv_row_cnt),
            block_q=spec.block_q, block_kv=spec.block_kv, scale=scale)
        return out.reshape(b, h, n, dh)

    def gemm_o(self, o_tok, w, plan: DispatchPlan, bias: torch.Tensor, *,
               block: int,
               spec: Optional[SparseAttentionSpec] = None) -> torch.Tensor:
        """o_tok (B, N, H, dh), w (H, dh, F), bias (B, N, F) -> (B, N, F).

        The plan's ``head_cnt`` already folds the bucket clamp in, so the
        uniform and the bucketed kernel give the same result."""
        plan = plan.widen()
        o_heads, w, bias = o_tok.transpose(1, 2).contiguous(), w.contiguous(), bias.contiguous()
        if spec is not None and spec.kv_buckets > 1 and plan.gmo_rows is not None:
            geometry = bucket_geometry(plan.row_ids.shape[-1], w.shape[0], 1,
                                       spec.kv_buckets)
            return gemm_o_sparse_bucketed_kernel(
                o_heads, w, bias, plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids,
                plan.gmo_head_cnt, geometry, block_rows=block)
        return gemm_o_sparse_kernel(o_heads, w, bias, plan.row_ids, plan.head_ids,
                                    plan.head_cnt, block_rows=block)


_KERNELS = KernelBackend()


def get_backend(cfg) -> KernelBackend:
    """Resolve ``EngineConfig.backend`` (only ``"kernels"`` is ported)."""
    if cfg.backend != "kernels":
        raise NotImplementedError(
            f"engine backend {cfg.backend!r} is not ported yet; the port runs "
            "'kernels'")
    return _KERNELS
