"""Dispatch backend, port of ``repro.core.backend.PallasBackend`` (uniform
layout).

One Dispatch step is GEMM-Q → CSR sparse attention → GEMM-O plus the
forecast bias, driven by the frozen :class:`~repro_torch.core.plan.
DispatchPlan` and chained through the compact GEMM-Q layout: attention reads
Q straight out of the ``(B, Cr·pool, H·dh)`` projection through
``plan.q_slots``.  Batch and heads are part of each kernel's grid, so one
launch per stage covers the whole batch.  Each kernel wrapper routes by the
tensors' device: CPU tensors run the plain versions, CUDA tensors the
Hopper kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SparseAttentionSpec
from repro_torch.core.plan import DispatchPlan
from repro_torch.kernels import (flashomni_attention_csr, gemm_o_sparse_kernel,
                                 gemm_q_sparse_kernel)

__all__ = ["KernelBackend", "get_backend"]


class KernelBackend:
    """The three Dispatch kernels, layout-fused through the compact GEMM-Q output."""

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
        if spec.kv_buckets != 1:
            raise NotImplementedError("the bucketed CSR kernel is not ported yet")
        plan = plan.widen()
        b, h, _, dh = q.shape
        n = o_reuse.shape[-2]
        # Heads fold into the kernel's leading axis; a view that is not
        # contiguous (the transposed Q projection) is copied once here.
        flat = lambda a: a.reshape(b * h, *a.shape[2:]).contiguous()
        out = flashomni_attention_csr(
            flat(q), flat(k), flat(v), flat(o_reuse), flat(plan.q_ids),
            flat(plan.q_slots if compact_q else plan.q_ids), flat(plan.q_cnt),
            flat(plan.kv_row_ids), flat(plan.kv_row_cnt),
            block_q=spec.block_q, block_kv=spec.block_kv, scale=scale)
        return out.reshape(b, h, n, dh)

    def gemm_o(self, o_tok, w, plan: DispatchPlan, bias: torch.Tensor, *,
               block: int,
               spec: Optional[SparseAttentionSpec] = None) -> torch.Tensor:
        """o_tok (B, N, H, dh), w (H, dh, F), bias (B, N, F) -> (B, N, F)."""
        plan = plan.widen()
        return gemm_o_sparse_kernel(
            o_tok.transpose(1, 2).contiguous(), w.contiguous(), bias.contiguous(),
            plan.row_ids, plan.head_ids, plan.head_cnt, block_rows=block)


_KERNELS = KernelBackend()


def get_backend(cfg) -> KernelBackend:
    """Resolve ``EngineConfig.backend`` (only ``"kernels"`` is ported)."""
    if cfg.backend != "kernels":
        raise NotImplementedError(
            f"engine backend {cfg.backend!r} is not ported yet; the port runs "
            "'kernels'")
    return _KERNELS
