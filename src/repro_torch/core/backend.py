"""Dispatch backends, port of ``repro.core.backend``.

One Dispatch step is GEMM-Q → sparse attention → GEMM-O plus the forecast
bias, driven by the frozen :class:`~repro_torch.core.plan.DispatchPlan`.
Two implementations sit behind one interface, picked by
``EngineConfig.backend``:

  * :class:`KernelBackend` (``"kernels"``, the default; the reference's
    ``PallasBackend``): the Hopper kernels, chained through the compact
    GEMM-Q layout: attention reads Q straight out of the
    ``(B, Cr·pool, H·dh)`` projection through ``plan.q_slots``.  Batch and
    heads are part of each kernel's grid, so one launch per stage covers
    the whole batch.  With ``kv_buckets > 1`` attention and GEMM-O run the
    bucketed kernels (B4, B5) instead of B2 and B3.  Each kernel wrapper
    routes by the tensors' device: CPU tensors run the plain versions, CUDA
    tensors the kernels.
  * :class:`TorchBackend` (``"torch"``; the reference's ``XlaBackend``):
    the structural twin, plain torch gathers, einsums and softmax over the
    same plan, launching no kernel.  It shares the kernels' truncation:
    whenever ``cap_kv`` can truncate a row it reads the per-row CSR lists
    (``kv_row_ids``/``kv_row_cnt``), and ``plan.head_mask`` carries the
    GEMM-O bucket clamp.  It follows its reference on a live row whose KV
    list is empty (a uniform softmax, where the kernels write zeros), so a
    comparison with the kernels zeroes those rows first.  The twin holds
    "kernel ≡ structural path" checkable inside the port, to f32 rounding
    (the reference holds it to allclose as well).

There is no ``"auto"``: the kernel wrappers already route by the tensor's
device.  With ``EngineConfig.mesh_sp > 1``, :func:`get_backend` wraps the
backend in :class:`MeshBackend` (``mesh-kernels``, ``mesh-torch``):
attention runs sharded across the ``(data, seq)`` mesh of
``torch.distributed`` ranks (:mod:`repro_torch.distributed.plan_shard`);
GEMM-Q, GEMM-O and the K/V projections run replicated on every rank.

Batched serving (:mod:`repro_torch.launch.batching`) folds lanes into the
batch axis of these backends.  Both keep batch as a leading axis of every
plan field and of every kernel's grid, so a folded call computes each
sample as its own call would (the library GEMMs around them may round
otherwise at more rows).  Lanes fold only when their whole step context is
equal: the mode, every layer's ``k_since`` and ``taylor.n_updates``, at
Update also the strategy-id row, the step and the step count, and the lane
shape (``pipeline.make_grouped_lane_tick``).  Not applicable here: the
reference's compile budget (≤ 4 executables per lane shape), ``core/lru.py``,
``schedule_cache_stats`` and ``stats["executables"]``, since the port
compiles nothing per configuration.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sparse_gemm
from repro_torch.core.attention import SparseAttentionSpec, sparse_attention_from_plan
from repro_torch.core.plan import DispatchPlan, bucket_geometry
from repro_torch.kernels import (flashomni_attention_csr, flashomni_attention_csr_bucketed,
                                 gemm_o_sparse_bucketed_kernel, gemm_o_sparse_kernel,
                                 gemm_q_sparse_kernel)

__all__ = ["TorchBackend", "KernelBackend", "MeshBackend", "get_backend",
           "available_backends"]


class TorchBackend:
    """The structural twin over precomputed plan indices (no kernel)."""

    name = "torch"
    compact_q = False

    def gemm_q(self, x: torch.Tensor, w: torch.Tensor, plan: DispatchPlan, *,
               block: int) -> torch.Tensor:
        """(B, N, d_in) @ (d_in, F) -> (B, N, F), zeros on cached rows."""
        plan = plan.widen()
        return sparse_gemm.gemm_q_from_plan(x, w, plan.row_ids, plan.row_cnt, block=block)

    def attention(self, q, k, v, o_reuse, plan: DispatchPlan,
                  spec: SparseAttentionSpec, *, scale: Optional[float] = None,
                  compact_q: bool = False) -> torch.Tensor:
        """q (B, H, N_q, dh) [compact when ``compact_q``]; k/v/o_reuse full.
        The per-row lists go along with the union layout and are read
        whenever ``cap_kv`` can truncate.  A seq-mesh plan (one with
        ``shd_*`` fields) carries its pair clamp in ``kv_row_cnt`` only, so it
        forces the per-row layout even where ``cap_kv`` admits the union:
        that is how one device reads a mesh plan as the shards do."""
        plan = plan.widen()
        return sparse_attention_from_plan(
            q, k, v, o_reuse, plan.q_ids, plan.q_cnt, plan.kv_ids, plan.kv_cnt,
            plan.pair_live, spec, scale=scale,
            q_src_ids=plan.q_slots if compact_q else None,
            kv_row_ids=plan.kv_row_ids, kv_row_cnt=plan.kv_row_cnt,
            force_per_row=plan.shd_q_ids is not None)

    def gemm_o(self, o_tok, w, plan: DispatchPlan, bias: torch.Tensor, *, block: int,
               spec: Optional[SparseAttentionSpec] = None, h_lo: int = 0) -> torch.Tensor:
        """o_tok (B, N, H, dh), w (H, dh, F), bias (B, N, F) -> (B, N, F); the
        bucket clamp is already in ``plan.head_mask``.  ``o_tok`` and ``w``
        hold the plan's heads ``[h_lo, h_lo + H)`` (a rank's share of a
        ``model`` row)."""
        plan = plan.widen()
        mask = plan.head_mask[..., h_lo:h_lo + w.shape[0]]
        return sparse_gemm.gemm_o_from_plan(o_tok, w, mask, plan.row_ids, plan.row_cnt, bias,
                                            block=block)


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
               block: int, spec: Optional[SparseAttentionSpec] = None,
               h_lo: int = 0) -> torch.Tensor:
        """o_tok (B, N, H, dh), w (H, dh, F), bias (B, N, F) -> (B, N, F).

        The plan's ``head_cnt`` already folds the bucket clamp in, so the
        uniform and the bucketed kernel give the same result.  ``o_tok``
        and ``w`` hold the plan's heads ``[h_lo, h_lo + H)`` (a rank's share
        of a ``model`` row): then the uniform kernel runs over that head
        range, the bucketed layout folding every head into its slots."""
        plan = plan.widen()
        o_heads, w, bias = o_tok.transpose(1, 2).contiguous(), w.contiguous(), bias.contiguous()
        whole = h_lo == 0 and w.shape[0] == plan.head_ids.shape[-1]
        if whole and spec is not None and spec.kv_buckets > 1 and plan.gmo_rows is not None:
            geometry = bucket_geometry(plan.row_ids.shape[-1], w.shape[0], 1,
                                       spec.kv_buckets)
            return gemm_o_sparse_bucketed_kernel(
                o_heads, w, bias, plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids,
                plan.gmo_head_cnt, geometry, block_rows=block)
        return gemm_o_sparse_kernel(o_heads, w, bias, plan.row_ids, plan.head_ids,
                                    plan.head_cnt, block_rows=block, h_lo=h_lo)


class MeshBackend:
    """Mesh-sharded Dispatch: attention runs per shard across the
    ``(data, seq)`` mesh, exchanging only the plan-live KV blocks
    (:func:`~repro_torch.distributed.plan_shard.mesh_attention`), and every
    rank gets the whole output; GEMM-Q and GEMM-O delegate to ``inner``
    unchanged, replicated on every rank."""

    def __init__(self, inner, cfg):
        self.inner = inner
        self.cfg = cfg
        self.name = f"mesh-{inner.name}"
        self.compact_q = inner.compact_q

    def gemm_q(self, x, w, plan, *, block):
        return self.inner.gemm_q(x, w, plan, block=block)

    def attention(self, q, k, v, o_reuse, plan: DispatchPlan, spec: SparseAttentionSpec, *,
                  scale: Optional[float] = None, compact_q: bool = False) -> torch.Tensor:
        from repro_torch.distributed.plan_shard import mesh_attention
        return mesh_attention(self.inner, self.cfg, q, k, v, o_reuse, plan, spec,
                              scale=scale, compact_q=compact_q)

    def gemm_o(self, o_tok, w, plan, bias, *, block, spec=None, h_lo=0):
        return self.inner.gemm_o(o_tok, w, plan, bias, block=block, spec=spec, h_lo=h_lo)


_BACKENDS = {"torch": TorchBackend(), "kernels": KernelBackend()}


def available_backends() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def get_backend(cfg):
    """Resolve ``EngineConfig.backend`` to a backend instance, wrapped in
    :class:`MeshBackend` when ``cfg.mesh_sp > 1``."""
    try:
        inner = _BACKENDS[cfg.backend]
    except KeyError:
        raise ValueError(f"unknown engine backend {cfg.backend!r}; expected one of "
                         f"{available_backends()}") from None
    return MeshBackend(inner, cfg) if cfg.mesh_sp > 1 else inner
