"""Cost model over recorded op streams, and the cost of each kernel, the
port's counterpart of ``repro.analysis.cost_model``.

:func:`cost_of_record` folds a per-op cost table over an
:class:`~repro_torch.analysis.op_walk.OpRecord` and returns a
:class:`CostEstimate`: FLOPs (2 per multiply-add, as
``torch.utils.flop_counter`` and XLA count them), memory bytes and, per
collective kind, the payload and the count.  The table:

=================================  ===========================================
op family                          cost rule
=================================  ===========================================
``mm``/``bmm``/``addmm``/          FLOPs = 2 · out_elems · K; bytes = operands
``baddbmm``                        + result
``convolution``                    FLOPs = 2 · out_elems · (C_in/groups ·
                                   kernel window); bytes = operands + result
``gather``/``index``/              bytes = 2 · result + indices (never the
``index_select``/``take``          operand: a plan gather must not bill the
                                   whole KV it indexes into); 0 FLOPs
``scatter*``/``index_put``/        FLOPs = updates; bytes = 2 · updates +
``index_add``/``index_copy``       indices
``sort``/``topk``/``kthvalue``     FLOPs = n · log2 n per lane of n
reductions (``sum``, ``amax``, …)  FLOPs = input elements; bytes = in + out
views (``view``, ``permute``, …)   0 FLOPs, 0 bytes (they move nothing)
layout moves (``clone``,           0 FLOPs, in + out bytes (``copy_``,
``_to_copy``, ``cat``, …)          ``fill_``: the written bytes, not the old
                                   values)
collectives (``c10d.*``,           payload = the RESULT (an in-place c10d op's
``_c10d_functional.*``)            output buffer, a functional op's output:
                                   ``all_gather`` the gathered tensor,
                                   ``reduce_scatter`` the shard, ``all_reduce``
                                   the tensor, ``all_to_all`` the moved
                                   total); wire = the bytes crossing links at
                                   group size p (:data:`WIRE_FACTORS`); count
                                   1 per op, keyed by
                                   :func:`~repro_torch.analysis.op_walk.
                                   collective_kind`; bytes = the buffers
``wait_tensor``,                   0 FLOPs, 0 bytes (they hand the result on)
``_wrap_tensor_autograd``
everything else (elementwise)      FLOPs = out_elems; bytes = in + out
a kernel region                    :func:`kernel_cost` at the plan's
                                   CAPACITY counts (:func:`region_counts`)
=================================  ===========================================

Only nodes outside kernel regions are billed: a region is billed as its
kernel, whatever its plain version does on the CPU (or on ``meta``, where
it runs nothing), so a record costs the same on every device.  An in-place
op is one node, billed once.  Like the reference's, the byte count is a
pre-fusion upper bound: a scaling certificate (bytes a function of live
slots, or of ``T_kv``?), not an absolute counter.

**The kernels.**  :func:`kernel_cost` is the one place the FLOPs and bytes
of B1–B7 are written down.  ``chip_smoke.py`` bills each kernel at the
**live** counts of the plan it runs (:func:`plan_counts`) for its
``bound_ms``; a record bills a kernel region at the plan's **capacity**
(every slot live, every list full), as the reference bills a
``pallas_call`` at body × grid.  The count keys each kernel reads:

=====================================  =========================================
kernel                                 counts
=====================================  =========================================
``gemm_q_sparse_kernel`` (B1)          b, cr, block, k, f, live_rows
``flashomni_attention_csr`` (B2)       bh, n, dh, block_q, block_kv,
                                       live_slots, kv_live_blocks,
                                       kv_union_blocks
``flashomni_attention_csr_bucketed``   B2's, and layout_rows
(B4)
``gemm_o_sparse_kernel`` (B3),         b, n, f, dh, h, cr, block, live_heads,
``gemm_o_sparse_bucketed_kernel`` (B5) heads_used
``flashomni_attention_symbols`` (B6)   bh, n, dh, block_q, block_kv, live_rows,
                                       live_pairs, kv_union_blocks,
                                       symbol_bytes
``taylor_reuse_kernel`` (B7)           orders, bh, n, dh, block, cached
=====================================  =========================================

:func:`peak_bytes_of` estimates the peak of concurrently live storages by a
last-use scan over the record (views share their base's bytes; the call's
inputs live throughout).

The collectives' payload is the reference's convention (the dry run's
HLO-result bytes), and the wire bytes are its factors
(``repro.analysis.cost_model._collective_cost``); the group size is the
one the recorder read (``OpNode.group_size``), and a collective whose group
is not known is billed its payload on the wire.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.analysis.op_walk import OpNode, OpRecord, collective_kind

__all__ = ["CostEstimate", "cost_of_record", "op_cost", "peak_bytes_of", "kernel_cost",
           "region_counts", "plan_counts", "VIEW_OPS", "LAYOUT_OPS", "WIRE_FACTORS"]


@dataclasses.dataclass
class CostEstimate:
    """Additive resource totals for one recorded call."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_payload: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, other: "CostEstimate") -> None:
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        for mine, theirs in ((self.coll_payload, other.coll_payload),
                             (self.coll_wire, other.coll_wire),
                             (self.coll_count, other.coll_count)):
            for kind, v in theirs.items():
                mine[kind] = mine.get(kind, 0) + v

    @property
    def wire_bytes(self) -> float:
        return float(sum(self.coll_wire.values()))


# Ops that alias their input: no data moves.
VIEW_OPS = frozenset(f"aten.{n}" for n in (
    "view", "_unsafe_view", "reshape", "transpose", "t", "permute", "expand", "slice",
    "select", "unsqueeze", "squeeze", "alias", "as_strided", "unfold", "split",
    "split_with_sizes", "unbind", "diagonal", "detach", "lift_fresh", "view_as",
    "expand_as", "_reshape_alias", "narrow", "movedim", "view_as_real", "view_as_complex",
    "chunk"))
# Ops that move or make data without arithmetic.
LAYOUT_OPS = frozenset(f"aten.{n}" for n in (
    "clone", "_to_copy", "copy", "copy_", "cat", "stack", "repeat", "repeat_interleave",
    "constant_pad_nd", "flip", "roll", "contiguous", "zeros", "zeros_like", "ones",
    "ones_like", "empty", "empty_like", "empty_strided", "full", "full_like", "new_zeros",
    "new_ones", "new_empty", "new_full", "arange", "fill", "fill_", "zero_", "scalar_tensor",
    "randn", "rand", "normal_", "uniform_", "tril", "triu", "_unsafe_index"))
_WRITE_ONLY = frozenset({"aten.copy_", "aten.fill_", "aten.zero_", "aten.normal_",
                         "aten.uniform_"})
# Bookkeeping with no data movement.
_FREE_OPS = frozenset({"aten._local_scalar_dense", "aten.sym_size", "aten.sym_numel",
                       "aten.sym_stride", "aten.is_nonzero", "aten.equal",
                       "aten.record_stream", "aten.set_"})
# The functional collectives' bookkeeping: each hands its input on (in a
# wrapper of its own, so a new storage key that holds no new bytes).
_HAND_ON_OPS = frozenset({"_c10d_functional.wait_tensor",
                          "_c10d_functional._wrap_tensor_autograd"})
_MATMUL = frozenset({"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.addbmm",
                     "aten.dot", "aten.mv", "aten.vdot"})
_GATHER = frozenset({"aten.gather", "aten.index", "aten.index_select", "aten.take",
                     "aten.embedding", "aten.take_along_dim", "aten.masked_select"})
_SCATTER = frozenset({"aten.scatter", "aten.scatter_", "aten.scatter_add",
                      "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
                      "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
                      "aten.index_add", "aten.index_add_", "aten.index_copy",
                      "aten.index_copy_", "aten.index_fill", "aten.index_fill_"})
_SORT = frozenset({"aten.sort", "aten.argsort", "aten.msort", "aten.topk", "aten.kthvalue"})
_REDUCE = frozenset(f"aten.{n}" for n in (
    "sum", "mean", "amax", "amin", "max", "min", "any", "all", "prod", "argmax", "argmin",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "count_nonzero", "nansum", "cumsum", "cumprod"))
_ATTENTION = frozenset({"aten._scaled_dot_product_flash_attention",
                        "aten._scaled_dot_product_efficient_attention",
                        "aten._scaled_dot_product_cudnn_attention",
                        "aten._scaled_dot_product_flash_attention_for_cpu"})


def _elems(m) -> float:
    return float(math.prod(m.shape))


def _bytes(metas) -> float:
    return float(sum(m.nbytes for m in metas))


def _io(node: OpNode) -> float:
    return _bytes(node.inputs) + _bytes(node.outputs)


def _dim(node: OpNode, pos: int) -> int:
    """The ``dim`` argument of an op: keyword, or positional at ``pos``."""
    args, kwargs = node.args
    dim = kwargs.get("dim", args[pos] if len(args) > pos else -1)
    return dim if isinstance(dim, int) else -1


def _matmul_cost(node: OpNode) -> CostEstimate:
    # the contraction length: the last dim of the left operand (the one
    # after the bias for addmm/baddbmm/addbmm)
    left = node.inputs[1] if node.name in ("aten.addmm", "aten.baddbmm",
                                           "aten.addbmm") else node.inputs[0]
    k = left.shape[-1] if left.shape else 1
    out = sum(_elems(m) for m in node.outputs)
    return CostEstimate(flops=2.0 * out * k, hbm_bytes=_io(node))


def _conv_cost(node: OpNode) -> CostEstimate:
    # the weight is (C_out, C_in / groups, *window)
    red = math.prod(node.inputs[1].shape[1:])
    out = sum(_elems(m) for m in node.outputs)
    return CostEstimate(flops=2.0 * out * red, hbm_bytes=_io(node))


def _gather_cost(node: OpNode) -> CostEstimate:
    # Touched bytes: the gathered slices (the result, read and written)
    # plus the indices; never the operand.
    idx = _bytes(m for m in node.inputs[1:] if not m.dtype.is_floating_point
                 or node.name == "aten.masked_select")
    return CostEstimate(hbm_bytes=2.0 * _bytes(node.outputs) + idx)


def _scatter_cost(node: OpNode) -> CostEstimate:
    # Read and write the touched window (the updates) plus the indices;
    # the rest of the operand aliases through.
    ins = node.inputs[1:]
    idx = [m for m in ins if m.dtype in (torch.int64, torch.int32, torch.int16,
                                         torch.bool, torch.uint8)]
    upd = [m for m in ins if m not in idx]
    if upd:
        n_upd = sum(_elems(m) for m in upd)
        b_upd = _bytes(upd)
    else:                                    # a scalar value: one per index
        n_upd = max((_elems(m) for m in idx), default=0.0)
        b_upd = n_upd * torch.empty((), dtype=node.inputs[0].dtype).element_size()
    return CostEstimate(flops=n_upd, hbm_bytes=2.0 * b_upd + _bytes(idx))


def _sort_cost(node: OpNode) -> CostEstimate:
    # n log2 n per sorted lane of length n
    src = node.inputs[0]
    if not src.shape:
        return CostEstimate(hbm_bytes=_io(node))
    # sort(self, dim) / topk(self, k, dim); sort.stable takes dim by keyword
    n = src.shape[_dim(node, 2 if node.name in ("aten.topk", "aten.kthvalue") else 1)]
    lanes = _elems(src) / max(n, 1)
    return CostEstimate(flops=lanes * n * max(1.0, math.log2(max(n, 2))),
                        hbm_bytes=_io(node))


def _attention_cost(node: OpNode) -> CostEstimate:
    q, k = node.inputs[0], node.inputs[1]
    return CostEstimate(flops=4.0 * _elems(q) * k.shape[-2], hbm_bytes=_io(node))


# Wire bytes of a collective of ``payload`` result bytes over ``p`` ranks,
# the reference's factors (all_reduce is its psum: a reduce-scatter and an
# all-gather; a reduce-scatter's result is the shard).  Any other kind:
# its payload.
WIRE_FACTORS = {
    "all_to_all": lambda payload, p: payload * (p - 1) / p,
    "all_gather": lambda payload, p: payload * (p - 1) / p,
    "all_reduce": lambda payload, p: 2.0 * payload * (p - 1) / p,
    "reduce_scatter": lambda payload, p: payload * (p - 1),
}


def _collective_cost(node: OpNode, kind: str) -> CostEstimate:
    # The result: what a functional op returns, or what an in-place c10d op
    # returns beside its Work (``_allgather_base_``'s output buffer); an op
    # that returns its Work alone (``alltoall_base_``) writes its first
    # argument, the output buffer.
    payload = _bytes(node.outputs) if node.outputs else (
        node.inputs[0].nbytes if node.inputs else 0.0)
    p = node.group_size
    wire = WIRE_FACTORS[kind](payload, p) if kind in WIRE_FACTORS and p else payload
    return CostEstimate(hbm_bytes=_io(node), coll_payload={kind: payload},
                        coll_wire={kind: wire}, coll_count={kind: 1})


def op_cost(node: OpNode) -> CostEstimate:
    """The cost of one recorded op (a kernel region: see :func:`kernel_cost`)."""
    name = node.name
    kind = collective_kind(name)
    if kind is not None:
        return _collective_cost(node, kind)
    if node.kind == "kernel":
        dtype = next((m.dtype for m in node.inputs if m.dtype.is_floating_point),
                     torch.float32)
        return kernel_cost(name, region_counts(node), dtype)
    if name in _FREE_OPS or name in VIEW_OPS or name in _HAND_ON_OPS:
        return CostEstimate()
    if name in LAYOUT_OPS:
        if name in _WRITE_ONLY:
            return CostEstimate(hbm_bytes=_bytes(node.inputs[1:]) + _bytes(node.outputs))
        return CostEstimate(hbm_bytes=_io(node))
    if name in _MATMUL:
        return _matmul_cost(node)
    if name == "aten.convolution":
        return _conv_cost(node)
    if name in _GATHER:
        return _gather_cost(node)
    if name in _SCATTER:
        return _scatter_cost(node)
    if name in _SORT:
        return _sort_cost(node)
    if name in _ATTENTION:
        return _attention_cost(node)
    if name in _REDUCE:
        return CostEstimate(flops=sum(_elems(m) for m in node.inputs[:1]),
                            hbm_bytes=_io(node))
    # element-wise and everything else: one flop per output element
    return CostEstimate(flops=sum(_elems(m) for m in node.outputs), hbm_bytes=_io(node))


def cost_of_record(record: OpRecord) -> CostEstimate:
    """Resource totals of a recorded call: every node outside the kernel
    regions, each region billed as its kernel."""
    total = CostEstimate()
    for node in record.nodes:
        if not node.path:
            total.add(op_cost(node))
    return total


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.finfo(dtype).bits // 8


def kernel_cost(name: str, counts: dict, dtype) -> CostEstimate:
    """FLOPs and memory bytes of one launch of kernel ``name`` on the work
    ``counts`` describes (keys: see the module docstring), with float
    tensors of ``dtype`` (a torch dtype or its name) and int32 indices.
    Bytes count each input read once and each output written once."""
    e = _itemsize(dtype)
    c = counts
    if name == "gemm_q_sparse_kernel":
        flops = 2.0 * c["live_rows"] * c["block"] * c["k"] * c["f"]
        nbytes = (e * (c["live_rows"] * c["block"] * c["k"] + c["k"] * c["f"]
                       + c["b"] * c["cr"] * c["block"] * c["f"])
                  + 4 * (c["b"] * c["cr"] + c["b"]))
    elif name in ("flashomni_attention_csr", "flashomni_attention_csr_bucketed"):
        bq, bkv, dh = c["block_q"], c["block_kv"], c["dh"]
        flops = 4.0 * c["kv_live_blocks"] * bq * bkv * dh
        nbytes = (e * (c["live_slots"] * bq * dh + 2 * c["kv_union_blocks"] * bkv * dh
                       + 2 * c["bh"] * c["n"] * dh)
                  + 4 * (c["kv_live_blocks"] + 3 * c["live_slots"]))
        if name == "flashomni_attention_csr_bucketed":
            nbytes += 4 * (c["layout_rows"] - c["live_slots"])
    elif name in ("gemm_o_sparse_kernel", "gemm_o_sparse_bucketed_kernel"):
        flops = 2.0 * c["live_heads"] * c["block"] * c["dh"] * c["f"]
        nbytes = (e * (c["live_heads"] * c["block"] * c["dh"] + c["heads_used"] * c["dh"] * c["f"]
                       + 2 * c["b"] * c["n"] * c["f"])
                  + 4 * (c["b"] * c["cr"] * (2 + c["h"])))
    elif name == "flashomni_attention_symbols":
        bq, bkv, dh = c["block_q"], c["block_kv"], c["dh"]
        t_q = c["n"] // bq
        flops = 4.0 * c["live_pairs"] * bq * bkv * dh
        nbytes = (e * (c["live_rows"] * bq * dh + 2 * c["kv_union_blocks"] * bkv * dh
                       + (c["bh"] * t_q - c["live_rows"]) * bq * dh + c["bh"] * c["n"] * dh)
                  + c["symbol_bytes"])
    elif name == "taylor_reuse_kernel":
        blk = c["cached"] * c["block"] * c["dh"]
        flops = 2.0 * c["orders"] * blk
        nbytes = (e * (c["orders"] * blk + (c["bh"] * c["n"] * c["dh"] - blk)
                       + c["bh"] * c["n"] * c["dh"])
                  + 4 * (c["cached"] + c["bh"] + c["orders"]))
    else:
        raise KeyError(f"no cost rule for kernel {name!r}")
    return CostEstimate(flops=flops, hbm_bytes=nbytes)


def region_counts(node: OpNode) -> dict:
    """The CAPACITY counts of a recorded kernel region, from the shapes of
    its arguments: every slot live, every list full, each listed KV block
    staged once per slot (the reference's body × grid)."""
    a = node.args
    name = node.name
    if name == "gemm_q_sparse_kernel":
        b, _, k = a["x"].shape
        cr = a["row_ids"].shape[-1]
        return dict(b=b, cr=cr, block=a["block_rows"], k=k, f=a["w"].shape[-1],
                    live_rows=b * cr)
    if name == "flashomni_attention_csr":
        bh, cq, ckv = a["kv_ids"].shape
        return dict(bh=bh, n=a["o_reuse"].shape[1], dh=a["q"].shape[-1],
                    block_q=a["block_q"], block_kv=a["block_kv"], live_slots=bh * cq,
                    kv_live_blocks=bh * cq * ckv, kv_union_blocks=bh * cq * ckv)
    if name == "flashomni_attention_csr_bucketed":
        b, r = a["bkt_head"].shape
        s = a["bkt_kv_ids"].shape[-1]
        return dict(bh=b * a["heads"], n=a["o_reuse"].shape[1], dh=a["q"].shape[-1],
                    block_q=a["block_q"], block_kv=a["block_kv"], live_slots=b * r,
                    kv_live_blocks=b * s, kv_union_blocks=b * s, layout_rows=b * r)
    if name in ("gemm_o_sparse_kernel", "gemm_o_sparse_bucketed_kernel"):
        b, h, n, dh = a["o_heads"].shape
        if name == "gemm_o_sparse_kernel":
            cr = a["row_ids"].shape[-1]
            live_heads = b * cr * h
        else:
            cr = a["gmo_rows"].shape[-1]
            live_heads = b * a["gmo_head_ids"].shape[-1]
        return dict(b=b, n=n, f=a["w"].shape[-1], dh=dh, h=h, cr=cr,
                    block=a["block_rows"], live_heads=live_heads, heads_used=h)
    if name == "flashomni_attention_symbols":
        bh, n, dh = a["q"].shape
        t_q, t_kv = n // a["block_q"], a["k"].shape[1] // a["block_kv"]
        return dict(bh=bh, n=n, dh=dh, block_q=a["block_q"], block_kv=a["block_kv"],
                    live_rows=bh * t_q, live_pairs=bh * t_q * t_kv, kv_union_blocks=bh * t_kv,
                    symbol_bytes=_elems(a["s_c"]) + _elems(a["s_s"]))
    if name == "taylor_reuse_kernel":
        o1, bh, n, dh = a["derivs"].shape
        return dict(orders=o1, bh=bh, n=n, dh=dh, block=a["block"],
                    cached=bh * a["ids"].shape[-1])
    raise KeyError(f"no capacity counts for kernel {name!r}")


def plan_counts(plan, ecfg, b: int, h: int, n: int) -> dict:
    """The LIVE counts of a DispatchPlan (ids widened) at batch ``b``, ``h``
    heads and ``n`` tokens: what the clamped lists really need, and the
    plan's geometry.  ``live_rows`` live pool rows (B1), ``live_slots``
    live (head, q-slot) rows, ``kv_live_blocks`` listed KV blocks of live
    rows, ``kv_union_blocks`` KV blocks in the union of a (b, h)'s live
    lists (B2, B4), ``live_heads`` live (row, head) pairs and
    ``heads_used`` heads live in any row (B3, B5), ``layout_rows`` the
    bucketed layout's rows (B4)."""
    dev = plan.q_ids.device
    m = ecfg.mask
    cr = plan.row_ids.shape[-1]
    cq, ckv = plan.kv_row_ids.shape[-2:]
    t_kv = -(-n // m.block_kv)
    q_cnt = plan.q_cnt.reshape(b * h)
    kv_ids = plan.kv_row_ids.reshape(b * h, cq, ckv)
    kv_cnt = plan.kv_row_cnt.reshape(b * h, cq)
    slot_live = torch.arange(cq, device=dev) < q_cnt[:, None]
    j_live = (torch.arange(ckv, device=dev) < kv_cnt[..., None]) & slot_live[..., None]
    union = torch.zeros((b * h, t_kv + 1), dtype=torch.bool, device=dev)
    union.scatter_(1, torch.where(j_live, kv_ids.long(), t_kv).reshape(b * h, -1), True)
    return dict(
        b=b, h=h, n=n, bh=b * h, cr=cr, cq=cq, ckv=ckv, block=m.pool, block_q=m.block_q,
        block_kv=m.block_kv,
        layout_rows=None if plan.bkt_head is None else plan.bkt_head.numel(),
        live_rows=int(plan.row_cnt.sum()), live_slots=int(slot_live.sum()),
        kv_live_blocks=int(torch.where(slot_live, kv_cnt, 0).sum()),
        kv_union_blocks=int(union[:, :t_kv].sum()), live_heads=int(plan.head_cnt.sum()),
        heads_used=int(plan.head_mask.any(dim=0).any(dim=0).sum()))


# ---------------------------------------------------------------------------
# Peak of live storages
# ---------------------------------------------------------------------------

def peak_bytes_of(record: OpRecord) -> float:
    """Peak concurrently live bytes by a last-use scan over the nodes
    outside kernel regions (a region is one node; its scratch stays on
    chip).  Live throughout: the call's inputs and any storage made
    before the call.  A storage made by a node lives from there to its
    last use (the call's outputs to the end); views and in-place results
    share their base's storage, so they add nothing, as do the results of
    the functional collectives' bookkeeping (``wait_tensor``)."""
    nodes = [n for n in record.nodes if not n.path]
    size = record.storage_bytes
    alias: dict = {}
    root = lambda key: alias.get(key, key)
    made, last = {}, {}
    for i, node in enumerate(nodes):
        if node.name in _HAND_ON_OPS and node.inputs:
            for m in node.outputs:
                alias[m.key] = root(node.inputs[0].key)
        for m in node.inputs:
            last[root(m.key)] = i
        for m in node.outputs:
            key = root(m.key)
            if key not in made and key not in last and key not in record.inputs:
                made[key] = i
            last[key] = max(last.get(key, i), i)
    end = len(nodes)
    for key in record.outputs:
        last[root(key)] = end
    base = set(record.inputs) | {k for k in last if k not in made}
    base_bytes = float(sum(size[k] for k in base))
    born = {}
    for key, i in made.items():
        born.setdefault(i, []).append(key)
    dies = {}
    for key in made:
        dies.setdefault(last[key], []).append(key)
    live = peak = 0.0
    for i in range(end):
        live += sum(size[k] for k in born.get(i, ()))
        peak = max(peak, live)
        live -= sum(size[k] for k in dies.get(i, ()))
    return base_bytes + peak
