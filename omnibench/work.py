"""The benchmark's yardstick: the work a step and a kernel call need, the
card's peaks and the names of the port's kernels.

Frozen copies, so that a change to the program cannot move the bounds it is
judged against:

* :func:`kernel_work` is ``repro_torch.analysis.cost_model.kernel_cost`` for
  B1 (``gemm_q_sparse_kernel``), B2 (``flashomni_attention_csr``) and B3
  (``gemm_o_sparse_kernel``), without its layout terms (the KV union, the
  bucketed layout rows and the capacity rows ``cr``): K, V and the GEMM-O
  weight are read whole, once, and only live rows and pairs are counted.
* :data:`PEAKS` is ``chip_smoke.py``'s ``PEAKS`` table (NVIDIA data sheets,
  dense rates).
* :data:`KERNEL_GROUPS` and :func:`kernel_group` are ``chip_smoke.py``'s
  ``KERNEL_GROUPS`` and ``_kernel_group``, with cuBLAS's ``nvjet`` kernels
  (its bf16 GEMMs on the H100) among the library GEMMs.

Counts come from the plan's live lists and the shapes, never from a
kernel's own walk: a rewrite of a kernel is judged against the same work.
"""

from __future__ import annotations

# Card name fragment -> peak FLOP/s by type and HBM bytes/s; first match
# wins, the SXM part ("") is the default.
PEAKS = (
    ("PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "tf32": 378e12, "hbm": 2.0e12}),
    ("NVL", {"float32": 60e12, "bfloat16": 835e12, "tf32": 417.5e12, "hbm": 3.9e12}),
    ("", {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12, "hbm": 3.35e12}),
)

# CUDA kernel symbol fragment -> the wrapper that launches it.
KERNEL_GROUPS = (("gemm_q_kernel", "gemm_q_sparse_kernel"),
                 ("csr_bucketed_kernel", "flashomni_attention_csr_bucketed"),
                 ("csr_attention_kernel", "flashomni_attention_csr"),
                 ("symbols_attention_kernel", "flashomni_attention_symbols"),
                 ("gemm_o_bucketed_kernel", "gemm_o_sparse_bucketed_kernel"),
                 ("gemm_o_kernel", "gemm_o_sparse_kernel"),
                 ("taylor_reuse_kernel", "taylor_reuse_kernel"))

SORT_GROUP = "sort/top-k (plan build)"
SCAN_GROUP = "scan"

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def peaks_for(card: str) -> dict:
    """The peak table entry of a card, matched by its name."""
    return next(p for key, p in PEAKS if key in card)


def kernel_group(name: str) -> str:
    """The group a device kernel's symbol belongs to."""
    for key, group in KERNEL_GROUPS:
        if key in name:
            return group
    lowered = name.lower()
    if any(key in lowered for key in ("gemm", "cutlass", "xmma", "nvjet")):
        return "library GEMM (dense projections, MLP, dense attention)"
    if any(key in lowered for key in ("sort", "radix", "topk", "kthvalue")):
        return SORT_GROUP
    if "scan" in lowered:
        return SCAN_GROUP
    return "other (elementwise, reductions, copies)"


def kernel_work(name: str, c: dict, dtype: str) -> tuple[float, float]:
    """(FLOPs, HBM bytes) one call of kernel ``name`` needs for the live
    counts ``c``, with float tensors of ``dtype`` and int32 indices.  Each
    input byte is read once and each output byte written once.

    B1 ``gemm_q_sparse_kernel``: ``live_rows`` live pool rows of ``block``
    tokens, ``b`` batch, ``k`` → ``f`` columns.  B2
    ``flashomni_attention_csr``: ``bh`` (batch, head) rows of ``n`` tokens,
    ``live_slots`` live q blocks, ``kv_live_blocks`` listed KV blocks of live
    q blocks, blocks of ``block_q`` × ``block_kv`` tokens, head size ``dh``.
    B3 ``gemm_o_sparse_kernel``: ``live_heads`` live (row, head) pairs,
    ``rows`` live rows, ``h`` heads of ``dh`` → ``f`` columns, ``n`` tokens."""
    e = _ITEMSIZE[dtype]
    if name == "gemm_q_sparse_kernel":
        rows = c["live_rows"] * c["block"]
        flops = 2.0 * rows * c["k"] * c["f"]
        nbytes = e * (rows * c["k"] + c["k"] * c["f"] + rows * c["f"]) + 4 * (c["live_rows"]
                                                                             + c["b"])
    elif name == "flashomni_attention_csr":
        bq, bkv, dh = c["block_q"], c["block_kv"], c["dh"]
        flops = 4.0 * c["kv_live_blocks"] * bq * bkv * dh
        live_q = c["live_slots"] * bq
        # Q of the live rows, K and V whole, the reused rows of o_reuse, the
        # output whole; the live lists' ids.
        nbytes = (e * (live_q * dh + 2 * c["bh"] * c["n"] * dh
                       + (c["bh"] * c["n"] - live_q) * dh + c["bh"] * c["n"] * dh)
                  + 4 * (c["kv_live_blocks"] + 2 * c["live_slots"] + c["bh"]))
    elif name == "gemm_o_sparse_kernel":
        flops = 2.0 * c["live_heads"] * c["block"] * c["dh"] * c["f"]
        # The live heads' rows, the weight whole, the bias read and the
        # output written whole; the head lists' ids.
        nbytes = (e * (c["live_heads"] * c["block"] * c["dh"] + c["h"] * c["dh"] * c["f"]
                       + 2 * c["b"] * c["n"] * c["f"])
                  + 4 * (c["live_heads"] + 2 * c["rows"]))
    else:
        raise KeyError(f"no work rule for kernel {name!r}")
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: dict, dtype: str) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(flops / peak[dtype], nbytes / peak["hbm"])


def update_step_flops(cfg: dict, n_vision: int, batch: int = 1) -> float:
    """FLOPs an Update step needs: every dense GEMM and the dense attention
    of every layer at their shapes (the cache bias GEMM, the strategy's
    pooled maps and the elementwise work are not counted)."""
    d, h, hd, ff, layers = (cfg["d_model"], cfg["n_heads"], cfg["head_dim"], cfg["d_ff"],
                            cfg["n_layers"])
    n = n_vision + cfg["n_text_tokens"]
    per_layer = (2.0 * batch * n * d * h * hd * 4        # Q, K, V, O projections
                 + 4.0 * batch * h * n * n * hd          # QK^T and PV
                 + 4.0 * batch * n * d * ff              # the MLP's two GEMMs
                 + 2.0 * batch * d * 6 * d)              # adaLN
    return layers * per_layer + _outside_blocks_flops(cfg, n_vision, batch)


def dispatch_step_dense_flops(cfg: dict, n_vision: int, batch: int = 1) -> float:
    """FLOPs of a Dispatch step outside the sparse kernels: K and V
    projections, the MLP, adaLN and what lies outside the blocks.  B1-B3's
    work is added from the plan's live counts (:func:`kernel_work`)."""
    d, h, hd, ff, layers = (cfg["d_model"], cfg["n_heads"], cfg["head_dim"], cfg["d_ff"],
                            cfg["n_layers"])
    n = n_vision + cfg["n_text_tokens"]
    per_layer = (2.0 * batch * n * d * h * hd * 2 + 4.0 * batch * n * d * ff
                 + 2.0 * batch * d * 6 * d)
    return layers * per_layer + _outside_blocks_flops(cfg, n_vision, batch)


def _outside_blocks_flops(cfg: dict, n_vision: int, batch: int) -> float:
    d = cfg["d_model"]
    return (2.0 * batch * n_vision * cfg["patch_dim"] * d * 2     # patch embed, final proj
            + 2.0 * batch * (256 * d + d * d + d * 2 * d))        # t_mlp1, t_mlp2, final_mod
