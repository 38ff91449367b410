"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), one
wrapper per kernel with a launch counter, and their plain PyTorch versions
(:mod:`repro_torch.kernels.ref`).  :mod:`repro_torch.kernels.ops` is the
unified entry over them (the reference's ``kernels/ops.py``).  Not
applicable: the reference's ``kernels/_compat.py``, an alias that reaches
Pallas' TPU compiler parameters across JAX versions (ROADMAP A.10.3)."""

from repro_torch.kernels.flashomni_attention import (flashomni_attention_csr,
                                                     flashomni_attention_csr_bucketed,
                                                     flashomni_attention_symbols)
from repro_torch.kernels.gemm_o import gemm_o_sparse_bucketed_kernel, gemm_o_sparse_kernel
from repro_torch.kernels.gemm_q import gemm_q_sparse_kernel
from repro_torch.kernels.taylor_reuse import taylor_reuse_kernel

__all__ = ["gemm_q_sparse_kernel", "flashomni_attention_csr", "gemm_o_sparse_kernel",
           "flashomni_attention_csr_bucketed", "gemm_o_sparse_bucketed_kernel",
           "flashomni_attention_symbols", "taylor_reuse_kernel",
           "KERNELS", "reset_launches"]

#: Every kernel wrapper of the port: the uniform Dispatch path in order, the
#: bucketed attention and GEMM-O that replace B2 and B3 when kv_buckets > 1,
#: then the symbols attention and the Taylor reuse of the ops entry.
KERNELS = (gemm_q_sparse_kernel, flashomni_attention_csr, gemm_o_sparse_kernel,
           flashomni_attention_csr_bucketed, gemm_o_sparse_bucketed_kernel,
           flashomni_attention_symbols, taylor_reuse_kernel)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
