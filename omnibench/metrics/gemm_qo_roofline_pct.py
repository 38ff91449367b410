"""B1 and B3 together as a share of their roofline over the window, in %:
the least time for the work of each ``gemm_q_sparse_kernel`` and
``gemm_o_sparse_kernel`` call's live rows and heads, summed, over the
device time of the kernels inside those calls' ranges
(``omnibench.trace.roofline_pct``)."""

from omnibench.trace import roofline_pct


def read(run):
    return roofline_pct(run, ("gemm_q_sparse_kernel", "gemm_o_sparse_kernel"))
