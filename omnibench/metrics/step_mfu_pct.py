"""The whole window's share of the card's dense bf16 peak, in %: the FLOPs
its steps need over the traced window's seconds times the peak.  An Update
step needs every dense GEMM and the dense attention at their shapes; a
Dispatch step the dense GEMMs outside the sparse kernels at their shapes,
and GEMM-Q, the attention and GEMM-O for the plan's live counts
(``omnibench.work``)."""

from omnibench.work import (dispatch_step_dense_flops, kernel_work, peaks_for,
                            update_step_flops)

SPARSE = ("gemm_q_sparse_kernel", "flashomni_attention_csr", "gemm_o_sparse_kernel")


def read(run):
    p = run.profile
    if p is None or not p["window_s"]:
        return None
    cfg, nv, b = run.config, run.traffic["n_vision"], run.traffic["batch"]
    n_u = sum(s["kind"] == "update" for s in run.steps)
    n_d = sum(s["kind"] == "dispatch" for s in run.steps)
    flops = (n_u * update_step_flops(cfg, nv, b) + n_d * dispatch_step_dense_flops(cfg, nv, b)
             + sum(kernel_work(name, c, run.dtype)[0] for name, c in run.calls
                   if name in SPARSE))
    return 100.0 * flops / (p["window_s"] * peaks_for(run.card)[run.dtype])
