"""B2's share of its roofline over the window, in %: the least time the
card could take for the work each ``flashomni_attention_csr`` call's live
lists need, summed, over the device time of the kernels inside the calls'
ranges (``omnibench.trace.roofline_pct``)."""

from omnibench.trace import roofline_pct


def read(run):
    return roofline_pct(run, ("flashomni_attention_csr",))
