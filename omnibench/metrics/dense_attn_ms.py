"""Device milliseconds an Update step spends in the engine's chunked dense
attention (``core.attention.dense_attention``): the kernels inside its
profiler ranges over the window, per Update step of the window."""

from omnibench.trace import DENSE


def read(run):
    n = sum(s["kind"] == "update" for s in run.steps)
    if run.profile is None or not n or DENSE not in run.profile["ranges"]:
        return None
    return run.profile["ranges"][DENSE] / n * 1e3
