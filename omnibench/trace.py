"""What a ``--trace 1`` run records beside the window, and how the trace is
read.

* :class:`KernelCalls` listens to the port's ``kernels/_region.kernel_region``
  hook: each kernel wrapper's call opens a profiler range named after the
  wrapper, and its live counts (from the plan's lists it was handed) are
  kept as device scalars, read once after the window.
* :func:`annotated_dense_attention` is ``chip_smoke.py``'s context of the
  same name: every ``dense_attention`` call of the engine and the DiT runs
  inside a profiler range.
* :func:`read_profile` reduces the profiler's events to the device's busy
  time within the window, the kernel time inside each named range, the
  device time by operation group and the longest idle gaps, each named by
  the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from omnibench.work import bound_s, kernel_group, kernel_work, peaks_for

WINDOW = "omnibench.window"
DENSE = "omnibench.dense_attention"
KERNEL = "omnibench.kernel."


def _counts(name: str, a: dict) -> dict:
    """The live counts of one kernel call, from its bound arguments (device
    scalars where they come from the plan's lists)."""
    if name == "gemm_q_sparse_kernel":
        x, w = a["x"], a["w"]
        return dict(b=x.shape[0], k=x.shape[-1], f=w.shape[-1], block=a["block_rows"],
                    live_rows=a["row_cnt"].sum())
    if name == "flashomni_attention_csr":
        o, kv_cnt = a["o_reuse"], a["kv_cnt"]
        live = torch.arange(kv_cnt.shape[-1], device=kv_cnt.device) < a["q_cnt"][:, None]
        return dict(bh=o.shape[0], n=o.shape[1], dh=a["q"].shape[-1], block_q=a["block_q"],
                    block_kv=a["block_kv"], live_slots=live.sum(),
                    kv_live_blocks=torch.where(live, kv_cnt, 0).sum())
    if name == "gemm_o_sparse_kernel":
        b, h, n, dh = a["o_heads"].shape
        cnt = a["head_cnt"]
        return dict(b=b, h=h, n=n, dh=dh, f=a["w"].shape[-1], block=a["block_rows"],
                    live_heads=cnt.sum(), rows=(cnt > 0).sum())
    return {}


class KernelCalls:
    """A ``kernel_region`` listener: every call's name and live counts, and a
    profiler range around it."""

    def __init__(self):
        self.calls: list[tuple[str, dict]] = []
        self._open: list = []

    def enter_region(self, name, bound):
        self.calls.append((name, _counts(name, bound)))
        rf = torch.autograd.profiler.record_function(KERNEL + name)
        rf.__enter__()
        self._open.append(rf)

    def exit_region(self, name, result):
        self._open.pop().__exit__(None, None, None)

    def resolved(self) -> list[tuple[str, dict]]:
        """The calls with their counts as Python numbers (one device read)."""
        flat = [(i, k, v) for i, (_, c) in enumerate(self.calls) for k, v in c.items()
                if isinstance(v, torch.Tensor)]
        values = torch.stack([v.to(torch.int64) for _, _, v in flat]).tolist() if flat else []
        out = [(name, dict(c)) for name, c in self.calls]
        for (i, k, _), val in zip(flat, values):
            out[i][1][k] = val
        return out


@contextlib.contextmanager
def annotated_dense_attention():
    """Every ``dense_attention`` call of the engine and the DiT inside a
    profiler range named :data:`DENSE`."""
    from repro_torch.core import engine
    from repro_torch.models import dit
    plain = engine.dense_attention

    def annotated(*args, **kw):
        with torch.autograd.profiler.record_function(DENSE):
            return plain(*args, **kw)

    engine.dense_attention = dit.dense_attention = annotated
    try:
        yield
    finally:
        engine.dense_attention = dit.dense_attention = plain


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_profile(prof) -> dict:
    """The window's device busy seconds and length, kernel seconds inside each
    named range (``ranges``), device seconds by group (``groups``) and the
    ten longest idle gaps (``gaps``: ``[name, seconds]``)."""
    cuda = torch.autograd.DeviceType.CUDA
    host, kernels, spans = [], [], defaultdict(list)
    window = None
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation():
                spans[name].append((s, e))
            else:
                kernels.append((s, e, name))
        else:
            if name == WINDOW:
                window = (s, e)
            host.append((s, e, name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    ws, we = window
    kernels = sorted(k for k in kernels if k[1] > ws and k[0] < we)
    starts = [k[0] for k in kernels]
    busy = _merge((max(s, ws), min(e, we)) for s, e, _ in kernels)
    busy_ns = sum(e - s for s, e in busy)

    # Kernel time inside each named range, and which range each kernel is in.
    owner = [None] * len(kernels)
    ranges = {}
    for name, sp in spans.items():
        if not (name == DENSE or name.startswith(KERNEL)):
            continue
        total = 0
        for s, e in sp:
            for j in range(bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)):
                total += kernels[j][1] - kernels[j][0]
                owner[j] = name
        ranges[name] = total / 1e9
    groups = defaultdict(float)
    for (s, e, name), own in zip(kernels, owner):
        if own == DENSE:
            grp = "dense attention (chunked, Update steps)"
        elif own is not None:
            grp = own[len(KERNEL):]
        else:
            grp = kernel_group(name)
        groups[grp] += (e - s) / 1e9

    # Idle gaps, each named by the innermost host op running at its middle.
    gaps = []
    prev = ws
    for s, e in busy + [[we, we]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, reverse=True)[:10]
    host.sort()
    hstarts = [h[0] for h in host]
    named = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        label = "host: no op"
        for j in range(bisect.bisect_right(hstarts, mid) - 1,
                       max(-1, bisect.bisect_right(hstarts, mid) - 20000), -1):
            hs, he, hn = host[j]
            if he >= mid and hn != WINDOW:
                label = hn
                break
        named.append([label, length / 1e9])
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_ns / 1e9, "ranges": ranges,
            "groups": sorted(([k, v] for k, v in groups.items()), key=lambda kv: -kv[1]),
            "gaps": named}


def roofline_pct(run, names) -> "float | None":
    """The calls of kernels ``names`` as a share of their roofline, in %:
    the least time their live work needs (:func:`omnibench.work.kernel_work`),
    summed over the window's calls, over the device time of the kernels
    inside those calls' ranges.  ``None`` without a trace or a call."""
    if run.profile is None:
        return None
    peak = peaks_for(run.card)
    bound = sum(bound_s(*kernel_work(name, c, run.dtype), peak, run.dtype)
                for name, c in run.calls if name in names)
    spent = sum(run.profile["ranges"].get(KERNEL + name, 0.0) for name in names)
    return 100.0 * bound / spent if bound and spent else None
