"""How ``correct`` is decided: the latents the window's steps produced,
against the plain reference (:mod:`omnibench.reference`) run on the same
weights and inputs once the window has closed.

The number compared, ``latent_rel_l2``, is the largest over the judged
steps of ``‖(x_p − x0) − (x_r − x0)‖ / ‖x_r − x0‖``: the distance of the
program's displacement of the latents from the reference's, relative to the
reference's, at every step of every judged request.  The judged requests
are the window's last (the one cut at the window's end, up to its last
step) and one more drawn from the seed among the others.  The limit is the
cell's ``limits/<workload>.json``; PERF.md gives the readings it was set
from.
"""

from __future__ import annotations

import random

import torch

from omnibench.reference import Reference


def judged_requests(log, seed: int) -> list[int]:
    reqs = sorted({s["request"] for s in log})
    picked = [reqs[-1]]
    if len(reqs) > 1:
        picked.append(random.Random(seed).choice(reqs[:-1]))
    return sorted(picked)


def latent_gap(ref: Reference, x0, text, pe, program: dict, n_steps: int) -> float:
    """The largest relative gap of the displacement over ``program``'s
    steps (``{step: latents}``), the reference run from ``x0`` up to the
    last of them."""
    worst = [0.0]

    def each(i, xr):
        xp = program.get(i)
        if xp is None:
            return
        dr = (xr - x0).double()
        gap = float(((xp - x0).double() - dr).norm() / dr.norm().clamp(min=1e-30))
        worst[0] = max(worst[0], gap if gap == gap else float("inf"))

    ref.run(x0, text, pe, n_steps, max(program) + 1, each)
    return worst[0]


def judge(cfg, traffic, params, pe, inputs, log, limits, seed) -> dict:
    """``{"correct", "checks"}``: the verdict and each number compared with
    its limit."""
    ref = Reference(cfg, params, dtype=getattr(torch, cfg["dtype"]))
    gap = 0.0
    for req in judged_requests(log, seed):
        program = {step: x for (r, step), x in log.latents.items() if r == req}
        if any(x is None for x in program.values()):
            gap = float("inf")
            continue
        x0, text = inputs[req]
        gap = max(gap, latent_gap(ref, x0, text, pe, program, traffic["steps"]))
    limit = limits.get("latent_rel_l2", {}).get("limit")
    ok = limit is not None and gap <= limit
    return {"correct": bool(ok), "checks": {"latent_rel_l2": {"value": gap, "limit": limit}}}
