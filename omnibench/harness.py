"""The benchmark's harness: one cell, one seed, one window.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by its name in ``BENCHMARK.json``:

* ``<folder>/configs/<config>.json``: the sizes, the engine's settings and
  the per-layer symbol rules, as run (the entry's ``file``);
* ``<folder>/traffic/<traffic>.json``: batch, step count and vision tokens
  of the requests, sent back to back by one client;
* ``<folder>/metrics/<metric>.py``: ``read(run) -> float | None`` of one
  per-layer metric;
* ``<folder>/limits/<workload>.json``: the limit of each number the
  correctness check compares.

``<folder>`` is the directory of this file's name under the root that holds
``BENCHMARK.json``.  The system under test is ``repro_torch``
(``diffusion.pipeline.sample``); the harness hands it weights and inputs
made from the seed and reads its per-step trace, its kernel regions and the
profiler.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from omnibench import check
from omnibench.reference import step_modes

FOLDER = Path(__file__).resolve().parent.name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class WindowClosed(Exception):
    """Raised from the step log at the first step boundary after the deadline."""


class StepLog(list):
    """The ``trace`` list handed to ``pipeline.sample``: every step's entry
    with its request and end time, and the latents the step produced (read
    from the sampler's frame, where ``sample`` appends after each step)."""

    def __init__(self, deadline=None, limit=None):
        super().__init__()
        self.deadline, self.limit = deadline, limit
        self.request = 0
        self.latents: dict = {}

    def append(self, entry):
        now = time.perf_counter()
        x = sys._getframe(1).f_locals.get("x")
        super().append(dict(entry, request=self.request, end=now))
        self.latents[(self.request, entry["step"])] = x
        if ((self.deadline is not None and now >= self.deadline)
                or (self.limit is not None and len(self) >= self.limit)):
            raise WindowClosed


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed drawn from ``seed`` and ``tags``."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    folder = root / FOLDER
    limits = folder / "limits" / f"{workload}.json"
    return {"spec": spec, "cell": cell,
            "config": json.loads((root / centry["file"]).read_text()),
            "traffic": json.loads((folder / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads(limits.read_text()) if limits.exists() else {},
            "folder": folder}


def metric_reader(folder: Path, name: str):
    """``read`` of ``<folder>/metrics/<name>.py``."""
    path = folder / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"{FOLDER}_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def program_configs(cfg: dict):
    """The port's ArchConfig and EngineConfig for a configuration file."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.masks import MaskConfig
    e = cfg["engine"]
    arch = ArchConfig(name=cfg["name"], family="dit", n_layers=cfg["n_layers"],
                      d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                      n_kv_heads=cfg["n_heads"], d_ff=cfg["d_ff"], vocab=0,
                      head_dim=cfg["head_dim"], n_text_tokens=cfg["n_text_tokens"],
                      patch_dim=cfg["patch_dim"], norm_eps=cfg["norm_eps"])
    mask = MaskConfig(tau_q=e["tau_q"], tau_kv=e["tau_kv"], interval=e["interval"],
                      order=e["order"], degrade=e["degrade"], block_q=e["block_q"],
                      block_kv=e["block_kv"], pool=e["pool"], protect_text=e["protect_text"],
                      warmup_steps=e["warmup_steps"])
    ecfg = EngineConfig(mask=mask, cache_mode=e["cache_mode"], cap_q_frac=e["cap_q_frac"],
                        cap_kv_frac=e["cap_kv_frac"], cache_dtype=getattr(torch, e["cache_dtype"]),
                        kv_buckets=e["kv_buckets"], strategy=cfg["strategy"])
    return arch, ecfg


def make_weights(cfg: dict, seed: int, device, dtype) -> dict:
    """Weights in the port's layout, drawn on the device from the seed in
    two calls, in the served type: the matrices at ``dit.init_params``'
    scales, the QK-norm gains 1 as there, and the adaLN bias as the file's
    ``init`` says (so that the gates open and every block's attention moves
    the latents)."""
    L, d, h, hd, ff = (cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["head_dim"],
                       cfg["d_ff"])
    drawn = [("blocks", "wq", (L, d, h * hd), d ** -0.5), ("blocks", "wk", (L, d, h * hd), d ** -0.5),
             ("blocks", "wv", (L, d, h * hd), d ** -0.5), ("blocks", "wo", (L, h * hd, d), d ** -0.5),
             ("blocks", "mlp_wi", (L, d, ff), d ** -0.5), ("blocks", "mlp_wo", (L, ff, d), ff ** -0.5),
             ("blocks", "adaln", (L, d, 6 * d), 0.02), (None, "t_mlp1", (256, d), 0.02),
             (None, "t_mlp2", (d, d), 0.02), (None, "final_mod", (d, 2 * d), 0.02),
             (None, "final_proj", (d, cfg["patch_dim"]), 0.02)]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(int(np.prod(s)) for _, _, s, _ in drawn), generator=g,
                       device=device, dtype=dtype)
    params: dict = {"blocks": {}}
    off = 0
    for group, name, shape, std in drawn:
        n = int(np.prod(shape))
        leaf = flat[off:off + n].view(shape).mul_(std)
        off += n
        (params["blocks"] if group else params)[name] = leaf
    params["blocks"].update(
        q_scale=torch.ones((L, hd), device=device, dtype=dtype),
        k_scale=torch.ones((L, hd), device=device, dtype=dtype),
        adaln_b=torch.randn((L, 6 * d), generator=g, device=device,
                            dtype=dtype).mul_(cfg["init"]["adaln_b_std"]))
    params["final_norm"] = torch.ones((d,), device=device, dtype=dtype)
    return params


def patch_embed(cfg: dict, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "patch_embed"))
    return torch.randn((cfg["patch_dim"], cfg["d_model"]), generator=g, device=device).mul_(0.2)


def request_inputs(cfg: dict, traffic: dict, seed: int, req: int, device):
    """Request ``req``'s noise latents and text embeddings (float32)."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "request", req))
    b = traffic["batch"]
    x0 = torch.randn((b, traffic["n_vision"], cfg["patch_dim"]), generator=g, device=device)
    text = torch.randn((b, cfg["n_text_tokens"], cfg["d_model"]), generator=g, device=device)
    return x0, text


def _warmup(arch, ecfg, cfg, traffic, params, pe, seed, device, dtype):
    """Two Update steps and a Dispatch step of the cell's own shapes and
    rules, through ``sample`` on a three-step schedule: the second Update
    takes the TaylorSeer difference, so every allocation the window makes
    is made once before it."""
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.core.schedule import MODE_DISPATCH, MODE_UPDATE, SparsitySchedule
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    full = resolve_schedule(ecfg, traffic["steps"], arch.n_layers, schedule=cfg["schedule"])
    modes = [MODE_UPDATE, MODE_UPDATE, MODE_DISPATCH]
    short = SparsitySchedule(mode=np.asarray(modes, np.int32),
                             strategy_ids=full.strategy_ids[:len(modes)].copy(),
                             strategies=full.strategies)
    x0, text = request_inputs(cfg, traffic, seed, -1, device)
    sample(params, arch, ecfg, text_emb=text, x0=x0, patch_embed=pe,
           scfg=SamplerConfig(num_steps=len(modes), dtype=dtype), trace=StepLog(),
           schedule=short)
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None) -> dict:
    """One run of a cell: set-up, the window, the metrics and the check.
    Returns the result line's dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(Path(root), workload)
    cfg, traffic, spec = c["config"], c["traffic"], c["spec"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    dtype = getattr(torch, cfg["dtype"])
    arch, ecfg = program_configs(cfg)
    params = make_weights(cfg, seed, device, dtype)
    pe = patch_embed(cfg, seed, device)
    _warmup(arch, ecfg, cfg, traffic, params, pe, seed, device, dtype)
    scfg = SamplerConfig(num_steps=traffic["steps"], dtype=dtype)

    calls = prof = None
    ctx = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels._region import listening
        from omnibench.trace import KernelCalls, annotated_dense_attention
        calls = KernelCalls()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        ctx = contextlib.ExitStack()
        for manager in (listening(calls), annotated_dense_attention(), prof):
            ctx.enter_context(manager)
    # The objects of the set-up never need collecting again: a collection
    # inside the window scans only what the window makes.
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    inputs = {}
    with ctx:
        with torch.autograd.profiler.record_function("omnibench.window"):
            t0 = time.perf_counter()
            log = StepLog(t0 + seconds)
            req = 0
            while True:
                inputs[req] = request_inputs(cfg, traffic, seed, req, device)
                log.request = req
                try:
                    sample(params, arch, ecfg, text_emb=inputs[req][1], x0=inputs[req][0],
                           patch_embed=pe, scfg=scfg, trace=log, schedule=cfg["schedule"])
                except WindowClosed:
                    break
                req += 1
    gc.unfreeze()
    window_s = log[-1]["end"] - t0
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    memory_peak = max(peak, setup_peak) if on_card else 0

    steps = list(log)
    kinds = [s["kind"] for s in steps]
    if "update" not in kinds or "dispatch" not in kinds:
        raise RuntimeError(f"the window of {window_s:.1f} s ran {kinds}: it needs an Update "
                           "and a Dispatch step")
    e = cfg["engine"]
    modes = step_modes(traffic["steps"], e["warmup_steps"], e["interval"])
    n_u, n_d = modes.count("update"), modes.count("dispatch")
    mean = lambda k: float(np.mean([s["seconds"] for s in steps if s["kind"] == k]))
    stepped = sum(s["seconds"] for s in steps)
    values = {
        # All of the window's time, shared out over its steps.
        "gen_s": (n_u * mean("update") + n_d * mean("dispatch")) * window_s / stepped,
        "peak_gb": peak / 1e9,
        "setup_s": setup_s,
    }
    run = types.SimpleNamespace(config=cfg, traffic=traffic, steps=steps, window_s=window_s,
                                card=torch.cuda.get_device_name(0) if on_card else "cpu",
                                dtype=cfg["dtype"], profile=None, calls=None)
    result_device = {"platform": "gpu" if on_card else "cpu", "kind": run.card, "count": 1,
                     "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        from omnibench.trace import read_profile
        run.calls = calls.resolved()
        run.profile = read_profile(prof) if on_card else None
        if run.profile is not None:
            result_device.update(busy_s=run.profile["busy_s"], window_s=run.profile["window_s"])
            breakdown = {"device_ops": run.profile["groups"][:10],
                         "idle_gaps": run.profile["gaps"][:10]}
        del prof
    if on_card:
        torch.cuda.empty_cache()

    # The metrics this run reports, by name and unit from BENCHMARK.json.
    metrics = {}
    section = spec["per_layer"] if trace else spec["end_to_end"]
    for m in section:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = metric_reader(c["folder"], m["name"])(run) if trace else values[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    verdict = check.judge(cfg, traffic, params, pe, inputs, log, c["limits"], seed)
    result = {"correct": verdict["correct"], "attempted": len(steps), "failed": 0,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["checks"]
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or the old benchmarks'."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
