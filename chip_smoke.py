#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FlashOmni on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints one JSON line; any failure exits non-zero without the
final line):

  1. build    — compile the CUDA kernels from ``src/repro_torch/csrc`` with
                nvcc and report the card's name and power limit;
  2. kernels  — GEMM-Q, CSR attention and GEMM-O at the flux-mmdit serving
                shapes (B=2, N=4608, 24 heads x 128, blocks 16/16/32, the
                plan built by the port from a seeded Q/K), in float32 and
                bfloat16: max error against the plain PyTorch version on the
                card, kernel / plain / library times (CUDA events) and the
                least time the card could take for the same work;
  3. small    — the sampler at the flux-mmdit smoke size on the card
                (kernels) against the same run on the CPU (plain versions);
  4. serve    — ``serve_diffusion`` on flux-mmdit at full width, 2 requests
                of 8 steps (steps 3, 4, 5 and 7 are Dispatch steps): finite
                outputs, and every kernel launched 38 layers x 4 steps x 2
                requests = 304 times;
  5. profile  — device time by kernel group within one Update and one
                Dispatch step at full width (torch.profiler), and the
                device's idle share.

Then the ``kernels`` line, the ``nvidia-smi`` name/power-limit line, and
the device line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_LAYERS, DISPATCH_STEPS, REQUESTS, STEPS = 38, 4, 2, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}       # rtol = atol per dtype
HBM_BYTES_S = 3.35e12
# Peak FLOP/s by card (NVIDIA data sheets, dense): f32 on the CUDA cores,
# bf16 on the tensor cores, and the memory rate.  The SXM figures are the
# default; other H100 variants are matched by name.
PEAKS = (
    ("PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "hbm": 2.0e12}),
    ("NVL", {"float32": 60e12, "bfloat16": 835e12, "hbm": 3.9e12}),
    ("", {"float32": 67e12, "bfloat16": 989e12, "hbm": HBM_BYTES_S}),
)
SOURCES = {
    "gemm_q_sparse_kernel": ("src/repro_torch/csrc/gemm_q.cu",
                             "src/repro/kernels/gemm_q.py:74"),
    "flashomni_attention_csr": ("src/repro_torch/csrc/flashomni_attention.cu",
                                "src/repro/kernels/flashomni_attention.py:117"),
    "gemm_o_sparse_kernel": ("src/repro_torch/csrc/gemm_o.cu",
                             "src/repro/kernels/gemm_o.py:82"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> dict:
    return next(p for key, p in PEAKS if key in name)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log = lib_path.parent / f"ptxas_{lib_path.stem.split('_')[-1]}.log"
    if log.exists():     # registers / shared memory / spills per kernel
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)
    emit({"phase": "build", "seconds": round(build_s, 3), "library": lib_path.name,
          "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else None})
    return smi[0] if smi else ""


def serving_plan(dev, b, h, n, dh, n_text):
    """The port's DispatchPlan for a seeded Q/K (B, H, N, dh)."""
    import torch
    from repro_torch.core.plan import build_dispatch_plan
    from repro_torch.core.strategy import FlashOmniStrategy, StrategyContext
    from repro_torch.launch.serve import serving_engine_config
    ecfg = serving_engine_config()
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    q = torch.randn((b, h, n, dh), generator=g, device=dev)
    k = torch.randn((b, h, n, dh), generator=g, device=dev)
    syms = FlashOmniStrategy().emit(q, k, StrategyContext(cfg=ecfg, n_text=n_text, n_tokens=n))
    row_score = torch.where(syms.m_c, syms.q_scores, 0.0).sum(dim=-2)
    return ecfg, build_dispatch_plan(syms.m_c, syms.m_s, ecfg, n, row_score=row_score).widen()


def check_close(name, dtype_name, got, want) -> float:
    import torch
    tol = TOL[dtype_name]
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        bad = int((err > tol + tol * want.float().abs()).sum())
        raise AssertionError(f"{name} [{dtype_name}] disagrees with its plain version: "
                             f"max abs err {max_err:.3e}, {bad} elements beyond {tol}")
    return max_err


# flux-mmdit serving shapes: batch, heads, tokens, head_dim, d_model, text tokens.
FULL = dict(b=2, h=24, n=4608, dh=128, d=3072, n_text=512)


def phase_kernels(gpu_name: str, dev: str = "cuda", b=2, h=24, n=4608, dh=128, d=3072,
                  n_text=512) -> dict:
    """Kernel vs plain vs library at the serving shapes; returns per-kernel rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (flashomni_attention_csr, gemm_o_sparse_kernel,
                                     gemm_q_sparse_kernel)
    from repro_torch.kernels.ref import attention_csr_ref, gemm_o_ref, gemm_q_ref
    dev = torch.device(dev)
    ecfg, plan = serving_plan(dev, b, h, n, dh, n_text)
    m = ecfg.mask
    pool, bq, bkv = m.pool, m.block_q, m.block_kv
    cr = plan.row_ids.shape[-1]
    cq, ckv = plan.kv_row_ids.shape[-2:]
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rnd = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev).mul_(std)
    x32, wq32 = rnd(b, n, d), rnd(d, h * dh, std=d ** -0.5)
    qc32 = rnd(b * h, cr * pool, dh)
    k32, v32, ore32 = rnd(b * h, n, dh), rnd(b * h, n, dh), rnd(b * h, n, dh)
    o32, wo32, bias32 = rnd(b, h, n, dh), rnd(h, dh, d, std=d ** -0.5), rnd(b, n, d)
    flat = lambda a: a.reshape(b * h, *a.shape[2:]).contiguous()
    q_ids, q_src, q_cnt = flat(plan.q_ids), flat(plan.q_slots), flat(plan.q_cnt)
    kv_ids, kv_cnt = flat(plan.kv_row_ids), flat(plan.kv_row_cnt)

    # Work this plan really needs (for the bounds).
    live_rows = int(plan.row_cnt.sum())
    slot_live = torch.arange(cq, device=dev) < q_cnt[:, None]
    kv_live_blocks = int(torch.where(slot_live, kv_cnt, 0).sum())
    live_slots = int(slot_live.sum())
    j_live = (torch.arange(ckv, device=dev) < kv_cnt[..., None]) & slot_live[..., None]
    t_kv = n // bkv
    union = torch.zeros((b * h, t_kv + 1), dtype=torch.bool, device=dev)
    union.scatter_(-1, torch.where(j_live, kv_ids.long(), t_kv).reshape(b * h, -1), True)
    kv_union_blocks = int(union[:, :t_kv].sum())
    live_heads = int(plan.head_cnt.sum())
    hmask = torch.zeros((b, cr, h + 1), dtype=torch.bool, device=dev)
    hmask.scatter_(-1, torch.where(torch.arange(h, device=dev) < plan.head_cnt[..., None],
                                   plan.head_ids.long(), h), True)
    heads_used = int(hmask[..., :h].any(dim=(0, 1)).sum())
    peaks = peaks_for(gpu_name)

    # Token mask of the plan over the compact Q rows for the SDPA yardstick
    # (rows of no live slot attend everywhere: dense work either way).
    tc = cr * pool // bq
    per_slot = torch.zeros((b * h, cq, t_kv + 1), dtype=torch.bool, device=dev)
    per_slot.scatter_(-1, torch.where(j_live, kv_ids.long(), t_kv), True)
    blk = torch.ones((b * h, tc + 1, t_kv + 1), dtype=torch.bool, device=dev)
    dst = torch.where(slot_live, q_src.long(), tc)       # dead slots -> trash row
    blk.scatter_(1, dst[..., None].expand(-1, -1, t_kv + 1), per_slot)
    sdpa_mask = blk[:, :tc, :t_kv].repeat_interleave(bq, dim=1) \
        .repeat_interleave(bkv, dim=2)[:, None]
    del blk, per_slot
    m_tok = torch.repeat_interleave(plan.m_ch, pool, dim=-2)[..., :n, :]

    rows = {}
    per_dtype = []
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        e = torch.finfo(dt).bits // 8
        x, wq = x32.to(dt), wq32.to(dt)
        qc, kk, vv, ore = qc32.to(dt), k32.to(dt), v32.to(dt), ore32.to(dt)
        o, wo, bias = o32.to(dt), wo32.to(dt), bias32.to(dt)
        calls = {
            "gemm_q_sparse_kernel": (
                lambda: gemm_q_sparse_kernel(x, wq, plan.row_ids, plan.row_cnt, block_rows=pool),
                lambda: gemm_q_ref(x, wq, plan.row_ids, plan.row_cnt, block=pool),
                lambda: torch.matmul(
                    x.reshape(b, n // pool, pool, d)[torch.arange(b, device=dev)[:, None],
                                                     plan.row_ids.long()], wq),
                2.0 * live_rows * pool * d * h * dh,
                e * (live_rows * pool * d + d * h * dh + b * cr * pool * h * dh) + 4 * (b * cr + b)),
            "flashomni_attention_csr": (
                lambda: flashomni_attention_csr(qc, kk, vv, ore, q_ids, q_src, q_cnt, kv_ids,
                                                kv_cnt, block_q=bq, block_kv=bkv),
                lambda: attention_csr_ref(qc, kk, vv, ore, q_ids, q_src, q_cnt, kv_ids,
                                          kv_cnt, block_q=bq, block_kv=bkv),
                lambda: F.scaled_dot_product_attention(qc[:, None], kk[:, None], vv[:, None],
                                                       attn_mask=sdpa_mask),
                4.0 * kv_live_blocks * bq * bkv * dh,
                e * (live_slots * bq * dh + 2 * kv_union_blocks * bkv * dh + 2 * b * h * n * dh)
                + 4 * (kv_live_blocks + 3 * live_slots)),
            "gemm_o_sparse_kernel": (
                lambda: gemm_o_sparse_kernel(o, wo, bias, plan.row_ids, plan.head_ids,
                                             plan.head_cnt, block_rows=pool),
                lambda: gemm_o_ref(o, wo, bias, plan.row_ids, plan.head_ids, plan.head_cnt,
                                   block=pool),
                lambda: torch.einsum("bnhd,hdf->bnf",
                                     torch.where(m_tok[..., None], o.transpose(1, 2), 0),
                                     wo) + bias,
                2.0 * live_heads * pool * dh * d,
                e * (live_heads * pool * dh + heads_used * dh * d + 2 * b * n * d)
                + 4 * (b * cr * (2 + h))),
        }
        for name, (kern, plain, library, flops, nbytes) in calls.items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            max_err = check_close(name, dn, got, want)
            del got, want
            t_op, t_mem = flops / peaks[dn] * 1e3, nbytes / peaks["hbm"] * 1e3
            row = {"name": name, "dtype": dn, "max_abs_err": max_err,
                   "ms": time_ms(kern, 10),
                   "plain_ms": time_ms(plain, 2, warmup=1),
                   "library_ms": time_ms(library, 5, warmup=1),
                   "bound_ms": max(t_op, t_mem),
                   "bound_by": "operations" if t_op >= t_mem else "bytes",
                   "flops": flops, "bytes": nbytes}
            per_dtype.append(row)
            if dt == torch.float32:         # the serving path's dtype
                rows[name] = row
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "shapes": {"B": b, "N": n, "heads": h, "head_dim": dh,
                                         "d_model": d, "pool": pool, "block_q": bq,
                                         "block_kv": bkv, "Cr": cr, "Cq": cq, "Ckv": ckv},
          "live": {"rows": live_rows, "q_slots": live_slots, "kv_blocks": kv_live_blocks,
                   "kv_union_blocks": kv_union_blocks, "row_heads": live_heads},
          "results": per_dtype})
    return rows


def phase_small():
    """Smoke-size sampler: kernels on the card vs plain versions on the CPU."""
    import torch
    from repro_torch.configs.registry import get_smoke
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    g = torch.Generator()
    g.manual_seed(7)
    params = dit.init_params(cfg, g, "cpu")
    pe = torch.randn((cfg.patch_dim, cfg.d_model), generator=g) * 0.2
    x0 = torch.randn((2, 96, cfg.patch_dim), generator=g)
    text = torch.randn((2, cfg.n_text_tokens, cfg.d_model), generator=g)
    outs, traces = {}, {}
    for dev in ("cpu", "cuda"):
        to = lambda t: t.to(dev)
        p = {k: ({kk: to(vv) for kk, vv in v.items()} if isinstance(v, dict) else to(v))
             for k, v in params.items()}
        traces[dev] = []
        outs[dev] = sample(p, cfg, ecfg, text_emb=to(text), x0=to(x0), patch_embed=to(pe),
                           scfg=SamplerConfig(num_steps=STEPS), trace=traces[dev]).cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    ok = torch.allclose(outs["cuda"], outs["cpu"], rtol=1e-3, atol=1e-4)
    same_trace = all(abs(a["density"] - c["density"]) < 1e-6
                     and abs(a["pair_sparsity"] - c["pair_sparsity"]) < 1e-6
                     for a, c in zip(traces["cpu"], traces["cuda"]))
    emit({"phase": "small", "max_abs_err": err, "ok": bool(ok and same_trace),
          "trace_matches": same_trace})
    if not (ok and same_trace):
        raise AssertionError(f"smoke sampler on the card disagrees with the CPU run "
                             f"(max abs err {err:.3e}, trace match {same_trace})")


def phase_serve() -> dict:
    import torch
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import serve_diffusion
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = serve_diffusion("flux-mmdit", smoke=False, n_vision=4096, batch=2,
                              num_requests=REQUESTS, num_steps=STEPS, device="cuda",
                              verbose=False)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    want = N_LAYERS * DISPATCH_STEPS * REQUESTS
    reqs = []
    for rid, r in sorted(results.items()):
        out = r["out"]
        dens = [s["density"] for s in r["trace"] if s["kind"] == "dispatch"]
        reqs.append({"rid": rid, "latency_s": r["latency"], "shape": list(out.shape),
                     "finite": bool(torch.isfinite(out).all()),
                     "mean_dispatch_density": sum(dens) / len(dens),
                     "kinds": [s["kind"] for s in r["trace"]]})
    emit({"phase": "serve", "arch": "flux-mmdit", "batch": 2, "n_tokens": 4608,
          "steps": STEPS, "wall_s": wall, "requests": reqs, "launches": launches,
          "expected_launches": want,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(r["finite"] and r["shape"] == [2, 4096, 64] for r in reqs):
        raise AssertionError("serve produced non-finite or misshapen latents")
    if any(v != want for v in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected {want} each")
    return launches


def _kernel_group(name: str) -> str:
    for key, group in (("gemm_q_kernel", "gemm_q_sparse_kernel"),
                       ("csr_attention_kernel", "flashomni_attention_csr"),
                       ("gemm_o_kernel", "gemm_o_sparse_kernel")):
        if key in name:
            return group
    lowered = name.lower()
    if "gemm" in lowered or "cutlass" in lowered or "xmma" in lowered:
        return "library GEMM (dense projections, MLP, dense attention)"
    if "sort" in lowered or "scan" in lowered or "radix" in lowered:
        return "sort/scan (plan build)"
    return "other (elementwise, reductions, copies)"


def phase_profile():
    """Device time by kernel within one Update and one Dispatch step at full width."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    dev = torch.device("cuda")
    cfg, ecfg = get_config("flux-mmdit"), serving_engine_config()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = dit.init_params(cfg, g, dev)
    b, nv = 2, 4096
    xe = torch.randn((b, nv, cfg.d_model), generator=g, device=dev)
    text = torch.randn((b, cfg.n_text_tokens, cfg.d_model), generator=g, device=dev)
    t = torch.full((b,), 0.5, device=dev)
    states = dit.init_engine_states(cfg, ecfg, b, nv + cfg.n_text_tokens, dev)
    report = {}
    for mode in ("update", "dispatch"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, new_states = dit.denoise_step(params, cfg, ecfg, states, xe, text, t,
                                             mode=mode, dtype=torch.float32)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if mode == "update":
            states = new_states
        groups, busy = {}, 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3
            busy += ms
            grp = groups.setdefault(_kernel_group(ev.key), {"ms": 0.0, "calls": 0})
            grp["ms"] += ms
            grp["calls"] += ev.count
        report[mode] = {"wall_ms": wall_ms, "device_busy_ms": busy or None,
                        "idle_share": (1 - busy / wall_ms) if busy else None,
                        "by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))}
    emit({"phase": "profile", "arch": "flux-mmdit", "batch": b,
          "n_tokens": nv + cfg.n_text_tokens, "layers": cfg.n_layers,
          "note": "one denoise step per mode under torch.profiler (profiler on)",
          **report})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = phase_build()
        rows = phase_kernels(torch.cuda.get_device_name(0), **FULL)
        phase_small()
        launches = phase_serve()
        phase_profile()
    except Exception:                     # report the failing phase, then fail
        traceback.print_exc()
        return 1
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"], "library_ms": rows[name]["library_ms"]}
        for name in SOURCES]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
