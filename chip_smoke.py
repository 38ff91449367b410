#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FlashOmni on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Twenty-three paths run, each with the launch counts set to 0 just before it
and read just after: T1 (training flux-mmdit at full width and 2 blocks,
the engine off: no kernel may launch), L-train (training gemma3-1b at full
width with remat on and off: no kernel), L1-L6 (the LMs gemma3-1b,
granite-moe-3b-a800m, mamba2-370m, recurrentgemma-2b, whisper-large-v3 and
llama-3.2-vision-11b served at full width: they reach no kernel, so none
may launch), long_context (the long-context sparse decode: no kernel),
sharding (the sharding modules on two ranks: no kernel), S2 (T1's
training step sharded over two ranks by ``launch/steps``: no kernel),
S2-moe (mixtral smoke's train step with its batch split over two ranks:
no kernel), S3
(a 2-block flux-mmdit denoise step sharded over two ranks, Update then
Dispatch: GEMM-Q, CSR attention, GEMM-O, counted in each rank), S4
(gemma3-1b's prefill and decode steps sharded over two ranks: no kernel),
S4-tp (S4 with the model axis split over the two ranks: no kernel), S5
(gemma3-1b trained at full width with the model axis split over two
ranks: no kernel), S3-tp (S3's cell with the model axis split over the
two ranks: GEMM-Q, CSR attention, GEMM-O on each rank's heads),
P1
(``flashomni``, uniform layout: GEMM-Q, CSR attention, GEMM-O), P2
(``sliding-window`` with ``kv_buckets=0``, which resolves to 2 buckets:
GEMM-Q, bucketed CSR attention, bucketed GEMM-O), ``ops`` (the
unified kernel entry on one full-width layer: the symbols attention and the
Taylor reuse, beside the other five), M1 (P1's request across a (1, 2)
mesh of two ranks on the card: GEMM-Q, CSR attention on each shard,
GEMM-O, counted in each rank), C1 (batched serving: GEMM-Q, CSR attention,
GEMM-O, in each of its three modes) and H1 (hunyuan-video-dit at the
paper's 33K tokens: GEMM-Q, CSR attention, GEMM-O).  Every dense baseline
run launches no kernel.

Phases (each prints one JSON line; any failure exits non-zero without the
final line):

  1. build    — compile the CUDA kernels from ``src/repro_torch/csrc`` with
                nvcc and report the card's name and power limit;
  2. kernels  — every kernel at the flux-mmdit serving shapes (B=2, N=4608,
                24 heads x 128, blocks 16/16/32), on plans the port builds
                from a seeded Q/K, in float32 and bfloat16: max error
                against the plain PyTorch version on the card (and the
                largest share of its tolerance an element uses), kernel /
                plain / library times (CUDA events), the least time the
                card could take for the same work (its FLOPs and bytes from
                ``analysis.cost_model.kernel_cost`` on the plan's live
                counts, ``plan_counts``) and, for the tensor-core
                kernels, the registers and spills of the instance that ran.
                GEMM-Q, CSR attention and GEMM-O run on a ``flashomni``
                plan, and the symbols attention on the same symbols (also
                held ``torch.equal`` to the CSR kernel on the lists of the
                same masks), the Taylor reuse on its cached blocks; the bucketed attention and
                GEMM-O on a ``sliding-window`` plan at 2 buckets and a
                ``hunyuan-1.5x`` interior plan at 3, each also held
                ``torch.equal`` to the uniform kernel fed the same plan's
                clamped counts;
  3. small    — samplers at smoke size on the card (kernels) against the
                same runs on the CPU (plain versions): P1; the hunyuan-1.5x
                schedule at 3 buckets on a 4-head smoke variant;
                sliding-window at ``kv_buckets=0`` with 480 vision tokens;
                ``cache-all``; the ``step-ramp`` schedule; and
                ``step-phased`` with a fractional boundary;
  4. analysis — the invariant analyzer on the card: ``run_analysis`` at its
                geometry (dispatch purity with every kernel region present,
                promotion, cost certificates, plan validator, source lint;
                zero findings), the plan validator on the seeded plans of the
                ``kernels`` cell (1-3 buckets) and of ``kernels_33k``, on the
                38 plans of one full-width flux-mmdit Update step built with
                ``validate_plans=True``, and the six smoke samplers again with
                the hook on; the findings (any fails) and the seconds;
  5. train    — the training path (``repro_torch.launch.train``): the
                dense attention's grad branch at one full-width layer (B 1,
                24 heads, 4608 tokens, f32) against autograd of the
                unchunked attention (dq, dk, dv within 1e-4; its forward
                within rel-L2 1e-6 of the no-grad body); flux-smoke trained
                6 steps on the card and on the CPU from the same weights,
                with no compression, int8 and top-k (loss and gradient norm
                within 1e-4 relative at every step); then T1: flux-mmdit at
                every published width and 2 of 38 blocks, batch 1, 4096 +
                512 tokens, AdamW, 6 steps, a checkpoint every 3 (keep 1) and
                a node failure injected at step 4: finite losses, one
                restart, step 3 bit-equal before and after it, no kernel
                launched; parameters, step seconds (loss and gradients,
                update), checkpoint bytes and seconds, restore seconds, peak
                memory; then L-train: gemma3-1b as published (26 layers,
                d_model 1152, vocab 262 144, ``remat=True``), one step at
                batch 1 and 4096 tokens through ``make_step_fn`` with remat
                on and off on the same weights and batch (a warm-up, then
                the median of 3): step seconds, peak memory, the loss, and
                the loss and gradients of the two within 1e-5 of the largest
                magnitude; no kernel launched;
  6. lm       — the LM families (``models/transformer``, ``ssm``,
                ``rglru``, ``encdec``, ``vision``; ``launch/serve.serve_lm``):
                their ten smoke configs on the card and on the CPU from the
                same weights (forward logits on 80 tokens, 40 decode steps
                that wrap the 32-slot rings, prefill, with the stub frames
                or patches where the family takes them; each within 1e-4 of
                the CPU relative to the largest magnitude); then six
                published configs at full width in f32: L1 gemma3-1b (26
                layers, d_model 1152, vocab 262 144, window 512), L2
                granite-moe-3b-a800m (32 layers, 40 experts top-8), L3
                mamba2-370m (48 SSD layers), L4 recurrentgemma-2b (26
                layers, window 2048), L5 whisper-large-v3 (32 + 32 layers,
                1500 frames) and L6 llama-3.2-vision-11b (40 layers, 8 gated
                cross-attention, 1600 patches): ``serve_lm`` at the
                reference's defaults (greedy tokens), ms a decode token
                (median of 10), device-busy ms, idle share and aten ops a
                step, one prefill (4096 tokens; L5 1500 frames + 448
                tokens; L6 2048 tokens + 1600 patches: seconds, tokens/s,
                finite logits), peak memory, and for L1, L3 and L4 decode's
                logits at positions 0-19 against ``forward``'s within 1e-4;
                B1-B7 launched 0 times on all six;
  7. long_context — ``repro_torch.long_context_lm`` (top-k KV blocks by
                pooled keys at decode): the example's size on the card and
                on the CPU (block ids and counts equal, outputs within 1e-5
                of the largest magnitude), then 524 288 tokens at gemma3-1b's
                attention geometry (4 query heads x 256, K and V 2.15 GB
                each): the error against dense attention, selection, sparse
                and dense decode ms (median of 20), the KV bytes each reads,
                the peak; no kernel launched;
  8. serve    — P1: ``serve_diffusion`` on flux-mmdit at full width, 1
                request of 8 steps (steps 3, 4, 5 and 7 are Dispatch
                steps): finite outputs, and GEMM-Q, CSR attention and GEMM-O
                each launched 38 layers x 4 steps = 152 times;
  9. serve_bucketed — P2 at full width, 1 request of 8 steps: GEMM-Q and the
                two bucketed kernels each launched 38 x 4 = 152 times, the
                uniform attention and GEMM-O never; latency, density, peak
                memory, and the share of live KV blocks and live (row, head)
                pairs the buckets dropped at one interior layer's last plan;
 10. ops      — ``python -m repro_torch.quickstart --full`` on the card: one
                Update and one Dispatch of a flux-mmdit-width attention
                layer, then every ``repro_torch.kernels.ops`` entry on the
                layer's own symbols (symbols attention bit-equal to CSR, both
                against the mask oracle, 2-bucket attention against its plain
                version, Taylor reuse against the layer's forecast); the
                symbols attention and the Taylor reuse must launch;
 11. twin     — one flux-width Dispatch layer under the kernels and under
                the structural twin (``backend="torch"``, no kernel) on three
                plans (union layout at ``cap_kv = T_kv``, sliding-window at 2
                buckets, per-row layout at ``cap_kv < T_kv``): the largest
                difference and its share of the float32 tolerance, with the
                rows of empty KV lists zeroed, and both times;
 12. rope     — the engine's RoPE (``rope_freqs``, ``freqs=``) at the flux
                shapes, three cases: bias mode uniform (GEMM-Q, CSR
                attention, GEMM-O), bias mode sliding-window at 2 buckets
                (GEMM-Q, the bucketed pair), ``o_cache`` mode uniform
                (GEMM-Q, CSR attention).  Each: two Update layers with
                ``freqs`` at ``cap_q_frac`` 0.75 build a plan from the
                rotated Q/K (sparse, not empty), then one Dispatch layer
                with ``freqs`` under the kernels (compact GEMM-Q rows
                rotated at their original positions; the case's kernels
                launched once each, no other) and under the twin, within
                the float32 tolerance with the rows of empty KV lists
                zeroed; the kernels' layer without ``freqs`` differs by
                more than 100x the tolerance (rel-L2); both layer times;
 13. mesh     — plan-sharded Dispatch, every rank a process of its own on
                the card over ``gloo`` (the kernels built before any rank
                starts).  The layer cell: one flux-width Dispatch layer (B 2)
                on mesh (2, 4), seq mode with flashomni at 3 buckets and
                pair slack 0.5 (the clamp binds), head mode; each
                ``torch.equal`` to the single-device Dispatch on every
                rank, B2 launched on every rank and its call at the shard's
                shapes (Q compact and replicated, K/V the exchange buffer,
                ``o_reuse`` the token shard) against its plain version on
                the same card tensors, the a2a payload, the live blocks sent
                and the dense all-gather's (blocks and bytes), peaks per
                rank.  M1: P1's request through ``serve_diffusion(mesh=(1,
                2))`` on two ranks: every integer plan field equal to P1's,
                latents within rel-L2 1e-6 of P1's, B1-B3 launched 152 times
                on each rank, B2's first call on each rank against its plain
                version, latency beside P1's (not a speed number);
 14. sharding — ``distributed/{sharding, collective_matmul}`` and
                ``runtime/elastic`` on two ``gloo`` ranks sharing the card:
                ``ag_matmul_overlapped`` at flux width (x (1, 4608, 3072) split
                on tokens, w (3072, 3072)) within 1e-4 of one rank's product,
                its ms beside an all_gather followed by the product;
                ``reshard_state`` of T1's 2-block flux-mmdit parameters (1.48
                GB) over a (2, 1) mesh and onto ``shrink_mesh``'s (1, 1):
                ``torch.equal`` to the unsharded tensors; no kernel launched.
                Then the step builders (``launch/steps``) in the same world:
                S2, T1 sharded (FSDP, batch 2, 2 steps, f32): loss and
                grad_norm within 1e-4 relative of ``make_step_fn``'s
                unsharded step at every step, the parameters within 1e-4 of
                their largest magnitude, the step's seconds split into
                gather, loss and gradients, scatter and update, the bytes
                each rank copied from the other (the two share the card and
                map each other's tensors), the peak a rank; no kernel
                launched.  S3, ``build_dit_step`` on the same 2-block model
                at P1's engine config, batch 2, Update then Dispatch: each
                rank's ``v`` and integer state fields ``torch.equal`` to its
                batch-1 slice run alone, rel-L2 3e-4 against the batch-2
                step, B1-B3 launched twice a rank at Dispatch and never at
                Update, B2's first call against its plain version.  S4,
                gemma3-1b at full width in bf16, batch 2: the prefill
                builder on 256 tokens, then 4 greedy steps of the decode
                builder: tokens equal to the unsharded model's, logits
                within 2e-2 of their largest magnitude; no kernel.  S4-tp,
                S4 on mesh (1, 2): the model axis split, held as S4 is.
                S5, gemma3-1b at full width (26 layers, f32, remat on),
                1 x 4096 tokens, one train step on mesh (1, 2) with the
                model axis split: loss, grad_norm and every gradient
                (AdamW's first moment) within 1e-4 of the unsharded step,
                run first in this process and kept on the host; step s by
                part, peer bytes, peak a rank; no kernel.  S2-moe,
                mixtral-8x22b smoke trained one step on mesh (2, 1), its
                batch split over data, so the MoE routes the global batch
                across the ranks: loss, grad_norm and parameters within
                1e-4 of the unsharded step; no kernel.  S3-tp, S3's cell
                on mesh (1, 2), the model row split (12 of 24 heads a
                rank): the symbols and integer plan fields ``torch.equal``
                to the unsharded batch-2 step's (else a witness: the first
                differing field must follow a Q/K difference), ``v``
                within rel-L2 1e-4, B1-B3 once a layer a rank at Dispatch
                and never at Update, nothing computed replicated, B3's
                first call over its head range against its plain version
                and the two ranks' B3 partials summed against one B3 over
                every head (1e-4); Update and Dispatch seconds, row
                collectives a step, ``max_gathered_bytes``, peak a rank.
                Every step gathers one block at a time
                (``max_gathered_bytes``);
                S2's and S3's peaks are printed beside 14.35 / 6.68 GB,
                their peaks when every leaf was gathered whole;
 15. dense    — P1's request under ``force_dense`` on the same weights and
                noise (no kernel launches): P1's and P2's speedup over it and
                their relative L2 / PSNR against its latents; then P1 and
                the dense run in bfloat16;
 16. serve_batched — C1: flux-mmdit at full width, 3 requests of batch 1 at
                t = 0 with 8 and 6 steps in turn, served sequentially,
                stacked and by the continuous batcher (2 lanes,
                ``grouped="auto"``: grouped and scan ticks both run):
                requests per second, p50 / p95 latency, peak memory, each
                request's rel-L2 / PSNR and differing plan fields against
                its sequential run (rel-L2 at most 3e-4), launches equal to
                layers x Dispatch calls; then the stacking witness: the
                stacked 8-step group and its requests alone in lockstep up
                to the first step whose plans differ, with the Q/K and
                library-GEMM differences there;
 17. hunyuan  — H1: ``serve_diffusion`` on hunyuan-video-dit at full width
                (48 blocks, B=1, 256 + 32 768 tokens), ``hunyuan-1.5x``,
                uniform layout, float32, 8 steps (3-5 and 7 Dispatch):
                GEMM-Q, CSR attention and GEMM-O each launched 48 x 4 = 192
                times, the others never; then its dense run on the same
                inputs: latency, step seconds, peak memory, speedup, rel-L2
                / PSNR against dense, and the 50-step projection;
 18. kernels_33k — GEMM-Q, CSR attention and GEMM-O on a ``flashomni`` plan
                and the bucketed pair on the ``hunyuan-1.5x`` interior plan
                at 3 buckets, at H1's shapes (B=1, N=33 024) in float32;
 19. profile  — device time by kernel group within one Update and one
                Dispatch step of P1 at full width (torch.profiler; the
                chunked dense attention as its
                own group), and the device's idle share; dispatch purity on
                the card: no Dispatch step may launch a sort or top-k kernel,
                every Update step must launch one (scans are reported);
 20. dryrun   — ``launch/dryrun`` in a process of its own on the host,
                started before H1 (it needs nothing of the card): the
                step builders' steps traced on ``meta`` tensors over a fake
                world and costed (no card, no kernel launched), each
                prediction beside this run's measurement: T1's peak (world
                1) against T1's, its FLOPs over T1's step as a share of the
                f32 peak, S2's peak a rank and wire bytes a step (world 2,
                mesh (2, 1)) against S2's peak and the bytes a rank copied
                from its peer, S3's Dispatch holding B1-B3 once a layer at
                capacity as S3 launched them, S5's and S3-tp's Dispatch
                peak a rank (world 2, mesh (1, 2)) against S5's and
                S3-tp's (each prediction within 2x of its measurement); then the planning cell, flux-mmdit at all
                38 blocks trained as T1 is, FSDP over 4 ranks, batch 1 a
                rank: its peak a rank and whether it fits 80 GB.

Then the script's seconds (``total``), the ``kernels`` line, the
``nvidia-smi`` name/power-limit line, and the device line last.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REQUESTS, STEPS, DEVICE = 1, 8, "cuda"
# The served cells: flux-mmdit (P1, P2 and their dense run) and H1, the
# paper's 33K HunyuanVideo cell (256 text + 32 768 vision tokens).
FLUX = dict(arch="flux-mmdit", batch=2, n_vision=4096)
H1 = dict(arch="hunyuan-video-dit", batch=1, n_vision=32768)
# H1 runs P1's 8 steps (a dense or Update step takes 40-47 s at this width
# on one H100 at 700 W, PERF.md section 5).
H1_STEPS = STEPS
# Every served path at 8 steps: steps 0-2 and 6 Update, 3-5 and 7 Dispatch.
# Held against the resolved schedule, so that a schedule fault that drops
# Dispatch steps cannot lower the launches expected of it.
DISPATCH_STEPS = 4
# The profile runs P1 alone.  It ran H1 at 4 of its 48 blocks until the
# sharding phase's step builders needed the time, and at 12 blocks with P2
# as well before that (their last breakdowns: PERF.md section 5).
# C1, the batched-serving cell: flux-mmdit at full width, requests of batch
# 1 arriving together with steps alternating 8 and 6, served sequentially,
# stacked and by the continuous batcher; every request held to its own
# sequential run within C1_REL_L2: 2.5x the largest reading on one H100 at
# 700 W (stacked, 1.19e-4, the same in three runs; PERF.md section 5), 22x
# under what sparsity itself costs against dense (6.5e-3).  Cut from 6
# requests on 4 lanes to 4 on 3 lanes to make room for the mesh phase, and
# to 3 on 2 lanes to make room for the LM paths L3-L6, within the script's
# time limit (the last request refills a lane, so grouped and scan ticks
# both still run, and the 8-step stacked group still holds two requests).
C1 = dict(arch="flux-mmdit", batch=1, n_vision=4096, requests=3, lanes=2)
C1_REL_L2 = 3e-4
# The stacking witness steps C1's 8-step stacked group (batch 2) and each
# of its requests alone (batch 1) in lockstep through at most this many
# steps (0-2 Update, 3 Dispatch), stopping after the first step whose plans
# differ.  Step 0 is an Update step, whose output no plan shapes, so its
# latents differ only by the rounding of the batch's library GEMMs: within
# WITNESS_STEP0_REL_L2 of the lone runs (6.4x the 1.56e-7 read on one H100
# at 700 W); a fault that mixed samples would lie far beyond.
WITNESS_STEPS = 4
WITNESS_STEP0_REL_L2 = 1e-6
# H1's kernel shapes: batch, heads, tokens, head_dim, d_model, text tokens.
H1_SHAPE = dict(b=1, h=24, n=33024, dh=128, d=3072, n_text=256)
# The SDPA yardstick of the attention rows runs only where its token mask
# fits this many bytes (at H1's shapes it would take 19.6 GB).
SDPA_MASK_BYTES = 8e9
P1_KERNELS = ("gemm_q_sparse_kernel", "flashomni_attention_csr", "gemm_o_sparse_kernel")
P2_KERNELS = ("gemm_q_sparse_kernel", "flashomni_attention_csr_bucketed",
              "gemm_o_sparse_bucketed_kernel")
OPS_KERNELS = ("flashomni_attention_symbols", "taylor_reuse_kernel")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}       # rtol = atol per dtype
HBM_BYTES_S = 3.35e12
# Peak FLOP/s by card (NVIDIA data sheets, dense): f32 on the CUDA cores,
# bf16 and TF32 on the tensor cores, and the memory rate.  The SXM figures
# are the default; other H100 variants are matched by name.
PEAKS = (
    ("PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "tf32": 378e12, "hbm": 2.0e12}),
    ("NVL", {"float32": 60e12, "bfloat16": 835e12, "tf32": 417.5e12, "hbm": 3.9e12}),
    ("", {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12, "hbm": HBM_BYTES_S}),
)
# The attention kernels: they count their grouped walk on the card
# (kernels.flashomni_attention.count_walk).
ATTENTION = ("flashomni_attention_csr", "flashomni_attention_csr_bucketed",
             "flashomni_attention_symbols")
GEMMS = ("gemm_q_sparse_kernel", "gemm_o_sparse_kernel", "gemm_o_sparse_bucketed_kernel")
# The kernels whose f32 instance runs on the tensor cores in 3xTF32 (three
# TF32 products per f32 product): their f32 bound is 3 * FLOPs over the TF32
# peak.
TF32X3 = ATTENTION + GEMMS
SOURCES = {
    "gemm_q_sparse_kernel": ("src/repro_torch/csrc/gemm_q.cu",
                             "src/repro/kernels/gemm_q.py:74"),
    "flashomni_attention_csr": ("src/repro_torch/csrc/flashomni_attention.cu",
                                "src/repro/kernels/flashomni_attention.py:117"),
    "gemm_o_sparse_kernel": ("src/repro_torch/csrc/gemm_o.cu",
                             "src/repro/kernels/gemm_o.py:82"),
    "flashomni_attention_csr_bucketed": ("src/repro_torch/csrc/flashomni_attention_bucketed.cu",
                                         "src/repro/kernels/flashomni_attention.py:240"),
    "gemm_o_sparse_bucketed_kernel": ("src/repro_torch/csrc/gemm_o.cu",
                                      "src/repro/kernels/gemm_o.py:178"),
    "flashomni_attention_symbols": ("src/repro_torch/csrc/flashomni_attention_symbols.cu",
                                    "src/repro/kernels/flashomni_attention.py:399"),
    "taylor_reuse_kernel": ("src/repro_torch/csrc/taylor_reuse.cu",
                            "src/repro/kernels/taylor_reuse.py:33"),
}
# The one PyTorch call each kernel is timed against (library_ms).
LIBRARY = {
    "gemm_q_sparse_kernel": "row gather + torch.matmul",
    "flashomni_attention_csr": "scaled_dot_product_attention, plan token mask",
    "gemm_o_sparse_kernel": "masked torch.einsum + bias",
    "flashomni_attention_csr_bucketed": "scaled_dot_product_attention, plan token mask",
    "gemm_o_sparse_bucketed_kernel": "masked torch.einsum + bias",
    "flashomni_attention_symbols": "scaled_dot_product_attention, symbols token mask",
    "taylor_reuse_kernel": "torch.tensordot + torch.where (two calls)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(run, /, *args, **kw):
    """``run(*args, **kw)``, its seconds written to stderr."""
    t0 = time.perf_counter()
    out = run(*args, **kw)
    print(f"chip_smoke: {kw.get('phase', run.__name__)} took "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


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


def ptxas_log(lib_path: Path) -> Path:
    """The build's ``ptxas -v`` report beside its library."""
    return lib_path.parent / f"ptxas_{lib_path.stem.split('_')[-1]}.log"


def ptxas_usage() -> dict:
    """Registers and spill bytes (stores plus loads) of every built kernel
    instance (mangled name), read from the build's ``ptxas -v`` report."""
    from repro_torch.kernels import _build
    log = ptxas_log(_build.build())
    usage, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else ()):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {"registers": None, "spill_bytes": 0}
        elif name and "spill stores" in line:
            usage[name]["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def serving_instance(name, dn) -> str:
    """The mangled-name stem of the template instance a kernel row runs:
    the 16-byte staging path of a GEMM, head_dim 128 with 16-row KV blocks of
    an attention kernel."""
    kernel = next(key for key, group in KERNEL_GROUPS if group == name)
    t = "f" if dn == "float32" else "13__nv_bfloat16"
    return f"{kernel}I{t}" + ("Lb1E" if name in GEMMS else "Li128ELi16E")


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
    log = ptxas_log(lib_path)
    if log.exists():     # registers / shared memory / spills per kernel instance
        for line in log.read_text().splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)
    emit({"phase": "build", "seconds": round(build_s, 3), "library": lib_path.name,
          "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else None})
    return smi[0] if smi else ""


def serving_plan(dev, b, h, n, dh, n_text, strategy=None, kv_buckets=1, widen=True,
                 **cfg_kw):
    """``(ecfg, symbols, plan)``: the SymbolSet and the port's DispatchPlan
    (ids widened unless ``widen`` is False) for a seeded Q/K (B, H, N, dh)
    under ``strategy`` (default: flashomni) at ``kv_buckets``; ``cfg_kw``
    overrides fields of the serving engine config."""
    import torch
    from repro_torch.core.plan import build_dispatch_plan
    from repro_torch.core.strategy import FlashOmniStrategy, StrategyContext
    from repro_torch.launch.serve import serving_engine_config
    ecfg = dataclasses.replace(serving_engine_config(kv_buckets=kv_buckets), **cfg_kw)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    q = torch.randn((b, h, n, dh), generator=g, device=dev)
    k = torch.randn((b, h, n, dh), generator=g, device=dev)
    syms = (strategy or FlashOmniStrategy()).emit(
        q, k, StrategyContext(cfg=ecfg, n_text=n_text, n_tokens=n))
    row_score = torch.where(syms.m_c, syms.q_scores, 0.0).sum(dim=-2)
    plan = build_dispatch_plan(syms.m_c, syms.m_s, ecfg, n, row_score=row_score)
    return ecfg, syms, plan.widen() if widen else plan


def check_close(name, dtype_name, got, want) -> tuple[float, float]:
    """Max abs error, and the largest share of its allowance (atol + rtol *
    |want|) any element uses; fails beyond 1."""
    tol = TOL[dtype_name]
    err = (got.float() - want.float()).abs()
    share = err / (tol + tol * want.float().abs())
    max_err, max_share = float(err.max()), float(share.max())
    if not max_share <= 1:                # NaN fails too
        bad = int((share > 1).sum())
        raise AssertionError(f"{name} [{dtype_name}] disagrees with its plain version: "
                             f"max abs err {max_err:.3e}, {bad} elements beyond {tol}")
    return max_err, max_share


# flux-mmdit serving shapes: batch, heads, tokens, head_dim, d_model, text tokens.
FULL = dict(b=2, h=24, n=4608, dh=128, d=3072, n_text=512)


def plan_work(plan, ecfg, b, h, n):
    """What a plan's clamped lists really need: its live counts
    (``analysis.cost_model.plan_counts``, what every bound is billed at),
    the flat (B·H) lists of the uniform attention, the token mask of the
    attention yardstick (None where it would exceed ``SDPA_MASK_BYTES``)
    and the (B, N, H) head mask of the GEMM-O yardstick."""
    import torch
    from repro_torch.analysis.cost_model import plan_counts
    dev = plan.q_ids.device
    m = ecfg.mask
    pool, bq, bkv = m.pool, m.block_q, m.block_kv
    cr = plan.row_ids.shape[-1]
    cq, ckv = plan.kv_row_ids.shape[-2:]
    flat = lambda a: a.reshape(b * h, *a.shape[2:]).contiguous()
    q_ids, q_src, q_cnt = flat(plan.q_ids), flat(plan.q_slots), flat(plan.q_cnt)
    kv_ids, kv_cnt = flat(plan.kv_row_ids), flat(plan.kv_row_cnt)
    t_kv = n // bkv
    # Token mask of the plan over the compact Q rows for the SDPA yardstick
    # (rows of no live slot attend everywhere: dense work either way).
    tc = cr * pool // bq
    sdpa_mask = None
    if b * h * tc * bq * n <= SDPA_MASK_BYTES:
        slot_live = torch.arange(cq, device=dev) < q_cnt[:, None]
        j_live = (torch.arange(ckv, device=dev) < kv_cnt[..., None]) & slot_live[..., None]
        per_slot = torch.zeros((b * h, cq, t_kv + 1), dtype=torch.bool, device=dev)
        per_slot.scatter_(-1, torch.where(j_live, kv_ids.long(), t_kv), True)
        blk = torch.ones((b * h, tc + 1, t_kv + 1), dtype=torch.bool, device=dev)
        dst = torch.where(slot_live, q_src.long(), tc)       # dead slots -> trash row
        blk.scatter_(1, dst[..., None].expand(-1, -1, t_kv + 1), per_slot)
        sdpa_mask = blk[:, :tc, :t_kv].repeat_interleave(bq, dim=1) \
            .repeat_interleave(bkv, dim=2)[:, None]
        del blk, per_slot
    # The clamped (row, head) mask in token layout.
    t = m.n_blocks(n)
    rows = torch.zeros((b, t + 1, h), dtype=torch.bool, device=dev)
    rsel = torch.where(torch.arange(cr, device=dev) < plan.row_cnt[:, None],
                       plan.row_ids.long(), t)
    rows.scatter_(1, rsel[..., None].expand(-1, -1, h), plan.head_mask)
    m_tok = torch.repeat_interleave(rows[:, :t], pool, dim=1)[:, :n]
    return dict(
        flat=dict(q_ids=q_ids, q_src=q_src, q_cnt=q_cnt, kv_ids=kv_ids, kv_cnt=kv_cnt),
        counts=plan_counts(plan, ecfg, b, h, n), sdpa_mask=sdpa_mask,
        sdpa_mask_bytes=b * h * tc * bq * n, m_tok=m_tok)


def measure(name, dn, kern, plain, library, counts, peaks, twin=None,
            iters=10) -> dict:
    """Kernel vs plain version (and, for a bucketed or the symbols kernel,
    ``torch.equal`` to its uniform CSR twin on the same lists, and the twin's
    time), then kernel / plain / library times (``library`` None: no library
    call fits on the card at these shapes).  The bound is billed by
    ``analysis.cost_model.kernel_cost`` on the work ``counts`` describes."""
    import torch
    from repro_torch.analysis.cost_model import kernel_cost
    cost = kernel_cost(name, counts, dn)
    flops, nbytes = cost.flops, cost.hbm_bytes
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    max_err, tol_share = check_close(name, dn, got, want)
    row = {"name": name, "dtype": dn, "max_abs_err": max_err, "tol_share": tol_share}
    if twin is not None:
        row["equal_to_uniform"] = bool(torch.equal(got, twin()))
        if not row["equal_to_uniform"]:
            raise AssertionError(f"{name} [{dn}] differs from the uniform kernel on the "
                                 "same lists")
    del got, want
    x3 = name in TF32X3 and dn == "float32"
    t_op = (3 * flops / peaks["tf32"] if x3 else flops / peaks[dn]) * 1e3
    t_mem = nbytes / peaks["hbm"] * 1e3
    if twin is not None:        # the uniform kernel's time on the same plan
        row["uniform_ms"] = time_ms(twin, iters)
    row.update({"ms": time_ms(kern, iters),
                # warm already: ``want`` above was its first call
                "plain_ms": time_ms(plain, max(1, iters // 5), warmup=0),
                "library_ms": (time_ms(library, max(1, iters // 2), warmup=1)
                               if library is not None else None),
                "bound_ms": max(t_op, t_mem),
                "bound_by": "operations" if t_op >= t_mem else "bytes",
                "flops": flops, "bytes": nbytes})
    torch.cuda.empty_cache()
    return row


def walk_counts(name, dn, kern, flops, bkv, dh) -> dict:
    """The KV blocks an attention kernel's block walks staged and the
    (16-row warp, KV block) updates its warps made, counted on the card in
    a launch of its own; the updates must be the work its bound counts."""
    import torch
    from repro_torch.kernels.flashomni_attention import count_walk
    with count_walk(torch.cuda.current_device()) as counts:
        kern()
        staged, updates = counts.tolist()
    if updates * 4 * 16 * bkv * dh != flops:
        raise AssertionError(f"{name} [{dn}]: {updates} warp updates on the card, "
                             f"{flops / (4 * 16 * bkv * dh):.0f} in its lists")
    return {"kv_staged_blocks": staged, "kv_warp_updates": updates}


def phase_kernels(gpu_name: str, dev: str = "cuda", b=2, h=24, n=4608, dh=128, d=3072,
                  n_text=512, *, plans=("flashomni", "sliding-window", "hunyuan-1.5x interior"),
                  dtypes=("float32", "bfloat16"), with_ops=True, iters=10,
                  phase="kernels") -> dict:
    """Kernel vs plain vs library at the serving shapes, on the named
    ``plans`` in ``dtypes`` (``with_ops``: the symbols attention and the
    Taylor reuse on the flashomni symbols too), ``iters`` timed launches a
    kernel; returns the float32 row of every kernel (the serving dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as TK
    from repro_torch.core.plan import bucket_geometry
    from repro_torch.core.strategy import MultiGranularityStrategy, SlidingWindowStrategy
    from repro_torch.kernels import ref
    dev = torch.device(dev)
    peaks = peaks_for(gpu_name)
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rnd = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev).mul_(std)
    x32, wq32 = rnd(b, n, d), rnd(d, h * dh, std=d ** -0.5)
    k32, v32, ore32 = rnd(b * h, n, dh), rnd(b * h, n, dh), rnd(b * h, n, dh)
    o32, wo32, bias32 = rnd(b, h, n, dh), rnd(h, dh, d, std=d ** -0.5), rnd(b, n, d)

    # The uniform kernels on a flashomni plan; the bucketed ones on the
    # sliding-window plan of the P2 path (2 buckets, the kernels line) and on
    # the hunyuan-1.5x interior template (3 buckets).
    cases = [("flashomni", None, 1, P1_KERNELS),
             ("sliding-window", SlidingWindowStrategy(), 2, P2_KERNELS[1:]),
             ("hunyuan-1.5x interior", MultiGranularityStrategy(
                 children=("flashomni", "skip-only", "sliding-window"), head_assign=(0, 0, 2)),
              3, P2_KERNELS[1:])]
    cases = [case for case in cases if case[0] in plans]
    usage = ptxas_usage()
    rows, results, plans = {}, [], []
    for label, strategy, kb, names in cases:
        ecfg, syms, plan = serving_plan(dev, b, h, n, dh, n_text, strategy, kb)
        m = ecfg.mask
        pool, bq, bkv = m.pool, m.block_q, m.block_kv
        spec = ecfg.caps(n)
        cr = plan.row_ids.shape[-1]
        w = plan_work(plan, ecfg, b, h, n)
        fl = w["flat"]
        qc32 = rnd(b * h, cr * pool, dh)
        plans.append({"plan": label, "kv_buckets": kb, "Cr": cr,
                      "Cq": plan.kv_row_ids.shape[-2], "Ckv": plan.kv_row_ids.shape[-1],
                      **({"geometry": bucket_geometry(spec.cap_q, spec.cap_kv, h, kb),
                          "geometry_o": bucket_geometry(cr, h, 1, kb)} if kb > 1 else {}),
                      **{key: w["counts"][key] for key in (
                          "live_rows", "live_slots", "kv_live_blocks", "kv_union_blocks",
                          "live_heads")}})
        # The work each kernel's bound is billed at (analysis.cost_model.kernel_cost).
        gq_counts = dict(w["counts"], k=d, f=h * dh)
        attn_counts = dict(w["counts"], dh=dh)
        go_counts = dict(w["counts"], dh=dh, f=d)
        for dn in dtypes:
            dt = getattr(torch, dn)
            x, wq = x32.to(dt), wq32.to(dt)
            qc, kk, vv, ore = qc32.to(dt), k32.to(dt), v32.to(dt), ore32.to(dt)
            o, wo, bias = o32.to(dt), wo32.to(dt), bias32.to(dt)
            uni_attn = lambda: TK.flashomni_attention_csr(
                qc, kk, vv, ore, fl["q_ids"], fl["q_src"], fl["q_cnt"], fl["kv_ids"],
                fl["kv_cnt"], block_q=bq, block_kv=bkv)
            uni_gemm_o = lambda: TK.gemm_o_sparse_kernel(o, wo, bias, plan.row_ids,
                                                         plan.head_ids, plan.head_cnt,
                                                         block_rows=pool)
            sdpa = None if w["sdpa_mask"] is None else (
                lambda: F.scaled_dot_product_attention(qc[:, None], kk[:, None], vv[:, None],
                                                       attn_mask=w["sdpa_mask"]))
            einsum = lambda: torch.einsum("bnhd,hdf->bnf", torch.where(
                w["m_tok"][..., None], o.transpose(1, 2), 0), wo) + bias
            if kb == 1:
                calls = {
                    "gemm_q_sparse_kernel": (
                        lambda: TK.gemm_q_sparse_kernel(x, wq, plan.row_ids, plan.row_cnt,
                                                        block_rows=pool),
                        lambda: ref.gemm_q_ref(x, wq, plan.row_ids, plan.row_cnt, block=pool),
                        lambda: torch.matmul(
                            x.reshape(b, n // pool, pool, d)[
                                torch.arange(b, device=dev)[:, None], plan.row_ids.long()], wq),
                        gq_counts, None),
                    "flashomni_attention_csr": (
                        uni_attn,
                        lambda: ref.attention_csr_ref(
                            qc, kk, vv, ore, fl["q_ids"], fl["q_src"], fl["q_cnt"],
                            fl["kv_ids"], fl["kv_cnt"], block_q=bq, block_kv=bkv),
                        sdpa, attn_counts, None),
                    "gemm_o_sparse_kernel": (
                        uni_gemm_o,
                        lambda: ref.gemm_o_ref(o, wo, bias, plan.row_ids, plan.head_ids,
                                               plan.head_cnt, block=pool),
                        einsum, go_counts, None),
                }
            else:
                geo = bucket_geometry(spec.cap_q, spec.cap_kv, h, kb)
                geo_o = bucket_geometry(cr, h, 1, kb)
                bkt = (plan.bkt_head, plan.bkt_q_ids, plan.bkt_q_slots, plan.bkt_kv_ids,
                       plan.bkt_kv_cnt)
                gmo = (plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids, plan.gmo_head_cnt)
                calls = {
                    "flashomni_attention_csr_bucketed": (
                        lambda: TK.flashomni_attention_csr_bucketed(
                            qc, kk, vv, ore, *bkt, geo, heads=h, block_q=bq, block_kv=bkv),
                        lambda: ref.attention_csr_bucketed_ref(
                            qc, kk, vv, ore, *bkt, geo, heads=h, block_q=bq, block_kv=bkv),
                        sdpa, attn_counts, uni_attn),
                    "gemm_o_sparse_bucketed_kernel": (
                        lambda: TK.gemm_o_sparse_bucketed_kernel(o, wo, bias, *gmo, geo_o,
                                                                 block_rows=pool),
                        lambda: ref.gemm_o_bucketed_ref(o, wo, bias, *gmo, geo_o, block=pool),
                        einsum, go_counts, uni_gemm_o),
                }
            if kb == 1 and with_ops:
                calls.update(ops_calls(syms, ecfg, dt, b, h, n, dh, rnd, k32, v32, ore32))
            for name, (kern, plain, library, counts, twin) in calls.items():
                row = {"plan": label, **measure(name, dn, kern, plain, library, counts,
                                                peaks, twin, iters)}
                if library is None:
                    row["library_skipped"] = (f"the SDPA token mask would take "
                                              f"{w['sdpa_mask_bytes'] / 1e9:.1f} GB")
                if name in ATTENTION:
                    row.update(walk_counts(name, dn, kern, row["flops"], bkv, dh))
                if name in TF32X3:          # registers and spills of the instance it ran
                    stem = serving_instance(name, dn)
                    row["ptxas"] = next((u for key, u in usage.items() if stem in key), None)
                results.append(row)
                if dn == "float32" and name not in rows:    # the serving dtype
                    rows[name] = row
        del w, qc32, syms
        torch.cuda.empty_cache()
    emit({"phase": phase, "shapes": {"B": b, "N": n, "heads": h, "head_dim": dh,
                                         "d_model": d, "block_q": 16, "block_kv": 16,
                                         "pool": 32},
          "plans": plans, "results": results})
    return rows


def gemm_times(b=2, h=24, n=4608, dh=128, d=3072, n_text=512, iters=20) -> dict:
    """B1 and B3 on the flashomni plan and B5 (with B3 on the same lists) on
    the sliding-window plan at 2 buckets, alone, in both dtypes: ms and the
    share of the tolerance used. For timing two versions of the GEMM tile
    in turns on one card: from each tree,
    ``python3 -c "import chip_smoke as c; print(c.gemm_times())"``."""
    import torch
    from repro_torch import kernels as TK
    from repro_torch.core.plan import bucket_geometry
    from repro_torch.core.strategy import SlidingWindowStrategy
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rnd = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev).mul_(std)
    x32, wq32 = rnd(b, n, d), rnd(d, h * dh, std=d ** -0.5)
    o32, wo32, bias32 = rnd(b, h, n, dh), rnd(h, dh, d, std=d ** -0.5), rnd(b, n, d)
    out = {}
    for label, strategy, kb in (("flashomni", None, 1),
                                ("sliding-window", SlidingWindowStrategy(), 2)):
        ecfg, _, plan = serving_plan(dev, b, h, n, dh, n_text, strategy, kb)
        pool, cr = ecfg.mask.pool, plan.row_ids.shape[-1]
        geo = bucket_geometry(cr, h, 1, kb)
        lists = (plan.row_ids, plan.head_ids, plan.head_cnt)
        gmo = (plan.gmo_rows, plan.gmo_src, plan.gmo_head_ids, plan.gmo_head_cnt)
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            x, wq, o, wo, bias = (t.to(dt) for t in (x32, wq32, o32, wo32, bias32))
            calls = {"B3": (lambda: TK.gemm_o_sparse_kernel(o, wo, bias, *lists, block_rows=pool),
                            lambda: ref.gemm_o_ref(o, wo, bias, *lists, block=pool))}
            if kb == 1:
                calls["B1"] = (
                    lambda: TK.gemm_q_sparse_kernel(x, wq, plan.row_ids, plan.row_cnt,
                                                    block_rows=pool),
                    lambda: ref.gemm_q_ref(x, wq, plan.row_ids, plan.row_cnt, block=pool))
            else:
                calls["B5"] = (
                    lambda: TK.gemm_o_sparse_bucketed_kernel(o, wo, bias, *gmo, geo,
                                                             block_rows=pool),
                    lambda: ref.gemm_o_bucketed_ref(o, wo, bias, *gmo, geo, block=pool))
            for name, (kern, plain) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                _, share = check_close(name, dn, got, want)
                out[f"{label}/{name}/{dn}"] = {"ms": time_ms(kern, iters), "tol_share": share}
    return out


def ops_calls(syms, ecfg, dt, b, h, n, dh, rnd, k32, v32, ore32) -> dict:
    """The symbols attention on the flashomni symbols' post-clamp masks (its
    twin: the CSR kernel on the CSR lists of the same masks, q in full
    layout) and the Taylor reuse of a (2, B·H, N, dh) stack over the blocks
    those masks cache, as ``measure`` rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as TK
    from repro_torch.core.symbols import active_indices, pack_bits
    from repro_torch.core.taylorseer import reuse_coefficients
    from repro_torch.kernels import ref
    m = ecfg.mask
    bq, bkv, bh = m.block_q, m.block_kv, b * h
    t_q, t_kv = n // bq, n // bkv
    fq, fkv = m.pool // bq, m.pool // bkv
    m_c = torch.repeat_interleave(syms.m_c, fq, dim=-1)[..., :t_q].reshape(bh, t_q)
    m_s = torch.repeat_interleave(torch.repeat_interleave(syms.m_s, fq, dim=-2), fkv,
                                  dim=-1)[..., :t_q, :t_kv].reshape(bh, t_q, t_kv)
    s_c, s_s = pack_bits(m_c), pack_bits(m_s.reshape(bh, -1))
    q_ids, q_cnt, kv_ids, kv_cnt, _ = ref.csr_layout(m_c, m_s)
    qf, kk, vv, ore = rnd(bh, n, dh).to(dt), k32.to(dt), v32.to(dt), ore32.to(dt)
    pairs = m_s & m_c[..., None]
    live_rows, live_pairs = int(m_c.sum()), int(pairs.sum())
    kv_union = int(pairs.any(dim=1).sum())
    # SDPA yardstick: the symbols' token mask; cached rows attend everywhere
    # (dense work either way).
    tok = torch.repeat_interleave(torch.repeat_interleave(m_s | ~m_c[..., None], bq, dim=1),
                                  bkv, dim=2)[:, None]
    kw = dict(block_q=bq, block_kv=bkv)
    calls = {"flashomni_attention_symbols": (
        lambda: TK.flashomni_attention_symbols(qf, kk, vv, ore, s_c, s_s, **kw),
        lambda: ref.attention_symbols_ref(qf, kk, vv, ore, s_c, s_s, **kw),
        lambda: F.scaled_dot_product_attention(qf[:, None], kk[:, None], vv[:, None],
                                               attn_mask=tok),
        dict(bh=bh, n=n, dh=dh, block_q=bq, block_kv=bkv, live_rows=live_rows,
             live_pairs=live_pairs, kv_union_blocks=kv_union,
             symbol_bytes=s_c.numel() + s_s.numel()),
        lambda: TK.flashomni_attention_csr(qf, kk, vv, ore, q_ids, q_ids, q_cnt, kv_ids,
                                           kv_cnt, **kw))}
    # Taylor reuse: a first-order stack, the coefficients of the first
    # Dispatch step after an Update (interval 4), the blocks m_c caches.
    derivs, base = rnd(2, bh, n, dh).to(dt), rnd(bh, n, dh).to(dt)
    coef = reuse_coefficients(1, 1, 4).to(derivs.device)
    ids, cnt = active_indices(~m_c, t_q)
    cached = int(cnt.sum())
    tok_c = torch.repeat_interleave(~m_c, bq, dim=-1)[..., None]
    calls["taylor_reuse_kernel"] = (
        lambda: TK.taylor_reuse_kernel(derivs, coef, base, ids, cnt, block=bq),
        lambda: ref.taylor_reuse_blocks_ref(derivs, coef, base, ids, cnt, block=bq),
        lambda: torch.where(tok_c, torch.tensordot(coef.to(dt), derivs, dims=1), base),
        dict(orders=2, bh=bh, n=n, dh=dh, block=bq, cached=cached),
        None)
    return calls


def run_small(label, cfg, ecfg, nv, schedule=None, expect=()):
    """One smoke-size sampler on the card (kernels) and on the CPU (plain
    versions); ``expect`` names kernels the card run must launch."""
    import torch
    from repro_torch import kernels as TK
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    from repro_torch.models import dit
    g = torch.Generator()
    g.manual_seed(7)
    params = dit.init_params(cfg, g, "cpu")
    pe = torch.randn((cfg.patch_dim, cfg.d_model), generator=g) * 0.2
    x0 = torch.randn((2, nv, cfg.patch_dim), generator=g)
    text = torch.randn((2, cfg.n_text_tokens, cfg.d_model), generator=g)
    outs, traces = {}, {}
    for dev in ("cpu", DEVICE):
        to = lambda t: t.to(dev)
        p = {k: ({kk: to(vv) for kk, vv in v.items()} if isinstance(v, dict) else to(v))
             for k, v in params.items()}
        traces[dev] = []
        TK.reset_launches()
        outs[dev] = sample(p, cfg, ecfg, text_emb=to(text), x0=to(x0), patch_embed=to(pe),
                           scfg=SamplerConfig(num_steps=STEPS), trace=traces[dev],
                           schedule=schedule).cpu()
    launches = {fn.__name__: fn.launches for fn in TK.KERNELS}
    err = float((outs[DEVICE] - outs["cpu"]).abs().max())
    ok = torch.allclose(outs[DEVICE], outs["cpu"], rtol=1e-3, atol=1e-4)
    same_trace = all(abs(a["density"] - c["density"]) < 1e-6
                     and abs(a["pair_sparsity"] - c["pair_sparsity"]) < 1e-6
                     for a, c in zip(traces["cpu"], traces[DEVICE]))
    routed = all(launches[name] > 0 for name in expect)
    res = {"run": label, "heads": cfg.n_heads, "n_tokens": nv + cfg.n_text_tokens,
           "kv_buckets": ecfg.resolved_kv_buckets(), "max_abs_err": err,
           "trace_matches": same_trace, "launches": launches,
           "ok": bool(ok and same_trace and routed)}
    if not res["ok"]:
        raise AssertionError(f"smoke sampler {label} on the card disagrees with the CPU run "
                             f"or missed its kernels: {res}")
    return res


def small_runs(validate: bool = False) -> list:
    """The six smoke-size samplers, kernels on the card vs plain versions on
    the CPU; ``validate`` turns on the plan validator's hook
    (``EngineConfig.validate_plans``) in every run."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core.strategy import StepPhasedStrategy
    from repro_torch.launch.serve import serving_engine_config
    cfg = get_smoke("flux-mmdit")
    cfg4 = dataclasses.replace(cfg, n_heads=4, n_kv_heads=4)
    # Steps 0-1 emit flashomni, steps 2+ cache-all: round(0.3 * 8) = 2.
    phased = StepPhasedStrategy(phases=("flashomni", "cache-all"), boundaries=(0.3,))
    ecfg = lambda *a, **kw: dataclasses.replace(serving_engine_config(*a),
                                                validate_plans=validate, **kw)
    return [
        run_small("P1 flashomni", cfg, ecfg(), 96, expect=P1_KERNELS),
        run_small("P2' hunyuan-1.5x schedule, 4 heads", cfg4, ecfg("flashomni", 3), 96,
                  schedule="hunyuan-1.5x", expect=P2_KERNELS),
        run_small("sliding-window, auto buckets", cfg, ecfg("sliding-window", 0), 480,
                  expect=P2_KERNELS),
        run_small("cache-all", cfg, ecfg("cache-all"), 96, expect=P1_KERNELS),
        run_small("step-ramp schedule", cfg, ecfg(), 96, schedule="step-ramp",
                  expect=P1_KERNELS),
        run_small("step-phased flashomni -> cache-all at 0.3", cfg, ecfg(strategy=phased), 96,
                  expect=P1_KERNELS),
    ]


def phase_small():
    """Smoke-size samplers: kernels on the card vs plain versions on the CPU."""
    emit({"phase": "small", "runs": small_runs(), "ok": True})


def phase_analysis():
    """The invariant analyzer on the card: ``run_analysis`` at its geometry
    (every pass, the kernels launched), the plan validator on the seeded
    plans of the ``kernels`` cell (flux shapes, 1-3 buckets) and of
    ``kernels_33k`` (H1's shapes), on the 38 plans of one full-width
    flux-mmdit Update step built with ``validate_plans=True``, and the six
    smoke samplers again with the hook on.  Any finding fails."""
    import torch
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.op_walk import kernel_regions
    from repro_torch.analysis.passes import _N, _engine_cfg, trace_pair
    from repro_torch.analysis.plan_check import check_plan, hook_validate
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.core.strategy import MultiGranularityStrategy, SlidingWindowStrategy
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    res, findings, t_all = {}, [], time.perf_counter()
    t0 = time.perf_counter()
    found = run_analysis(device=DEVICE, verbose=False)
    findings += [str(f) for f in found]
    res["run_analysis"] = {"findings": len(found), "seconds": time.perf_counter() - t0,
                           "dispatch_regions": {
                               f"kernels/kv_buckets={kvb}": kernel_regions(trace_pair(
                                   _engine_cfg(kv_buckets=kvb), _N, DEVICE)[1])
                               for kvb in (1, 3)}}
    # The seeded plans of the kernel cells (serving_plan, as phase_kernels builds them).
    interior = MultiGranularityStrategy(children=("flashomni", "skip-only", "sliding-window"),
                                        head_assign=(0, 0, 2))
    cells = [("kernels", FULL, "flashomni", None, 1),
             ("kernels", FULL, "sliding-window", SlidingWindowStrategy(), 2),
             ("kernels", FULL, "hunyuan-1.5x interior", interior, 3),
             ("kernels_33k", H1_SHAPE, "flashomni", None, 1),
             ("kernels_33k", H1_SHAPE, "hunyuan-1.5x interior", interior, 3)]
    checked = []
    for cell, shape, label, strategy, kb in cells:
        sh = {k: shape[k] for k in ("b", "h", "n", "dh", "n_text")}
        ecfg, syms, plan = serving_plan(torch.device(DEVICE), **sh, strategy=strategy,
                                        kv_buckets=kb, widen=False)
        del syms
        t0 = time.perf_counter()
        msgs = check_plan(plan, ecfg, shape["n"])
        checked.append({"cell": cell, "plan": label, "kv_buckets": kb, "findings": msgs,
                        "seconds": time.perf_counter() - t0})
        findings += [f"{cell}/{label}: {m}" for m in msgs]
        del plan
        torch.cuda.empty_cache()
    res["kernel_cell_plans"] = checked
    # One full-width flux-mmdit Update step with the hook on: one check per layer.
    cfg = get_config(FLUX["arch"])
    ecfg = dataclasses.replace(serving_engine_config(), validate_plans=True)
    params, xe, text, t = profile_inputs(cfg, FLUX["batch"], FLUX["n_vision"])
    states = dit.init_engine_states(cfg, ecfg, FLUX["batch"],
                                    FLUX["n_vision"] + cfg.n_text_tokens, xe.device)
    sched = resolve_schedule(ecfg, STEPS, cfg.n_layers)
    hook_validate.calls = 0
    t0 = time.perf_counter()
    dit.denoise_step(params, cfg, ecfg, states, xe, text, t, mode="update",
                     dtype=torch.float32, strategies=sched.strategies,
                     strategy_row=sched.strategy_ids[0], step_idx=0, num_steps=STEPS)
    torch.cuda.synchronize()
    res["update_step"] = {"layers": cfg.n_layers, "plans_checked": hook_validate.calls,
                          "seconds": time.perf_counter() - t0}
    if hook_validate.calls != cfg.n_layers:
        findings.append(f"the Update step checked {hook_validate.calls} plans, expected "
                        f"{cfg.n_layers}")
    del params, xe, text, t, states
    torch.cuda.empty_cache()
    # The smoke samplers with the hook on (CPU and card runs alike).
    hook_validate.calls = 0
    t0 = time.perf_counter()
    runs = small_runs(validate=True)
    res["small_validated"] = {"runs": len(runs), "plans_checked": hook_validate.calls,
                              "seconds": time.perf_counter() - t0}
    if not hook_validate.calls:
        findings.append("the smoke samplers ran with validate_plans=True and checked no plan")
    res.update(findings=findings, seconds=time.perf_counter() - t_all)
    emit({"phase": "analysis", **res})
    if findings:
        raise AssertionError(f"the analyzer reported {len(findings)} finding(s): {findings}")


# T1, the training cell: flux-mmdit at every published width cut to 2 of
# its 38 blocks (f32 AdamW state for all 38 takes 16 B x 6.46 B parameters,
# 103 GB, more than the card), batch 1, 4096 vision + 512 text tokens, the
# reference launcher's AdamW (lr 1e-3, warm-up 10), 6 steps, a checkpoint
# every 3 (keep 1) and one injected node failure at step 4: steps 3-5 run
# again from the step-3 checkpoint.
T1 = dict(n_layers=2, steps=6, batch=1, seq_len=4096, ckpt_every=3, keep=1, fail_at=(4,))
# The card-vs-CPU training runs at smoke width (flux-smoke, as the
# reference's smoke launcher runs it), each with no compression, int8 and
# top-k: loss and gradient norm within TRAIN_REL at every step.
TRAIN_SMOKE = dict(steps=6, batch=2, seq_len=64)
TRAIN_REL = 1e-4
# The gradient check: one full-width attention layer in f32 (B 1, 24 heads,
# 4608 tokens, head_dim 128), the grad branch of dense_attention against
# autograd of an unchunked softmax(q k^T s) v at TOL["float32"]; its forward
# against the no-grad (in-place) body within GRAD_FWD_REL_L2.
GRAD_SHAPE = dict(b=1, h=24, n=4608, dh=128)
GRAD_FWD_REL_L2 = 1e-6


def train_grad_check(b, h, n, dh) -> dict:
    """dq, dk, dv of ``dense_attention``'s grad branch against autograd of the
    unchunked attention on the same card tensors, and its forward against
    the in-place no-grad body; both passes' times (CUDA events)."""
    import torch
    from repro_torch.core.attention import dense_attention
    g = torch.Generator(device=DEVICE)
    g.manual_seed(20)
    q, k, v, cot = (torch.randn((b, h, n, dh), generator=g, device=DEVICE) for _ in range(4))

    def chunked():
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = dense_attention(qs, ks, vs)
        return (out.detach(), *torch.autograd.grad(out, (qs, ks, vs), cot))

    def whole():
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = torch.softmax((qs @ ks.transpose(-1, -2)) * dh ** -0.5, dim=-1) @ vs
        return torch.autograd.grad(out, (qs, ks, vs), cot)

    out, *got = chunked()
    want = whole()
    with torch.no_grad():
        plain = dense_attention(q, k, v)
    fwd_rel = float((out - plain).norm() / plain.norm())
    res = {"shape": dict(b=b, h=h, n=n, dh=dh), "forward_rel_l2_vs_no_grad": fwd_rel,
           "ms": {"grad_branch_fwd_bwd": time_ms(chunked, 3, 1),
                  "unchunked_fwd_bwd": time_ms(whole, 3, 1),
                  "no_grad_fwd": time_ms(lambda: dense_attention(q, k, v), 3, 1)}}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        res[name] = {"max_abs_err": float((a - w).abs().max()),
                     "ok": bool(torch.allclose(a, w, rtol=TOL["float32"],
                                               atol=TOL["float32"]))}
    del q, k, v, cot, out, got, want, plain
    torch.cuda.empty_cache()
    res["ok"] = fwd_rel <= GRAD_FWD_REL_L2 and all(res[x]["ok"] for x in ("dq", "dk", "dv"))
    return res


def train_smoke_vs_cpu(compress) -> dict:
    """flux-smoke trained on the card and on the CPU from the same seeded
    weights: per-step loss and gradient norm, largest relative difference."""
    import tempfile
    import torch
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.train import train
    from repro_torch.models import dit
    params = dit.init_params(get_smoke("flux-mmdit"), torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", DEVICE):
        with tempfile.TemporaryDirectory() as tmp:
            _, runs[dev] = train("flux-mmdit", compress=compress, ckpt_dir=tmp, params=params,
                                 ckpt_every=10 ** 6, device=dev, **TRAIN_SMOKE)
    rel = max(abs(a[key] - c[key]) / abs(c[key])
              for a, c in zip(runs[DEVICE].metrics, runs["cpu"].metrics)
              for key in ("loss", "grad_norm"))
    return {"compress": compress, "max_rel_diff": rel,
            "losses": [m["loss"] for m in runs[DEVICE].metrics],
            "ok": bool(rel <= TRAIN_REL and len(runs[DEVICE].metrics) == TRAIN_SMOKE["steps"])}


# L-train: gemma3-1b as published (26 layers, d_model 1152, vocab 262 144,
# remat on) trained one step at batch 1 and 4096 tokens through
# launch/train.make_step_fn (not the restartable loop: a checkpoint of its
# 16 GB of f32 state would cost tens of seconds), with remat on and with
# it off (dataclasses.replace(cfg, remat=False)) on the same weights and
# batch: a warm-up step, then the median of LTRAIN_STEPS; the loss and every
# gradient of the two within LTRAIN_REL of the largest magnitude.
LTRAIN = dict(arch="gemma3-1b", batch=1, seq_len=4096)
LTRAIN_STEPS = 3
LTRAIN_REL = 1e-5


def ltrain_grads(model, params, batch) -> tuple:
    """``(loss, gradient leaves)`` of ``model``'s f32 train loss."""
    import torch
    from repro_torch.tree import tree_flatten, tree_unflatten
    leaves, tdef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.train_loss(tree_unflatten(tdef, leaves), batch, dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads]


def ltrain_mode(cfg, params, opt_state) -> dict:
    """One remat mode of L-train: a warm-up step, then LTRAIN_STEPS steps from
    the same state at step 0 (the same batch), each new state dropped; the
    median seconds, the loss and the peak memory of the steps."""
    import statistics
    import torch
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.train import make_step_fn
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig
    dcfg = DataConfig(seed=0, batch=LTRAIN["batch"], seq_len=LTRAIN["seq_len"])
    step_fn = make_step_fn(get_model(cfg), AdamWConfig(lr=1e-3, warmup_steps=10,
                                                       total_steps=LTRAIN_STEPS + 1),
                           dcfg, cfg, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(1 + LTRAIN_STEPS):
        new_state, m = step_fn((params, opt_state), 0)
        del new_state
        steps.append(m)
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed_steps = steps[1:]
    return {"remat": cfg.remat, "loss": [m["loss"] for m in steps],
            "grad_norm": timed_steps[0]["grad_norm"],
            "warmup_s": {k: steps[0][k] for k in ("grad_s", "update_s")},
            "grad_s": statistics.median(m["grad_s"] for m in timed_steps),
            "update_s": statistics.median(m["update_s"] for m in timed_steps),
            "steps_s": [[m["grad_s"], m["update_s"]] for m in timed_steps],
            "peak_mem_gb": peak}


def ltrain() -> tuple[dict, dict, list]:
    """L-train, the launch counts set to 0 just before and read just after;
    returns its row and its launches."""
    import math
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.models.registry import get_model, param_count
    from repro_torch.optim.optimizer import adamw_init
    cfg = get_config(LTRAIN["arch"])
    off = dataclasses.replace(cfg, remat=False)
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = get_model(cfg).init_params(gen, DEVICE)
    opt_state = adamw_init(params)
    modes = {"remat_on": ltrain_mode(cfg, params, opt_state),
             "remat_off": ltrain_mode(off, params, opt_state)}
    del opt_state
    torch.cuda.empty_cache()
    batch = make_batch(cfg, DataConfig(seed=0, batch=LTRAIN["batch"],
                                       seq_len=LTRAIN["seq_len"]), 0, device=DEVICE)
    loss_on, grads_on = ltrain_grads(get_model(cfg), params, batch)
    loss_off, grads_off = ltrain_grads(get_model(off), params, batch)
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(grads_on, grads_off))
    loss_err = abs(float(loss_on) - float(loss_off)) / abs(float(loss_off))
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    del params, grads_on, grads_off, batch
    torch.cuda.empty_cache()
    res = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "vocab": cfg.vocab, "remat": cfg.remat, **LTRAIN},
           "n_params": param_count(cfg), **modes,
           "loss_rel_diff": loss_err, "grad_rel_err": grad_err,
           "loss_on_off": [float(loss_on), float(loss_off)],
           "peak_saved_gb": modes["remat_off"]["peak_mem_gb"] - modes["remat_on"]["peak_mem_gb"],
           "grad_s_ratio_on_over_off": modes["remat_on"]["grad_s"] / modes["remat_off"]["grad_s"],
           "seconds": time.perf_counter() - t0, "launches": launches}
    faults = []
    if not (loss_err <= LTRAIN_REL and grad_err <= LTRAIN_REL):
        faults.append(f"L-train: remat on and off differ: loss {loss_err:.3e}, "
                      f"gradients {grad_err:.3e} (limit {LTRAIN_REL})")
    if not all(math.isfinite(x) for m in modes.values() for x in m["loss"]):
        faults.append("L-train: a loss is not finite")
    if any(launches.values()):
        faults.append(f"L-train launched kernels: {launches}")
    return res, launches, faults


def phase_train() -> tuple[dict, dict]:
    """The training path (``repro_torch.launch.train``) on the card: the
    gradient check of the dense attention at full width, flux-smoke trained on
    the card against the CPU (no compression, int8, top-k), T1: flux-mmdit at
    full width and 2 blocks through the restartable loop with one injected
    failure, then L-train: gemma3-1b at full width, one step with remat on
    and off.  Launch counts set to 0 just before T1 and before L-train and
    read just after each: the engine is off in training, so no kernel may
    launch.  Returns each path's launch counts and T1's record."""
    import math
    import shutil
    import statistics
    import tempfile
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    t_all = time.perf_counter()
    res = {"phase": "train", "grad_check": train_grad_check(**GRAD_SHAPE)}
    res["smoke_vs_cpu"] = [train_smoke_vs_cpu(c) for c in (None, "int8", "topk")]
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=T1["n_layers"])
    run = {key: val for key, val in T1.items() if key != "n_layers"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp_free_gb = shutil.disk_usage(tmp).free / 1e9
        state, out = train(cfg, ckpt_dir=tmp, device=DEVICE, **run)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    n_params = sum(x.numel() for x in tree_leaves(state[0]))
    del state
    torch.cuda.empty_cache()
    metrics = out.metrics
    step3 = [(m["loss"], m["grad_norm"]) for m in metrics if m["step"] == 3]
    saves = [h for h in out.checkpoints if h["kind"] == "save"]
    restores = [h for h in out.checkpoints if h["kind"] == "restore"]
    res["T1"] = {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "heads": cfg.n_heads, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
                   "n_text": cfg.n_text_tokens, **run},
        "n_params": n_params, "n_params_formula": cfg.n_params(),
        "wall_s": wall, "restarts": out.restarts, "final_step": out.final_step,
        "steps": [{k: m[k] for k in ("step", "loss", "grad_norm", "grad_s", "update_s")}
                  for m in metrics],
        "median_s": {"grad": statistics.median(m["grad_s"] for m in metrics),
                     "update": statistics.median(m["update_s"] for m in metrics)},
        "checkpoints": saves, "restores": restores, "ckpt_dir_free_gb": tmp_free_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "step3_before_after_restart": step3, "launches": launches}
    res["L-train"], ltrain_launches, faults = ltrain()
    res["seconds"] = time.perf_counter() - t_all
    emit(res)
    if not res["grad_check"]["ok"]:
        faults.append(f"gradient check: {res['grad_check']}")
    faults += [f"card vs CPU: {r}" for r in res["smoke_vs_cpu"] if not r["ok"]]
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
        faults.append("T1: a loss or gradient norm is not finite")
    if out.restarts != 1 or out.final_step != run["steps"]:
        faults.append(f"T1: {out.restarts} restarts, final step {out.final_step}")
    if len(step3) != 2 or step3[0] != step3[1]:
        faults.append(f"T1: step 3 before and after the restart differ: {step3}")
    if any(launches.values()):
        faults.append(f"T1 launched kernels: {launches}")
    if faults:
        raise AssertionError("train: " + "; ".join(faults))
    return {"T1": launches, "L-train": ltrain_launches}, res["T1"]


# The LM families (models/transformer, ssm, rglru, encdec and vision;
# launch/serve.serve_lm).  Their ten smoke configs run on the card and on
# the CPU from the same weights (forward logits on LM_SMOKE_TOKENS tokens,
# which put the windowed configs' local layers on the banded path;
# LM_SMOKE_STEPS decode steps, which wrap their 32-slot rings; prefill; the
# stub frames or patches where the family takes them), each within LM_REL
# of the CPU: the largest difference over the largest magnitude.  Then six
# published configs at full width in f32 (LM_PATHS): serve_lm at the
# reference's defaults (batch 2, prompt 32, 16 tokens, 64 slots), ms a
# decode token (median of LM_TIMED_STEPS, CUDA events), one prefill of
# batch 1 (LM_PREFILL_TOKENS, where gemma's local layers and
# recurrentgemma's attention (4096 > 2 x 2048) take the banded path;
# LM_PREFILL for whisper, its 1500 frames and its published 448-token
# target, and for llama-vision, 2048 tokens and its 1600 patches), and for
# LM_DECODE_CHECK decode's logits at positions 0 to LM_CHECK_STEPS - 1
# against forward's within LM_REL.  No kernel of B1-B7 may launch.
LM_SMOKE_ARCHS = ("gemma3-1b", "gemma3-12b", "granite-8b", "llama3-405b", "mixtral-8x22b",
                  "granite-moe-3b-a800m", "mamba2-370m", "recurrentgemma-2b",
                  "whisper-large-v3", "llama-3.2-vision-11b")
LM_REL = 1e-4
LM_SMOKE_TOKENS, LM_SMOKE_STEPS = 80, 40
LM_PATHS = (("L1", "gemma3-1b"), ("L2", "granite-moe-3b-a800m"), ("L3", "mamba2-370m"),
            ("L4", "recurrentgemma-2b"), ("L5", "whisper-large-v3"),
            ("L6", "llama-3.2-vision-11b"))
LM_PREFILL_TOKENS = 4096
LM_PREFILL = {"L5": 448, "L6": 2048}
LM_DECODE_CHECK = ("L1", "L3", "L4")
LM_TIMED_STEPS = 10
LM_CHECK_STEPS = 20


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30).cpu())


def lm_batch(cfg, tokens, gen) -> dict:
    """``tokens`` and, for encdec and vlm, the stub ``frames`` (encoder_len
    rows) or ``patches`` (num_image_tokens rows) of width d_model, drawn
    from ``gen`` on the tokens' device."""
    import torch
    batch = {"tokens": tokens}
    extra = {"encdec": ("frames", cfg.encoder_len),
             "vlm": ("patches", cfg.num_image_tokens)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.randn((tokens.shape[0], extra[1], cfg.d_model), generator=gen,
                                      device=tokens.device)
    return batch


def lm_runs(params, cfg, batch, steps, max_len=64) -> dict:
    """``forward``'s logits, the logits of ``steps`` teacher-forced decode
    steps from an empty cache and ``prefill``'s last row, in f32."""
    import torch
    from repro_torch.models.registry import get_model
    f32 = torch.float32
    model = get_model(cfg)
    tokens = batch["tokens"]
    with torch.no_grad():
        logits, aux = model.forward(params, batch, dtype=f32)
        cache = model.init_cache(tokens.shape[0], max_len, f32, device=tokens.device)
        dec = []
        for i in range(steps):
            lg, cache = model.decode_step(params, cache, tokens[:, i], i, dtype=f32)
            dec.append(lg)
        last = model.prefill(params, batch, dtype=f32)
    return {"forward": logits, "aux": aux, "decode": torch.stack(dec, dim=1), "prefill": last}


def lm_smoke_vs_cpu(arch) -> dict:
    import torch
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    cfg = get_smoke(arch)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = lm_batch(cfg, torch.randint(0, cfg.vocab, (2, LM_SMOKE_TOKENS), generator=gen), gen)
    cpu = lm_runs(params, cfg, batch, LM_SMOKE_STEPS)
    card = lm_runs(tree_map(lambda t: t.to(DEVICE), params), cfg,
                   {k: v.to(DEVICE) for k, v in batch.items()}, LM_SMOKE_STEPS)
    errs = {key: rel_err(card[key], cpu[key]) for key in cpu}
    finite = all(bool(torch.isfinite(v).all()) for v in card.values())
    return {"arch": cfg.name, "rel_err": errs,
            "ok": finite and all(e <= LM_REL for e in errs.values())}


def decode_ms(model, params, cfg, steps) -> list:
    """CUDA-event ms of each of ``steps`` decode steps (batch 2, f32) from an
    empty cache of 64 slots."""
    import torch
    cache = model.init_cache(2, 64, torch.float32, device=DEVICE)
    tok = torch.zeros((2,), dtype=torch.int32, device=DEVICE)
    events = []
    with torch.no_grad():
        for i in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            logits, cache = model.decode_step(params, cache, tok, i, dtype=torch.float32)
            tok = logits.argmax(dim=-1).to(torch.int32)
            end.record()
            events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def decode_work(model, params, cfg, median_ms) -> dict:
    """One decode step (batch 2, f32, after a warm-up step) under the
    profiler: its device-busy ms and kernel launches, the device's idle
    share against the unprofiled median step ``median_ms``; and the aten ops
    the step dispatches (``analysis.op_walk``, views included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.op_walk import eqn_count, record_call
    cache = model.init_cache(2, 64, torch.float32, device=DEVICE)
    tok = torch.zeros((2,), dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        _, cache = model.decode_step(params, cache, tok, 0, dtype=torch.float32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, cache = model.decode_step(params, cache, tok, 1, dtype=torch.float32)
            torch.cuda.synchronize()
        _, rec = record_call(model.decode_step, params, cache, tok, 2, dtype=torch.float32)
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3
    return {"device_busy_ms": busy or None,
            "idle_share": (1 - busy / median_ms) if busy else None,
            "kernel_launches": sum(ev.count for ev in kernels), "aten_ops": eqn_count(rec)}


def lm_path(label, arch) -> tuple[dict, dict, list]:
    """One of LM_PATHS: ``serve_lm`` at full width, then the decode timing,
    the prefill and (LM_DECODE_CHECK) decode against forward on the same
    seeded weights; the launch counts are set to 0 just before and read just
    after."""
    import math
    import statistics
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = serve_lm(arch, smoke=False, seed=0, device=DEVICE)
    serve_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)                                # serve_lm's weights again
    params = model.init_params(gen, DEVICE)
    ms = decode_ms(model, params, cfg, LM_TIMED_STEPS)
    work = decode_work(model, params, cfg, statistics.median(ms))
    n_prefill = LM_PREFILL.get(label, LM_PREFILL_TOKENS)
    batch = lm_batch(cfg, torch.randint(0, cfg.vocab, (1, n_prefill), generator=gen,
                                        device=DEVICE), gen)
    prefill_s = []
    for _ in range(2):                                # the first includes warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            last = model.prefill(params, batch, dtype=torch.float32)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    del batch
    res = {"path": label, "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": sum(t.numel() for t in tree_leaves(params)),
           "serve_lm_s": serve_s, "tokens_first8": tokens[0, :8].tolist(),
           "tokens_shape": list(tokens.shape),
           "decode_ms": {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
                         "first": ms[0], **work},
           "prefill": {"tokens": n_prefill, "s": prefill_s,
                       "tokens_per_s": n_prefill / prefill_s[-1],
                       "finite": bool(torch.isfinite(last).all())}}
    if cfg.family == "encdec":
        res["prefill"]["frames"] = cfg.encoder_len
    if cfg.family == "vlm":
        res["prefill"]["patches"] = cfg.num_image_tokens
    if label in LM_DECODE_CHECK:
        check = torch.randint(0, cfg.vocab, (2, LM_CHECK_STEPS), generator=gen, device=DEVICE)
        runs = lm_runs(params, cfg, {"tokens": check}, LM_CHECK_STEPS)
        res["decode_vs_forward_rel_err"] = rel_err(runs["decode"], runs["forward"])
        del runs
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    res["launches"] = launches
    del params, last
    torch.cuda.empty_cache()
    faults = []
    if tokens.shape != (2, 16) or not all(0 <= t < cfg.vocab for t in tokens.flatten().tolist()):
        faults.append(f"{label}: greedy tokens {tokens.shape}")
    if not (res["prefill"]["finite"] and all(math.isfinite(x) for x in ms)):
        faults.append(f"{label}: prefill logits or decode times not finite")
    if not res.get("decode_vs_forward_rel_err", 0.0) <= LM_REL:
        faults.append(f"{label}: decode against forward {res['decode_vs_forward_rel_err']}")
    if any(launches.values()):
        faults.append(f"{label} launched kernels: {launches}")
    return res, launches, faults


def phase_lm() -> dict:
    """The LM families on the card: the ten smoke configs against the CPU,
    then L1-L6 at full width.  Returns each path's launch counts."""
    t0 = time.perf_counter()
    res = {"phase": "lm", "smoke_vs_cpu": [lm_smoke_vs_cpu(a) for a in LM_SMOKE_ARCHS]}
    faults = [f"card vs CPU: {r}" for r in res["smoke_vs_cpu"] if not r["ok"]]
    by_path = {}
    for label, arch in LM_PATHS:
        res[label], by_path[label], path_faults = lm_path(label, arch)
        faults += path_faults
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    if faults:
        raise AssertionError("lm: " + "; ".join(faults))
    return by_path


# long_context: repro_torch.long_context_lm, the port of the reference's
# long-context example (top-k KV blocks by pooled keys at decode).  The
# example at its size (LC_EXAMPLE: B 2, H 4, S 8192, head_dim 64, blocks of
# 64, 25 % kept) on the card and on the CPU from the same inputs: the block
# ids and counts equal, the outputs within LC_REL of the largest magnitude.
# Then the same path at the long_500k shape's context with gemma3-1b's
# attention geometry (LC_LONG: B 1, 4 query heads, head_dim 256, 524 288
# tokens; K and V caches of 2.15 GB each in f32): the relative error against
# dense attention, the selection, sparse and dense decode ms (CUDA events,
# median of LC_ITERS after 2 warm-ups), the KV bytes each reads and the peak.
LC_EXAMPLE = dict(b=2, h=4, s=8192, dh=64)
LC_LONG = dict(b=1, h=4, s=524288, dh=256)
LC_BLOCK, LC_KEEP = 64, 0.25
LC_REL = 1e-5
LC_ITERS = 20


def median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event ms of ``iters`` calls of ``fn`` after ``warmup``."""
    import statistics
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_long_context() -> dict:
    """The long-context sparse decode on the card (``long_context``); the
    launch counts are set to 0 just before and read just after: no kernel of
    B1-B7 lies on this path."""
    import math
    import torch
    from repro_torch import long_context_lm as LC
    from repro_torch.kernels import KERNELS, reset_launches
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    inputs = LC.make_inputs(**LC_EXAMPLE, block=LC_BLOCK, seed=0, device="cpu")
    cpu = LC.select_and_attend(*inputs, block=LC_BLOCK, keep_frac=LC_KEEP)
    card = LC.select_and_attend(*(t.to(DEVICE) for t in inputs), block=LC_BLOCK,
                                keep_frac=LC_KEEP)
    example = {**LC_EXAMPLE, "block": LC_BLOCK, "keep_frac": LC_KEEP,
               "ids_equal": bool(torch.equal(card.kv_ids.cpu(), cpu.kv_ids)
                                 and torch.equal(card.kv_cnt.cpu(), cpu.kv_cnt)),
               "sparse_rel_err": rel_err(card.sparse, cpu.sparse),
               "dense_rel_err": rel_err(card.dense, cpu.dense),
               "rel_vs_dense": {"card": card.rel, "cpu": cpu.rel}}
    del inputs, cpu, card
    torch.cuda.reset_peak_memory_stats()
    q, k_cache, v_cache = LC.make_inputs(**LC_LONG, block=LC_BLOCK, seed=0, device=DEVICE)
    out = LC.select_and_attend(q, k_cache, v_cache, block=LC_BLOCK, keep_frac=LC_KEEP)
    ids, cnt = out.kv_ids, out.kv_cnt
    ms = {"select": median_ms(lambda: LC.select_blocks(q, k_cache, block=LC_BLOCK,
                                                       keep_frac=LC_KEEP), LC_ITERS),
          "sparse_decode": median_ms(lambda: LC.sparse_decode_attention(
              q, k_cache, v_cache, ids, cnt, LC_BLOCK), LC_ITERS),
          "dense_decode": median_ms(lambda: LC.dense_decode(q, k_cache, v_cache), LC_ITERS)}
    bh, s, dh = k_cache.shape
    f32 = 4
    read = {"sparse_decode": 2 * int(cnt.sum()) * LC_BLOCK * dh * f32 + q.numel() * f32,
            "dense_decode": 2 * bh * s * dh * f32 + q.numel() * f32,
            "select": bh * s * dh * f32 + q.numel() * f32}
    long = {**LC_LONG, "block": LC_BLOCK, "keep_frac": LC_KEEP,
            "cache_gb_each": k_cache.numel() * f32 / 1e9, "blocks_kept": int(cnt[0]),
            "blocks": s // LC_BLOCK, "rel_vs_dense": out.rel, "ms": ms, "kv_bytes_read": read,
            "hbm_bound_ms": {k: v / HBM_BYTES_S * 1e3 for k, v in read.items()},
            "sparse_over_dense_ms": ms["sparse_decode"] / ms["dense_decode"],
            "select_note": "the selection pools every key each call; a server would keep "
                           "the pooled keys with the cache",
            "finite": bool(torch.isfinite(out.sparse).all() and torch.isfinite(out.dense).all()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del q, k_cache, v_cache, out, ids, cnt
    torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    res = {"phase": "long_context", "example": example, "long_500k": long,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(res)
    faults = []
    if not (example["ids_equal"] and example["sparse_rel_err"] <= LC_REL
            and example["dense_rel_err"] <= LC_REL):
        faults.append(f"the example on the card differs from the CPU: {example}")
    if not (long["finite"] and math.isfinite(long["rel_vs_dense"])):
        faults.append("the 524 288-token decode is not finite")
    if any(launches.values()):
        faults.append(f"long_context launched kernels: {launches}")
    if faults:
        raise AssertionError("long_context: " + "; ".join(faults))
    return launches


# sharding: repro_torch.distributed.{sharding, collective_matmul} and
# runtime/elastic in a gloo world of 2 ranks sharing the card
# (launch/mesh.run_local_mesh).  ag_matmul_overlapped at flux width (x
# (1, 4608, 3072) split on tokens, w (3072, 3072)) within SHARD_ATOL (the
# reference's test tolerance) of one rank's x @ w, timed beside an
# all_gather followed by the product (host clock, the card synchronised;
# median of SHARD_ITERS after one warm-up); then reshard_state of T1's
# 2-block flux-mmdit parameters (1.48 GB f32), sharded ("fsdp", None, ...)
# over a (2, 1) mesh and then onto shrink_mesh(..., drop_data_rows=1):
# torch.equal to the unsharded tensors.
SHARD_MESH = (2, 1)
SHARD_CM = dict(b=1, s=4608, d=3072, f=3072)
SHARD_ATOL = 1e-4
SHARD_ITERS = 5
SHARD_JOIN_S = 300


def sharding_rank(rank: int, s5_ref: str) -> dict:
    """One rank of the ``sharding`` phase: its launch counts are set to 0 at
    its start and read at its end (and around each of S2-S5).  ``s5_ref``
    is the file of S5's unsharded step (:func:`s5_reference`)."""
    import statistics
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.collective_matmul import ag_matmul_overlapped
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.models import dit
    from repro_torch.runtime.elastic import reshard_state, shrink_mesh
    from repro_torch.tree import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    t_rank = time.perf_counter()
    reset_launches()
    world = dist.get_world_size()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(MESH_SEED)
    b, s, d, f = (SHARD_CM[k] for k in ("b", "s", "d", "f"))
    x = torch.randn((b, s, d), generator=g, device=DEVICE)
    w = torch.randn((d, f), generator=g, device=DEVICE) * d ** -0.5
    s_loc = s // world
    shard = x[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    y = ag_matmul_overlapped(shard, w)
    want = x @ w
    err = float((y - want).abs().max())

    def gathered():
        parts = [torch.empty_like(shard) for _ in range(world)]
        dist.all_gather(parts, shard)
        return torch.cat(parts, dim=1) @ w

    gather_err = float((gathered() - want).abs().max())

    def host_ms(fn) -> float:
        fn()
        times = []
        for _ in range(SHARD_ITERS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    cm = {**SHARD_CM, "ranks": world, "max_abs_err": err, "allgather_max_abs_err": gather_err,
          "overlapped_vs_allgather_max_abs_diff": float((y - gathered()).abs().max()),
          "ms": host_ms(lambda: ag_matmul_overlapped(shard, w)),
          "allgather_then_matmul_ms": host_ms(gathered),
          "local_matmul_ms": median_ms(lambda: x @ w, SHARD_ITERS)}
    del x, w, y, want, shard
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=T1["n_layers"])
    gp = torch.Generator(device=DEVICE)
    gp.manual_seed(0)
    params = dit.init_params(cfg, gp, DEVICE)
    spec = tree_map(lambda t: ("fsdp",) + (None,) * (t.ndim - 1) if t.ndim else (), params)
    mesh = DeviceMesh(DEVICE, torch.arange(world).reshape(SHARD_MESH),
                      mesh_dim_names=("data", "model"))
    t0 = time.perf_counter()                     # DTensor's first call sets up its machinery
    reshard_state({"w": torch.zeros((world, 2), device=DEVICE)}, {"w": ("fsdp", None)}, mesh,
                  DEFAULT_RULES)
    warmup_s = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    sharded = reshard_state(params, spec, mesh, DEFAULT_RULES)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    small = shrink_mesh(mesh, drop_data_rows=1)
    dist.barrier()
    t0 = time.perf_counter()
    moved = reshard_state(sharded, spec, small, DEFAULT_RULES)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    leaves = tree_flatten(params)[0]
    local = [t.to_local() for t in tree_flatten(sharded)[0]]
    rs = {"mesh": list(SHARD_MESH), "new_mesh": small.mesh.tolist(),
          "n_params": sum(t.numel() for t in leaves),
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "local_bytes": sum(t.numel() * t.element_size() for t in local),
          "warmup_s": warmup_s, "shard_s": shard_s, "reshard_s": move_s,
          "in_new_mesh": small.get_coordinate() is not None}
    if rs["in_new_mesh"]:
        rs["equal"] = all(torch.equal(a.to_local(), b)
                          for a, b in zip(tree_flatten(moved)[0], leaves))
    del params, sharded, moved, leaves, local
    torch.cuda.empty_cache()
    out = {"rank": rank, "collective_matmul": cm, "reshard": rs,
           "launches": {fn.__name__: fn.launches for fn in KERNELS},
           "S1_s": time.perf_counter() - t_rank}
    out["S2"] = s2_rank(mesh)
    out["S2moe"] = s2moe_rank(mesh)
    out["S3"] = s3_rank(mesh)
    out["S4"] = s4_rank(mesh)
    row = DeviceMesh(DEVICE, torch.arange(world).reshape(S5_MESH),
                     mesh_dim_names=("data", "model"))
    out["S4tp"] = s4_rank(row)
    out["S5"] = s5_rank(row, s5_ref)
    out["S3tp"] = s3tp_rank(row)
    return out


# S2-S4: the step builders of launch/steps in the same world (mesh (2, 1),
# ("data", "model"), batch over data).  S2: T1 sharded, FSDP: flux-mmdit at
# every published width and 2 of 38 blocks, batch 2 (1 a rank), 4096
# vision + 512 text tokens, S2["steps"] steps of build_train_step under the
# default rules in f32, T1's AdamW; held against make_step_fn's unsharded
# step on the same batches (run on rank 0 after the sharded state is
# freed): loss and grad_norm within S2_REL relative at every step, every
# parameter after the last step within S2_REL of the largest parameter
# magnitude (each leaf's error over its own largest magnitude is reported
# beside it: AdamW passes the batch-row GEMM rounding of a gradient near its
# eps straight into a move, which shows on the zero-initialised adaln_b).
# S3: build_dit_step at P1's engine config on the same 2-block
# model (bf16 weights, f32 compute), batch 2, Update then Dispatch on the
# states the Update returned: each rank's v and every integer field of its
# states torch.equal to an unsharded denoise_step on its own batch-1 slice,
# and within S3_REL_L2 of the unsharded batch-2 step (cuBLAS rounds by row
# count, ROADMAP C.3); B1-B3 launched S3_LAUNCHES times a rank at Dispatch,
# none at Update; the first B2 call against its plain version.  S4:
# gemma3-1b at full width in bf16 (the reference's serving parameters),
# batch 2, build_prefill_step on S4["prompt"] tokens, then
# S4["decode_steps"] greedy steps of build_decode_step at the following
# positions, rules from rules_for; the greedy tokens equal to the unsharded
# Model.prefill / decode_step's on the same weights, logits within S4_REL of
# their largest magnitude.  S2 and S4 launch no kernel.  S4-tp: S4 on mesh
# (1, 2), the model axis split (tensor parallel over both ranks), held as
# S4 is.  S5: gemma3-1b at full width (26 layers, f32, remat on as
# L-train's "on" case), L-train's batch (1 x 4096 tokens), trained one
# step of build_train_step on mesh (1, 2) (the model axis split), against
# make_step_fn's unsharded step run first in the parent and kept on the
# host (s5_reference): loss and grad_norm within S5_REL relative, AdamW's
# first moment (the clipped gradient times 1 - b1) within S5_REL of its
# largest magnitude on every rank's shard; no kernel.  S2's and S3's peaks
# a rank are printed beside their peaks with every parameter gathered
# whole (S2_PEAK_BEFORE_GB, S3_PEAK_BEFORE_GB, on the H100 at 700 W).
# S2-moe (ROADMAP C.13): mixtral-8x22b smoke (f32), one step of
# build_train_step on mesh (2, 1), its batch split over data (dp 2, so the
# MoE routes the global batch across the ranks), against the unsharded step
# on the global batch on each rank (adamw_update on the whole tree): loss,
# grad_norm and every parameter within S2MOE_REL (of the largest
# magnitude); no kernel.  S3-tp: S3's cell on mesh (1, 2), the model row
# split (12 of 24 heads a rank: B1 on its wq columns, B2 on its heads, B3
# over its head range, the partials summed over the row), Update then
# Dispatch, against the unsharded batch-2 step: the symbols and every
# integer plan field torch.equal (else the first differing layer and field,
# which must follow a Q/K difference there: the ranks' Update Q/K against
# the unsharded Q/K of their heads, as C1's witness), v within
# S3TP_REL_L2; B1-B3 once a layer a rank at Dispatch, none at Update, no
# layer replicated; B3's first call against its plain version over the same
# head range, and the two ranks' B3 partials summed against one B3 over all
# 24 heads (S3TP_B3_TOL).  Its time is not a speed: the row's collectives go
# through CUDA IPC and gloo on one card (ROADMAP C.12).
S2 = dict(n_layers=2, batch=2, seq_len=4096, steps=2)
S2_REL = 1e-4
S3 = dict(n_layers=2, batch=2, n_vision=4096)
S3_REL_L2 = 3e-4
S3_LAUNCHES = 2
S4 = dict(arch="gemma3-1b", batch=2, prompt=256, decode_steps=4)
S4_REL = 2e-2
S5 = dict(arch="gemma3-1b", batch=1, seq_len=4096)
S5_MESH = (1, 2)
S5_REL = 1e-4
S2_PEAK_BEFORE_GB, S3_PEAK_BEFORE_GB = 14.35, 6.68
S2MOE = dict(arch="mixtral-8x22b", batch=2, seq_len=64)
S2MOE_REL = 1e-4
S3TP_REL_L2 = 1e-4
S3TP_B3_TOL = 1e-4


def _launches() -> dict:
    from repro_torch.kernels import KERNELS
    return {fn.__name__: fn.launches for fn in KERNELS}


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def _whole(x):
    """A DTensor gathered whole on every rank."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.sharding import redistribute
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def s2_rank(mesh) -> dict:
    """S2 on one rank: the sharded steps; rank 0 then runs the unsharded
    reference and holds the whole parameter tree to it."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.specs import train_batch_logical
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_step_fn
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_state_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=S2["n_layers"])
    model = get_model(cfg)
    dcfg = DataConfig(seed=0, batch=S2["batch"], seq_len=S2["seq_len"])
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=S2["steps"])   # T1's (train())
    shape = ShapeSpec("S2", S2["seq_len"] + cfg.n_text_tokens, S2["batch"], "train")
    fn = build_train_step(cfg, shape, mesh, R, opt_cfg=opt, dtype=torch.float32)[0]

    def weights():
        g = torch.Generator(device=DEVICE)
        g.manual_seed(0)
        return model.init_params(g, DEVICE)

    t_cell = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params = weights()
    p = reshard_state(params, model.param_specs(), mesh, R)
    o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh, R)
    del params
    steps = []
    for step in range(S2["steps"]):
        b = reshard_state(make_batch(cfg, dcfg, step, device=DEVICE), train_batch_logical(cfg),
                          mesh, R)
        dist.barrier()
        t0 = time.perf_counter()
        p, o, m = fn(p, o, b)
        steps.append({"step": step, "loss": float(m["loss"].to_local()),
                      "grad_norm": float(m["grad_norm"].to_local()),
                      "step_s": time.perf_counter() - t0, **fn.stats})
        del b, m
    launches = _launches()
    res = {"steps": steps, "peak_gb": _peak_gb(), "launches": launches,
           "local_bytes": sum(x.to_local().nbytes for x in tree_leaves(p))}
    whole = [_whole(x) for x in tree_leaves(p)]
    del p, o
    res["sharded_s"] = time.perf_counter() - t_cell
    if mesh.get_coordinate()[0] != 0:
        del whole
        torch.cuda.empty_cache()
        dist.barrier()                   # rank 0 runs the reference
        res["seconds"] = time.perf_counter() - t_cell
        return res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_step_fn(model, opt, dcfg, cfg, dtype=torch.float32, device=DEVICE)
    params = weights()
    state, want = (params, adamw_init(params)), []
    del params
    for step in range(S2["steps"]):
        state, met = step_fn(state, step)
        want.append((met["loss"], met["grad_norm"]))
    res["reference_peak_gb"] = _peak_gb()
    ref = tree_leaves(state[0])
    diffs = [float((a - b).abs().max()) for a, b in zip(whole, ref)]
    scales = [float(b.abs().max()) for b in ref]
    res["reference"] = want
    res["loss_rel"] = max(abs(s["loss"] - w[0]) / abs(w[0]) for s, w in zip(steps, want))
    res["grad_norm_rel"] = max(abs(s["grad_norm"] - w[1]) / abs(w[1])
                               for s, w in zip(steps, want))
    res["param_abs"] = max(diffs)
    res["param_rel"] = max(diffs) / max(scales)
    res["param_rel_by_leaf"] = [d / max(m, 1e-30) for d, m in zip(diffs, scales)]
    del state, ref, whole
    torch.cuda.empty_cache()
    dist.barrier()
    res["seconds"] = time.perf_counter() - t_cell
    return res


def _int_fields(st) -> list:
    """The integer (and boolean) tensors of one layer's state."""
    out = [st.s_c, st.s_s]
    out += [t for f in st.plan._fields
            if (t := getattr(st.plan, f)) is not None and not t.dtype.is_floating_point]
    return out


def s3_rank(mesh) -> dict:
    """S3 on one rank: the sharded Update and Dispatch steps, then this
    rank's slice alone and the whole batch unsharded."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.launch.specs import dit_inputs_logical
    from repro_torch.models import dit
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=S3["n_layers"])
    ecfg = serving_engine_config()
    b, n_tok = S3["batch"], S3["n_vision"] + cfg.n_text_tokens
    shape = ShapeSpec("S3", n_tok, b, "serve")
    t_cell = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, xe, text, t = profile_inputs(cfg, b, S3["n_vision"])
    params = tree_map(lambda w: w.to(torch.bfloat16), params)
    p = reshard_state(params, dit.param_specs(cfg), mesh, R)
    x = reshard_state({"x_vision": xe, "text_emb": text, "t": t}, dit_inputs_logical(cfg),
                      mesh, R)
    spec = dit.engine_state_specs(cfg, ecfg)
    states = ST.place_states(dit.init_engine_states(cfg, ecfg, b, n_tok, DEVICE), spec, mesh, R)
    run = {}
    for mode in ("update", "dispatch"):
        fn = ST.build_dit_step(cfg, shape, mesh, R, mode=mode, ecfg=ecfg,
                               dtype=torch.float32)[0]
        reset_launches()
        t0 = time.perf_counter()
        (v, states), call = first_b2_call(lambda: fn(p, states, x))
        run[mode] = {"v": v, "states": states, "s": time.perf_counter() - t0,
                     "stats": dict(fn.stats), "launches": _launches(), "call": call}
    res = {"peak_gb": _peak_gb(), "b2_vs_plain": b2_vs_plain(run["dispatch"]["call"])}
    d = mesh.get_coordinate()[0]
    sl = slice(d, d + 1)
    compute = ST._compute_placements(ST._state_tree(spec), mesh, R)
    local = lambda sts: [ST._state_from_tree(tree_map(ST._to_local, ST._state_tree(s), compute,
                                                      is_leaf=ST._is_pl), s) for s in sts]
    one = dit.init_engine_states(cfg, ecfg, 1, n_tok, DEVICE)
    two = dit.init_engine_states(cfg, ecfg, b, n_tok, DEVICE)
    for mode in ("update", "dispatch"):
        r = run[mode]
        v1, one = dit.denoise_step(params, cfg, ecfg, one, xe[sl], text[sl], t[sl], mode=mode,
                                   dtype=torch.float32)
        v2, two = dit.denoise_step(params, cfg, ecfg, two, xe, text, t, mode=mode,
                                   dtype=torch.float32)
        mine, v = local(r["states"]), r["v"].to_local()
        fields = [(a, c, w[sl]) for m, o, w_st in zip(mine, one, two)
                  for a, c, w in zip(_int_fields(m), _int_fields(o), _int_fields(w_st))]
        res[mode] = {
            "s": r["s"], **r["stats"], "launches": r["launches"],
            "v_equal_slice": bool(torch.equal(v, v1)),
            "int_fields_equal_slice": all(torch.equal(a, c) for a, c, _ in fields),
            "int_fields": len(fields),
            "int_fields_differing_batch2": sum(not torch.equal(a, w) for a, _, w in fields),
            "sq_diff_batch2": float((v.float() - v2[sl].float()).square().sum()),
            "sq_batch2": float(v2[sl].float().square().sum()),
            "finite": bool(torch.isfinite(v).all())}
        one, two = list(one), list(two)
    del run, p, x, states, params, one, two
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_cell
    return res


def s2moe_rank(mesh) -> dict:
    """S2-moe on one rank: one sharded train step of mixtral smoke with its
    batch split over data, then the unsharded step on the global batch."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.specs import train_batch_logical
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import (AdamWConfig, adamw_init, adamw_state_specs,
                                             adamw_update)
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
    t_cell = time.perf_counter()
    cfg = get_smoke(S2MOE["arch"])
    model = get_model(cfg)
    b, n = S2MOE["batch"], S2MOE["seq_len"]
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = model.init_params(g, DEVICE)
    tok = lambda: torch.randint(0, cfg.vocab, (b, n), generator=g, device=DEVICE,
                                dtype=torch.int32)
    batch = {"tokens": tok(), "labels": tok()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    fn = build_train_step(cfg, ShapeSpec("S2moe", n, b, "train"), mesh, R, opt_cfg=opt,
                          dtype=torch.float32)[0]
    p = reshard_state(params, model.param_specs(), mesh, R)
    o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh, R)
    bd = reshard_state(batch, train_batch_logical(cfg), mesh, R)
    reset_launches()
    t0 = time.perf_counter()
    p, o, m = fn(p, o, bd)
    torch.cuda.synchronize()
    res = {"config": {**S2MOE, "mesh": list(mesh.mesh.shape)},
           "step_s": time.perf_counter() - t0, "launches": _launches(),
           "loss": float(m["loss"].to_local()), "grad_norm": float(m["grad_norm"].to_local())}
    leaves, tdef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.train_loss(tree_unflatten(tdef, leaves), batch, dtype=torch.float32)
    grads = tree_unflatten(tdef, list(torch.autograd.grad(loss, leaves)))
    want, _, gnorm = adamw_update(grads, adamw_init(params), params, opt)
    loss = float(loss.detach())
    res["loss_rel"] = abs(res["loss"] - loss) / abs(loss)
    res["grad_norm_rel"] = abs(res["grad_norm"] - float(gnorm)) / abs(float(gnorm))
    got = [_whole(x) for x in tree_leaves(p)]
    res["param_rel"] = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                           for a, c in zip(got, tree_leaves(want)))
    res["seconds"] = time.perf_counter() - t_cell
    return res


def first_b3_call(run):
    """``run()`` with the engine backend's B3 wrapper kept, as it launches,
    with the inputs and output of its first call copied to the host (so
    the step's peak holds none of them; None if B3 did not run)."""
    from repro_torch.core import backend
    kern, seen = backend.gemm_o_sparse_kernel, []

    def keep(*args, **kw):
        out = kern(*args, **kw)
        if not seen:
            seen.append((tuple(a.cpu() for a in args), kw, out.cpu()))
        return out

    backend.gemm_o_sparse_kernel = keep
    try:
        return run(), (seen[0] if seen else None)
    finally:
        backend.gemm_o_sparse_kernel = kern


def b3_range_work(call) -> dict:
    """The work of a kept B3 call over its head range, in the keys of
    ``analysis.cost_model.kernel_cost``: the live (row, head) pairs and the
    heads used inside the range (the lists, whole, are read all the same)."""
    import torch
    (o, w, bias, row_ids, head_ids, head_cnt), kw, _ = call
    b, h, n, dh = o.shape
    hp, lo = head_ids.shape[-1], kw["h_lo"]
    listed = torch.arange(hp, device=o.device) < head_cnt[..., None]
    mine = listed & (head_ids >= lo) & (head_ids < lo + h)
    return {"live_heads": int(mine.sum()),
            "heads_used": int(torch.unique(head_ids[mine]).numel()),
            "block": kw["block_rows"], "dh": dh, "f": w.shape[-1], "b": b, "n": n,
            "cr": row_ids.shape[-1], "h": hp}


def b3_range_checks(call, mesh) -> dict:
    """A rank's first B3 call over its head range against the plain
    version, timed (each rank in turn, the other waiting) beside its bound
    on the range's live heads; and the row's partials summed against one B3
    over every head (its inputs gathered over the row: O and W by heads, the
    bias rank 0's, the one that holds the forecast)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import gemm_o_sparse_kernel
    from repro_torch.kernels.ref import gemm_o_ref
    (o, w, bias, row_ids, head_ids, head_cnt), kw, out = call
    o, w, bias, row_ids, head_ids, head_cnt, out = (
        t.to(DEVICE) for t in (o, w, bias, row_ids, head_ids, head_cnt, out))
    call = ((o, w, bias, row_ids, head_ids, head_cnt), kw, out)
    group = mesh.get_group("model")
    m, me = dist.get_world_size(group), dist.get_rank(group)
    timed_row = None
    for turn in range(m):
        dist.barrier(group)
        if turn == me:
            timed_row = measure(
                "gemm_o_sparse_kernel", str(o.dtype).removeprefix("torch."),
                lambda: gemm_o_sparse_kernel(o, w, bias, row_ids, head_ids, head_cnt, **kw),
                lambda: gemm_o_ref(o, w, bias, row_ids, head_ids, head_cnt,
                                   block=kw["block_rows"], h_lo=kw["h_lo"]),
                None, b3_range_work(call), peaks_for(torch.cuda.get_device_name(0)))
        torch.cuda.synchronize()
    want = gemm_o_ref(o, w, bias, row_ids, head_ids, head_cnt, block=kw["block_rows"],
                      h_lo=kw["h_lo"])
    err = (out.float() - want.float()).abs()
    parts = lambda x: [torch.empty_like(x) for _ in range(m)]
    outs, os_, ws = parts(out), parts(o), parts(w)
    dist.all_gather(outs, out.contiguous(), group=group)
    dist.all_gather(os_, o.contiguous(), group=group)
    dist.all_gather(ws, w.contiguous(), group=group)
    bias0 = bias.clone()
    dist.broadcast(bias0, dist.get_global_rank(group, 0), group=group)
    whole = gemm_o_sparse_kernel(torch.cat(os_, dim=1), torch.cat(ws), bias0, row_ids, head_ids,
                                 head_cnt, block_rows=kw["block_rows"])
    summed = (sum(x.float() for x in outs) - whole.float()).abs()
    tol = lambda e, ref: float((e / (S3TP_B3_TOL + S3TP_B3_TOL * ref.float().abs())).max())
    return {"o": list(o.shape), "w": list(w.shape), "h_lo": kw["h_lo"],
            "heads_listed": head_ids.shape[-1], "max_abs_err": float(err.max()),
            "tol_share": tol(err, want), "summed_max_abs_err": float(summed.max()),
            "summed_tol_share": tol(summed, whole), "tolerance": S3TP_B3_TOL,
            "finite": bool(torch.isfinite(out).all()),
            "timed": {k: timed_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "flops", "bytes")},
            "work": b3_range_work(call)}


def s3tp_rank(mesh) -> dict:
    """S3-tp on one rank: the unsharded batch-2 Update and Dispatch steps
    first (what the checks need kept on the host), then S3's cell with the
    model row split, each step's peak taken with only the step's own
    tensors and its inputs alive on the card."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.core import engine as E
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.launch.specs import dit_inputs_logical
    from repro_torch.models import dit
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=S3["n_layers"])
    ecfg = serving_engine_config()
    b, n_tok = S3["batch"], S3["n_vision"] + cfg.n_text_tokens
    shape = ShapeSpec("S3tp", n_tok, b, "serve")
    t_cell = time.perf_counter()
    torch.cuda.empty_cache()
    h = cfg.n_heads // mesh.size(1)
    hs = slice(mesh.get_coordinate()[1] * h, (mesh.get_coordinate()[1] + 1) * h)
    row_calls = {"sum": 0, "all_gather": 0}
    kept_row = {k: getattr(TP._Row, k) for k in row_calls}
    kept_qk, qk = E._qk, {"split": [], "whole": []}

    def counted(name):
        def call(self, *a, **kw):
            row_calls[name] += 1
            return kept_row[name](self, *a, **kw)
        return call

    def keep_qk(into, heads):
        def call(*a, **kw):
            q, k = kept_qk(*a, **kw)
            qk[into].append((q[:, heads].cpu(), k[:, heads].cpu()))
            return q, k
        return call

    params, xe, text, t = profile_inputs(cfg, b, S3["n_vision"])
    params = tree_map(lambda w: w.to(torch.bfloat16), params)
    want, two = {}, dit.init_engine_states(cfg, ecfg, b, n_tok, DEVICE)
    for mode in ("update", "dispatch"):
        E._qk = keep_qk("whole", hs) if mode == "update" else kept_qk
        try:
            v2, two = dit.denoise_step(params, cfg, ecfg, two, xe, text, t, mode=mode,
                                       dtype=torch.float32)
        finally:
            E._qk = kept_qk
        two = list(two)
        want[mode] = {"v": v2.cpu(), "ints": [[a.cpu() for a in _int_fields(st)] for st in two]}
    del two, v2
    # The step's inputs own their memory (a narrowing reshard is a view of
    # the whole tensor), so only they are alive on the card at its call.
    own = lambda tree: tree_map(lambda d: ST._dtensor(d.to_local().clone(), mesh, d.placements,
                                                      d.shape), tree)
    p = own(reshard_state(params, dit.param_specs(cfg), mesh, R))
    x = own(reshard_state({"x_vision": xe, "text_emb": text, "t": t}, dit_inputs_logical(cfg),
                          mesh, R))
    spec = dit.engine_state_specs(cfg, ecfg)
    states = [ST._state_from_tree(own(ST._state_tree(st)), st) for st in ST.place_states(
        dit.init_engine_states(cfg, ecfg, b, n_tok, DEVICE), spec, mesh, R)]
    del params, xe, text, t
    torch.cuda.empty_cache()
    compute = ST._compute_placements(ST._state_tree(spec), mesh, R)
    local = lambda sts: [ST._state_from_tree(tree_map(ST._to_local, ST._state_tree(s), compute,
                                                      is_leaf=ST._is_pl), s) for s in sts]
    res = {"mesh": list(mesh.mesh.shape),
           "block_gb_a_rank": sum(y.to_local().nbytes for y in tree_leaves(p["blocks"]))
           / S3["n_layers"] / 1e9}
    call = None
    for mode in ("update", "dispatch"):
        fn = ST.build_dit_step(cfg, shape, mesh, R, mode=mode, ecfg=ecfg,
                               dtype=torch.float32)[0]
        for k in row_calls:
            row_calls[k] = 0
            setattr(TP._Row, k, counted(k))
        E._qk = keep_qk("split", slice(None)) if mode == "update" else kept_qk
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        entry = torch.cuda.memory_allocated() / 1e9
        try:
            t0 = time.perf_counter()
            (v, states), call = first_b3_call(lambda: fn(p, states, x))
            sec = time.perf_counter() - t0
        finally:
            E._qk = kept_qk
            for k, f in kept_row.items():
                setattr(TP._Row, k, f)
        peak, launches = _peak_gb(), _launches()
        mine, w = local(states), want[mode]
        first = next(((li, fi) for li, (a_st, w_st) in enumerate(zip(mine, w["ints"]))
                      for fi, (a, c) in enumerate(zip(_int_fields(a_st), w_st))
                      if not torch.equal(a.cpu(), c)), None)
        vl = v.to_local().float().cpu()
        res[mode] = {
            "s": sec, **fn.stats, "entry_gb": entry, "peak_gb": peak, "launches": launches,
            "row_collectives": dict(row_calls),
            "int_fields": sum(len(_int_fields(st)) for st in mine),
            "first_int_difference": first,
            "rel_l2": float((vl - w["v"].float()).norm() / w["v"].float().norm()),
            "finite": bool(torch.isfinite(vl).all())}
        del mine, v
    res["peak_gb"] = max(res[m]["peak_gb"] for m in ("update", "dispatch"))
    res["update"]["qk_diff"] = [
        max(float((qs - qw).abs().max()), float((ks - kw_).abs().max()))
        for (qs, ks), (qw, kw_) in zip(qk["split"], qk["whole"])]
    res["b3"] = b3_range_checks(call, mesh)
    del p, x, states, call, qk, want
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_cell
    return res


def s4_rank(mesh) -> dict:
    """S4 on one rank: the sharded prefill and decode; rank 0 then runs the
    unsharded ones."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import rules_for
    from repro_torch.launch.specs import prefill_batch_logical
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_map
    cfg = get_config(S4["arch"])
    model = get_model(cfg)
    b, n, k = S4["batch"], S4["prompt"], S4["decode_steps"]
    pre_rules = rules_for(cfg, SHAPES["prefill_32k"], multi_pod=False)
    dec_rules = rules_for(cfg, SHAPES["decode_32k"], multi_pod=False)
    t_cell = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = tree_map(lambda w: w.to(torch.bfloat16), model.init_params(g, DEVICE))
    tokens = torch.randint(0, cfg.vocab, (b, n), generator=g, device=DEVICE, dtype=torch.int32)
    pre = ST.build_prefill_step(cfg, ShapeSpec("S4", n, b, "prefill"), mesh, pre_rules)[0]
    dec, _, dec_pl, _ = ST.build_decode_step(cfg, ShapeSpec("S4", n + k, b, "decode"), mesh,
                                             dec_rules)
    p = reshard_state(params, model.param_specs(), mesh, pre_rules)
    batch = reshard_state({"tokens": tokens}, prefill_batch_logical(cfg), mesh, pre_rules)
    cache = reshard_state(model.init_cache(b, n + k, device=DEVICE), model.cache_specs(), mesh,
                          dec_rules)
    reset_launches()
    t0 = time.perf_counter()
    logits = pre(p, batch)
    res = {"prefill": {"s": time.perf_counter() - t0, **pre.stats}, "decode": []}
    got_logits, got_tokens = [_whole(logits)], []
    for i in range(k):
        tok = DTensor.from_local(logits.to_local().argmax(-1).to(torch.int32), mesh, dec_pl[2],
                                 run_check=False)
        got_tokens.append(_whole(tok))
        t0 = time.perf_counter()
        logits, cache = dec(p, cache, tok, n + i)
        res["decode"].append({"s": time.perf_counter() - t0, **dec.stats})
        got_logits.append(_whole(logits))
    res["launches"] = _launches()
    res["peak_gb"] = _peak_gb()
    del p, batch, cache, logits
    torch.cuda.empty_cache()
    if torch.distributed.get_rank() == 0:
        with torch.no_grad():
            want = [model.prefill(params, {"tokens": tokens})]
            cache = model.init_cache(b, n + k, device=DEVICE)
            want_tokens = []
            for i in range(k):
                want_tokens.append(want[-1].argmax(-1).to(torch.int32))
                logits, cache = model.decode_step(params, cache, want_tokens[-1], n + i)
                want.append(logits)
        res["tokens_equal"] = all(torch.equal(a, c) for a, c in zip(got_tokens, want_tokens))
        res["first_differing_step"] = next(
            (i for i, (a, c) in enumerate(zip(got_tokens, want_tokens)) if not torch.equal(a, c)),
            None)
        res["logits_rel"] = max(rel_err(a, c) for a, c in zip(got_logits, want))
        res["tokens"] = [x.tolist() for x in got_tokens]
        del cache, want
    del params
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_cell
    res["mesh"] = list(mesh.mesh.shape)
    return res


def _s5_setup():
    """S5's config, weights (seed 0), batch (L-train's) and optimizer."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig
    cfg = get_config(S5["arch"])
    dcfg = DataConfig(seed=0, batch=S5["batch"], seq_len=S5["seq_len"])
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    params = get_model(cfg).init_params(g, DEVICE)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=LTRAIN_STEPS + 1)   # L-train's
    return cfg, dcfg, params, make_batch(cfg, dcfg, 0, device=DEVICE), opt


def s5_reference(path: Path) -> dict:
    """S5's unsharded step in this process (``make_step_fn``, as L-train
    runs it): its loss, grad_norm and AdamW first moment written to
    ``path`` on the host, everything freed on the card; returns its
    seconds and peak."""
    import torch
    from repro_torch.launch.train import make_step_fn
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.tree import tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, dcfg, params, _, opt = _s5_setup()
    step_fn = make_step_fn(get_model(cfg), opt, dcfg, cfg, dtype=torch.float32, device=DEVICE)
    state = (params, adamw_init(params))
    del params
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    state, met = step_fn(state, 0)
    torch.cuda.synchronize()
    rec = {"step_s": time.perf_counter() - t_step, "peak_gb": _peak_gb(),
           "loss": met["loss"], "grad_norm": met["grad_norm"]}
    torch.save({"loss": met["loss"], "grad_norm": met["grad_norm"],
                "mu": [t.cpu() for t in tree_leaves(state[1]["mu"])]}, path)
    del state, step_fn
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def s5_rank(mesh, ref_path: str) -> dict:
    """S5 on one rank: one sharded train step of gemma3-1b at full width
    with the model axis split, held to the unsharded step's record."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.specs import train_batch_logical
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model, param_count
    from repro_torch.optim.optimizer import adamw_init, adamw_state_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves
    t_cell = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, _, params, batch, opt = _s5_setup()
    model = get_model(cfg)
    fn = build_train_step(cfg, ShapeSpec("S5", S5["seq_len"], S5["batch"], "train"), mesh, R,
                          opt_cfg=opt, dtype=torch.float32)[0]
    p = reshard_state(params, model.param_specs(), mesh, R)
    o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh, R)
    b = reshard_state(batch, train_batch_logical(cfg), mesh, R)
    del params, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dist.barrier()
    t0 = time.perf_counter()
    p, o, m = fn(p, o, b)
    torch.cuda.synchronize()
    res = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers, "remat": cfg.remat,
                      "n_params": param_count(cfg), "mesh": list(S5_MESH), **S5},
           "step_s": time.perf_counter() - t0, **fn.stats, "peak_gb": _peak_gb(),
           "launches": _launches(), "loss": float(m["loss"].to_local()),
           "grad_norm": float(m["grad_norm"].to_local()),
           "local_bytes": sum(x.to_local().nbytes for x in tree_leaves(p))}
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    res["loss_rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
    res["grad_norm_rel"] = abs(res["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    diff = scale = 0.0
    for x, want in zip(tree_leaves(o["mu"]), ref["mu"]):
        shape, off = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
        want = want[tuple(slice(a, a + n) for a, n in zip(off, shape))].to(DEVICE)
        diff = max(diff, float((x.to_local() - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    del ref, p, o, b, m
    torch.cuda.empty_cache()
    res["grad_abs"] = diff
    res["grad_rel"] = diff / max(scale, 1e-30)
    res["seconds"] = time.perf_counter() - t_cell
    return res


def phase_sharding() -> tuple[dict, dict]:
    """The ``sharding`` phase: two ranks on the card over ``gloo``.  Fails if
    a rank fails, the collective matmul lies beyond SHARD_ATOL of the local
    product, the resharded parameters are not ``torch.equal`` to the
    unsharded ones on the surviving rank, a kernel launched in S1, S2 or S4,
    or a check of S2-S5 fails.  S5's unsharded step runs here first, its
    results kept in a file on the host for the ranks.  Returns the launch
    counts of the paths ``sharding`` (S1), S2, S3 (its Update and Dispatch
    steps), S2-moe, S3-tp, S4, S4-tp and S5, each rank 0's, and rank 0's
    record."""
    import tempfile
    import torch
    torch.cuda.empty_cache()
    from repro_torch.launch.mesh import run_local_mesh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s5_") as tmp:
        ref_path = Path(tmp) / "s5_reference.pt"
        s5_ref = s5_reference(ref_path)
        ranks = run_local_mesh(sharding_rank, *SHARD_MESH, str(ref_path),
                               timeout=SHARD_JOIN_S)
    res = {"phase": "sharding", "transport": "gloo", "ranks": ranks, "S5_reference": s5_ref,
           "seconds": time.perf_counter() - t0}
    emit(res)
    faults = []
    for r in ranks:
        cm, rs = r["collective_matmul"], r["reshard"]
        if not cm["max_abs_err"] <= SHARD_ATOL:
            faults.append(f"rank {r['rank']}: collective matmul {cm['max_abs_err']:.3e} off")
        if rs["in_new_mesh"] and not rs["equal"]:
            faults.append(f"rank {r['rank']}: the resharded parameters differ")
        if any(r["launches"].values()):
            faults.append(f"rank {r['rank']} launched kernels: {r['launches']}")
    if sum(r["reshard"]["in_new_mesh"] for r in ranks) != 1:
        faults.append("the shrunk mesh does not hold exactly one rank")
    faults += sharding_step_faults(ranks)
    if faults:
        raise AssertionError("sharding: " + "; ".join(faults))
    both = lambda rec: {name: n + rec["dispatch"]["launches"][name]
                        for name, n in rec["update"]["launches"].items()}
    return {"sharding": ranks[0]["launches"], "S2": ranks[0]["S2"]["launches"],
            "S2moe": ranks[0]["S2moe"]["launches"], "S3": both(ranks[0]["S3"]),
            "S3tp": both(ranks[0]["S3tp"]),
            "S4": ranks[0]["S4"]["launches"], "S4tp": ranks[0]["S4tp"]["launches"],
            "S5": ranks[0]["S5"]["launches"]}, ranks[0]


def s3tp_faults(r) -> list:
    """The failed checks of one rank's S3-tp (the witness of an integer
    difference is checked over the ranks in :func:`sharding_step_faults`)."""
    rank, t3, faults = r["rank"], r["S3tp"], []
    want = {name: S3["n_layers"] if name in P1_KERNELS else 0 for name in SOURCES}
    if t3["dispatch"]["launches"] != want:
        faults.append(f"rank {rank}: S3-tp Dispatch launches {t3['dispatch']['launches']}")
    for mode in ("update", "dispatch"):
        m = t3[mode]
        if not (m["rel_l2"] <= S3TP_REL_L2 and m["finite"]):
            faults.append(f"rank {rank}: S3-tp {mode} rel-L2 {m['rel_l2']:.2e} against the "
                          "unsharded batch-2 step")
        if m["tp_replicated"]:
            faults.append(f"rank {rank}: S3-tp {mode} computed replicated: "
                          f"{m['tp_replicated']}")
    b3 = t3["b3"]
    if not (b3["finite"] and b3["tol_share"] <= 1 and b3["summed_tol_share"] <= 1):
        faults.append(f"rank {rank}: S3-tp B3 over its head range {b3}")
    return faults


def sharding_step_faults(ranks) -> list:
    """The failed checks of S2-S5 (a summary line goes to stderr)."""
    import math
    faults = []
    s3_sq = [sum(r["S3"][m][k] for r in ranks) for m in ("dispatch",)
             for k in ("sq_diff_batch2", "sq_batch2")]
    s3_rel = math.sqrt(s3_sq[0] / max(s3_sq[1], 1e-30))
    ref = ranks[0]["S2"]
    if not (ref["loss_rel"] <= S2_REL and ref["grad_norm_rel"] <= S2_REL):
        faults.append(f"S2: loss/grad_norm {ref['loss_rel']:.2e}/{ref['grad_norm_rel']:.2e} "
                      "off the unsharded step")
    if not ref["param_rel"] <= S2_REL:
        faults.append(f"S2: parameters {ref['param_rel']:.2e} off the unsharded step's")
    metric = lambda s2: [(x["loss"], x["grad_norm"]) for x in s2["steps"]]
    for r in ranks:
        rank, s2, s3, s4, s5 = r["rank"], r["S2"], r["S3"], r["S4"], r["S5"]
        if metric(s2) != metric(ref):
            faults.append(f"rank {rank}: S2 loss/grad_norm differ from rank 0's")
        for path, launches in (("S2", s2["launches"]), ("S4", s4["launches"]),
                               ("S4-tp", r["S4tp"]["launches"]), ("S5", s5["launches"]),
                               ("S3 update", s3["update"]["launches"]),
                               ("S2-moe", r["S2moe"]["launches"]),
                               ("S3-tp update", r["S3tp"]["update"]["launches"])):
            if any(launches.values()):
                faults.append(f"rank {rank}: {path} launched kernels: {launches}")
        faults += s3tp_faults(r)
        moe = r["S2moe"]
        if not (moe["loss_rel"] <= S2MOE_REL and moe["grad_norm_rel"] <= S2MOE_REL
                and moe["param_rel"] <= S2MOE_REL):
            faults.append(f"rank {rank}: S2-moe loss/grad_norm/parameters {moe['loss_rel']:.2e}/"
                          f"{moe['grad_norm_rel']:.2e}/{moe['param_rel']:.2e} off the "
                          "unsharded step")
        want = {name: S3_LAUNCHES if name in P1_KERNELS else 0 for name in SOURCES}
        if s3["dispatch"]["launches"] != want:
            faults.append(f"rank {rank}: S3 Dispatch launches {s3['dispatch']['launches']}")
        for mode in ("update", "dispatch"):
            m = s3[mode]
            if not (m["v_equal_slice"] and m["int_fields_equal_slice"] and m["finite"]):
                faults.append(f"rank {rank}: S3 {mode} differs from its slice alone")
        if not b2_agrees(s3["b2_vs_plain"]):
            faults.append(f"rank {rank}: S3 B2 against its plain version: {s3['b2_vs_plain']}")
        for label, rec in (("S4", s4), ("S4-tp", r["S4tp"])):
            if "tokens_equal" in rec and not (rec["tokens_equal"]
                                              and rec["logits_rel"] <= S4_REL):
                faults.append(f"{label}: tokens equal {rec['tokens_equal']} (first differing "
                              f"step {rec['first_differing_step']}), logits "
                              f"{rec['logits_rel']:.2e}")
        if not (s5["loss_rel"] <= S5_REL and s5["grad_norm_rel"] <= S5_REL
                and s5["grad_rel"] <= S5_REL):
            faults.append(f"rank {rank}: S5 loss/grad_norm/gradients {s5['loss_rel']:.2e}/"
                          f"{s5['grad_norm_rel']:.2e}/{s5['grad_rel']:.2e} off the unsharded "
                          "step")
        if (s5["loss"], s5["grad_norm"]) != (ranks[0]["S5"]["loss"], ranks[0]["S5"]["grad_norm"]):
            faults.append(f"rank {rank}: S5 loss/grad_norm differ from rank 0's")
    if not s3_rel <= S3_REL_L2:
        faults.append(f"S3: rel-L2 {s3_rel:.3e} against the unsharded batch-2 step")
    firsts = {r["S3tp"]["update"]["first_int_difference"] for r in ranks} - {None}
    if firsts:
        layer = min(firsts)[0]
        if not any(r["S3tp"]["update"]["qk_diff"][layer] > 0 for r in ranks):
            faults.append(f"S3-tp: an integer field differs first at {min(firsts)} where no "
                          "rank's Update Q/K differs from the unsharded step's")
    r0 = ranks[0]
    print(f"chip_smoke: S2 peak {r0['S2']['peak_gb']:.2f} GB a rank (whole gather "
          f"{S2_PEAK_BEFORE_GB}), max gathered "
          f"{r0['S2']['steps'][-1]['max_gathered_bytes'] / 1e9:.3f} GB; S3 peak "
          f"{r0['S3']['peak_gb']:.2f} GB ({S3_PEAK_BEFORE_GB}); S4-tp tokens equal "
          f"{r0['S4tp'].get('tokens_equal')}; S5 step {r0['S5']['step_s']:.2f} s, peak "
          f"{[round(r['S5']['peak_gb'], 2) for r in ranks]} GB, gradients "
          f"{r0['S5']['grad_rel']:.2e}", file=sys.stderr, flush=True)
    t3 = r0["S3tp"]
    print(f"chip_smoke: S3-tp update {t3['update']['s']:.3f} s, dispatch "
          f"{t3['dispatch']['s']:.3f} s, max gathered "
          f"{t3['dispatch']['max_gathered_bytes'] / 1e9:.3f} GB, row collectives "
          f"{t3['update']['row_collectives']} / {t3['dispatch']['row_collectives']}, peak "
          f"{t3['peak_gb']:.2f} GB, rel-L2 {t3['dispatch']['rel_l2']:.2e}, first int difference "
          f"{t3['update']['first_int_difference']}, B3 {t3['b3']['tol_share']:.2e} / summed "
          f"{t3['b3']['summed_tol_share']:.2e} of tolerance; S2-moe step "
          f"{r0['S2moe']['step_s']:.2f} s, loss {r0['S2moe']['loss_rel']:.1e}",
          file=sys.stderr, flush=True)
    print(f"chip_smoke: S2 steps {[round(s['step_s'], 3) for s in ranks[0]['S2']['steps']]} s, "
          f"S3 rel-L2 {s3_rel:.3e}, S4 decode "
          f"{[round(d['s'], 3) for d in ranks[0]['S4']['decode']]} s", file=sys.stderr,
          flush=True)
    return faults


def dispatch_steps(sched, dense=False) -> int:
    """The schedule's Dispatch steps; fails unless a served path's schedule
    has ``STEPS`` steps and ``DISPATCH_STEPS`` of them Dispatch, or none
    under ``force_dense``."""
    from repro_torch.core.schedule import MODE_DISPATCH
    n, want = int((sched.mode == MODE_DISPATCH).sum()), 0 if dense else DISPATCH_STEPS
    if sched.mode.shape[0] != STEPS or n != want:
        raise AssertionError(f"resolved schedule has {sched.mode.shape[0]} steps, {n} "
                             f"Dispatch; expected {STEPS} steps, {want} Dispatch")
    return n


def request_record(rid, r) -> dict:
    """One served request: latency, the latents' shape and finiteness, the
    mean Dispatch density and each step's kind and seconds."""
    import torch
    out = r["out"]
    dens = [s["density"] for s in r["trace"] if s["kind"] == "dispatch"]
    return {"rid": rid, "latency_s": r["latency"], "shape": list(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "mean_dispatch_density": sum(dens) / len(dens) if dens else None,
            "kinds": [s["kind"] for s in r["trace"]],
            "step_s": [s["seconds"] for s in r["trace"]]}


def check_served(res, records, shape, expected) -> dict:
    """Fails (after printing ``res``) unless every request gave finite
    latents of ``shape`` and the kernels of ``expected`` (name -> launches)
    each launched that often and every other kernel never."""
    from repro_torch.kernels import KERNELS
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    res["launches"] = launches
    res["expected_launches"] = {name: expected.get(name, 0) for name in launches}
    if not all(r["finite"] and r["shape"] == shape for r in records):
        emit(res)
        raise AssertionError(f"{res.get('phase', res.get('run'))} produced non-finite or "
                             "misshapen latents")
    if launches != res["expected_launches"]:
        emit(res)
        raise AssertionError(f"{res.get('phase', res.get('run'))}: kernel launches "
                             f"{launches}, expected {res['expected_launches']}")
    return launches


def serve_path(phase, expected, n_requests, arch, batch, n_vision, steps=STEPS,
               **kw) -> tuple[dict, dict, dict]:
    """``serve_diffusion`` at full width with every launch count set to 0 just
    before and read just after; fails unless the path's kernels each
    launched (layers x Dispatch steps x requests) times and every other
    kernel never.  Returns the result line, the launches and the results by
    request (``launch.batching``'s: latents, trace, latency, plans)."""
    import torch
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.serve import get_config, serve_diffusion, serving_engine_config
    cfg = get_config(arch)
    ecfg = serving_engine_config(kw.get("strategy", "flashomni"), kw.get("kv_buckets", 1))
    want = cfg.n_layers * dispatch_steps(resolve_schedule(
        ecfg, steps, cfg.n_layers, schedule=kw.get("schedule"))) * n_requests
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = serve_diffusion(arch, smoke=False, n_vision=n_vision, batch=batch,
                              num_requests=n_requests, num_steps=steps, device=DEVICE,
                              verbose=False, **kw)
    wall = time.perf_counter() - t0
    reqs = [request_record(rid, r) for rid, r in sorted(results.items())]
    res = {"phase": phase, "arch": arch, "layers": cfg.n_layers, "batch": batch,
           "n_vision": n_vision, "steps": steps, **kw, "wall_s": wall, "requests": reqs,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches = check_served(res, reqs, [batch, n_vision, cfg.patch_dim],
                            {name: want for name in expected})
    return res, launches, results


def serve_request(run, cfg, ecfg, inputs, expected=(), dtype="float32",
                  dense=False) -> tuple[dict, object]:
    """Request 0 of ``inputs`` (``launch.serve.serving_inputs``: the weights,
    latents, text and patch embedding that ``serve_diffusion`` draws from the
    same seed) through ``run_sequential`` in ``dtype``; ``dense`` serves the
    force_dense baseline.  Launch counts as in :func:`serve_path`: a dense
    run must launch no kernel.  Returns the record and the latents."""
    import torch
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.batching import run_sequential
    params, patch_embed, (req,) = inputs
    sched = resolve_schedule(ecfg, req.num_steps, cfg.n_layers, force_dense=dense)
    want = cfg.n_layers * dispatch_steps(sched, dense)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = run_sequential(params, cfg, ecfg, [dataclasses.replace(req, schedule=sched)],
                       patch_embed=patch_embed, scfg_dtype=getattr(torch, dtype))[req.rid]
    rec = {"run": run, "dtype": dtype, "force_dense": dense,
           "strategy": ecfg.strategy, "kv_buckets": ecfg.resolved_kv_buckets(),
           **request_record(req.rid, r),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    check_served(rec, [rec], list(req.x0.shape), {name: want for name in expected})
    return rec, r["out"]


def fidelity(out, dense) -> dict:
    """Relative L2 ``||out - dense|| / ||dense||`` and the PSNR of
    ``benchmarks/common.psnr``: peak max |dense| (1 if 0), the MSE floored
    at 1e-12 (in float64 here)."""
    import math
    a, b = out.double(), dense.double()
    mse = float(((a - b) ** 2).mean())
    peak = float(b.abs().max()) or 1.0
    return {"rel_l2": float((a - b).norm() / b.norm()),
            "psnr_db": 10 * math.log10(peak * peak / max(mse, 1e-12))}


def phase_serve() -> tuple[dict, tuple, list]:
    """P1; also returns its request's last plan of every layer (for M1)."""
    res, launches, results = serve_path("serve", P1_KERNELS, REQUESTS, keep_plans=True, **FLUX)
    emit(res)
    return launches, (res["requests"][0]["latency_s"], results[0]["out"]), results[0]["plans"]


def phase_serve_bucketed() -> tuple[dict, tuple]:
    """P2: sliding-window, kv_buckets=0 (auto: 2), 1 request; then the share of
    work the buckets dropped at one interior layer's last Update plan."""
    import torch
    from repro_torch.core.engine import plan_from_state
    from repro_torch.launch.serve import get_config, serving_engine_config
    from repro_torch.models import dit
    captured = {}
    step = dit.denoise_step

    def recording_step(*args, **kw):      # keeps the states of the last Update step
        v, states = step(*args, **kw)
        if kw.get("mode") == "update":
            captured["states"] = list(states)     # the sampler replaces the entries
        return v, states

    dit.denoise_step = recording_step
    try:
        res, launches, results = serve_path("serve_bucketed", P2_KERNELS, 1,
                                            strategy="sliding-window", kv_buckets=0, **FLUX)
    finally:
        dit.denoise_step = step
    ecfg = serving_engine_config("sliding-window", kv_buckets=0)
    layer = get_config(FLUX["arch"]).n_layers // 2
    st = captured.pop("states")[layer]
    n = st.taylor.derivs.shape[-2]            # text + vision tokens (bias cache: B, N, d)
    plan_b = st.plan
    plan_u = plan_from_state(st, dataclasses.replace(ecfg, kv_buckets=1), n)

    def live_kv(plan):
        live = torch.arange(plan.kv_row_cnt.shape[-1], device=plan.q_cnt.device) \
            < plan.q_cnt[..., None]
        return int(torch.where(live, plan.kv_row_cnt, 0).sum())

    kv_b, kv_u = live_kv(plan_b), live_kv(plan_u)
    rh_b, rh_u = int(plan_b.head_cnt.sum()), int(plan_u.head_cnt.sum())
    res["kv_buckets_resolved"] = ecfg.resolved_kv_buckets()
    res["clamp"] = {"layer": layer, "live_kv_blocks": {"uniform": kv_u, "bucketed": kv_b,
                                                      "dropped_share": 1 - kv_b / kv_u},
                    "live_row_heads": {"uniform": rh_u, "bucketed": rh_b,
                                       "dropped_share": 1 - rh_b / rh_u}}
    emit(res)
    return launches, (res["requests"][0]["latency_s"], results[0]["out"])


# The mesh phase (plan-sharded Dispatch over torch.distributed, ranks that
# share the one card over gloo).  The layer cell: one Dispatch layer at the
# flux shapes (FULL) on mesh (2, 4), the shape of the reference's parity
# test, each case checked on every rank against the single-device Dispatch;
# a case is (label, strategy, kv_buckets, pair slack, mesh axis).  At
# slack 1.5 pair_cap = kv_bps = 72 (the clamp is the identity), at 0.5
# pair_cap = ceil(0.5 * 260 / 4) = 33 and the clamp binds.  Two cases
# within the script's time limit: the seq axis with 3 buckets at slack 0.5
# (the clamp binds) and the head axis with 1 bucket (Dispatch never
# consults the strategy, so the multi-granularity and hunyuan-1.5x plans
# were cut, with 3 buckets at slack 1.5 and 1 bucket at 0.5, for the
# dryrun phase, S4-tp and S5, and the seq axis at 1 bucket and slack 1.5
# for S2-moe and S3-tp).
MESH_LAYER = (2, 4)
MESH_CASES = (("seq, flashomni, 3 buckets, slack 0.5", "flashomni", 3, 0.5, "seq"),
              ("head, flashomni, 1 bucket", "flashomni", 1, 1.5, "head"))
MESH_SEED = 2468
# M1: P1's request (same seed, weights and noise) served across mesh (1, 2).
M1_MESH = (1, 2)
M1_REL_L2 = 1e-6
MESH_JOIN_S = 400


def first_b2_call(run):
    """``run()`` with the engine backend's B2 wrapper kept, as it launches,
    with the inputs and output of its first call; returns ``run()``'s result
    and that call (None if B2 did not run).  The wrapper counts launches as
    always."""
    from repro_torch.core import backend
    kern, seen = backend.flashomni_attention_csr, []

    def keep(*args, **kw):
        out = kern(*args, **kw)
        if not seen:
            seen.append((args, kw, out))
        return out

    backend.flashomni_attention_csr = keep
    try:
        return run(), (seen[0] if seen else None)
    finally:
        backend.flashomni_attention_csr = kern


def b2_vs_plain(call) -> dict:
    """A kept B2 call held against its plain version on the same card
    tensors (float32 tolerance): the shapes, the largest difference and its
    largest share of the tolerance (the phase fails above 1)."""
    import torch
    from repro_torch.kernels.ref import attention_csr_ref
    args, kw, out = call
    want = attention_csr_ref(*args, **kw)
    tol = TOL[str(out.dtype).removeprefix("torch.")]
    err = (out.float() - want.float()).abs()
    q, k, _, o_reuse = args[:4]
    return {"q": list(q.shape), "kv": list(k.shape), "o_reuse": list(o_reuse.shape),
            "lists": list(args[7].shape), "max_abs_err": float(err.max()),
            "tol_share": float((err / (tol + tol * want.float().abs())).max()),
            "tolerance": tol, "finite": bool(torch.isfinite(out).all())}


def b2_agrees(row) -> bool:
    """A :func:`b2_vs_plain` row within its tolerance (None: B2 never ran)."""
    return row is not None and row["finite"] and row["tol_share"] <= 1


def mesh_exchange(plan, cfg, n: int, dh: int, one_plan) -> dict:
    """The seq exchange of a plan, summed over K and V and every (b, h,
    shard): the all-to-all payload, the live blocks it carries and a dense
    all-gather's, in blocks and f32 bytes, and the rows the pair clamp
    shortened against ``one_plan`` (the same masks without a mesh)."""
    from repro_torch.distributed.plan_shard import (dense_exchange_blocks, exchange_blocks,
                                                    shard_geometry)
    m, spec = cfg.mask, cfg.caps(n)
    t_kv = n // m.block_kv
    geom = shard_geometry(spec, n // m.block_q, t_kv, cfg.mesh_sp, cfg.mesh_pair_slack)
    b, h = plan.q_cnt.shape
    blk = m.block_kv * dh * 4
    payload = 2 * b * h * cfg.mesh_sp * exchange_blocks(geom)
    sent = 2 * int(plan.shd_send_cnt.sum())
    dense = 2 * b * h * cfg.mesh_sp * dense_exchange_blocks(t_kv)
    return {"cap_kv": spec.cap_kv, "t_kv": t_kv, "kv_bps": geom.kv_bps,
            "pair_cap": geom.pair_cap, "union_cap": geom.cap_kv,
            "a2a_payload_blocks": payload, "live_blocks_sent": sent,
            "dense_allgather_blocks": dense, "a2a_payload_bytes": payload * blk,
            "live_sent_bytes": sent * blk, "dense_allgather_bytes": dense * blk,
            "payload_over_dense": payload / dense, "live_over_dense": sent / dense,
            "folded_rows": int((plan.kv_row_cnt != one_plan.kv_row_cnt).sum())}


def mesh_layer_rank(rank: int) -> list:
    """One rank of the layer cell.  Each case: an Update of one seeded
    attention layer at the flux shapes under the mesh config (every rank on
    the same inputs), then its mesh Dispatch against this rank's
    single-device Dispatch of the same state.  Returns this rank's rows:
    ``torch.equal``, the largest difference, whether every rank built the
    same plan (a gathered checksum), B2's launches and the host seconds of
    the mesh Dispatch (one call), its peak memory, B2's first call at the
    shard's shapes against its plain version, and the exchange's volume
    (seq mode)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import engine as E
    from repro_torch.kernels import flashomni_attention_csr
    from repro_torch.launch.serve import serving_engine_config
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, n, dh, d, n_text = (FULL[k] for k in ("b", "h", "n", "dh", "d", "n_text"))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(MESH_SEED)
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=g, device=DEVICE).mul_(std)
    ones = torch.ones(dh, device=DEVICE)
    p = E.AttnParams(wq=rnd(d, h * dh, std=d ** -0.5), wk=rnd(d, h * dh, std=d ** -0.5),
                     wv=rnd(d, h * dh, std=d ** -0.5), wo=rnd(h * dh, d, std=d ** -0.5),
                     q_scale=ones, k_scale=ones)
    x = rnd(b, n, d)
    rows = []
    for label, strategy, kvb, slack, axis in MESH_CASES:
        cfg = dataclasses.replace(serving_engine_config(strategy, kvb, mesh=MESH_LAYER),
                                  mesh_pair_slack=slack, mesh_axis=axis)
        cfg1 = dataclasses.replace(cfg, mesh_dp=1, mesh_sp=1)
        _, st = E.update_layer(p, x, E.init_layer_state(b, h, n, d, dh, cfg, DEVICE), cfg,
                               n_text=n_text, heads=h, step_idx=2, num_steps=8)
        plan = st.plan.widen()
        ints = [t for t in plan if t is not None and not t.dtype.is_floating_point]
        sums = [None] * dist.get_world_size()
        dist.all_gather_object(sums, sum(int(t.long().sum()) * (i + 1)
                                         for i, t in enumerate(ints)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = flashomni_attention_csr.launches, time.perf_counter()
        (om, _), call = first_b2_call(
            lambda: E.dispatch_layer(p, x, st, cfg, n_text=n_text, heads=h))
        torch.cuda.synchronize()
        row = {"case": label, "rank": dist.get_rank(), "plans_agree": len(set(sums)) == 1,
               "b2_launches": flashomni_attention_csr.launches - before,
               "mesh_dispatch_s": time.perf_counter() - t0,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "b2_vs_plain": b2_vs_plain(call) if call else None}
        del call
        o1, _ = E.dispatch_layer(p, x, st, cfg1, n_text=n_text, heads=h)
        row.update(equal=bool(torch.equal(om, o1)), max_abs_diff=float((om - o1).abs().max()))
        del om, o1
        if axis == "seq":
            one_plan = E.build_dispatch_plan(*E._unpack(st, cfg1, n), cfg1, n,
                                             row_score=plan.row_score)
            row["exchange"] = mesh_exchange(plan, cfg, n, dh, one_plan)
        rows.append(row)
        del st, plan
    return rows


def m1_rank(rank: int) -> dict:
    """One rank of M1: P1's request through ``serve_diffusion(mesh=(1, 2))``,
    launch counts set to 0 just before and read just after; B2's first call
    (layer 0 of the first Dispatch step, at this shard's shapes) against its
    plain version; rank 0 also returns its latents and its last plan of
    every layer."""
    import torch
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import serve_diffusion
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, call = first_b2_call(lambda: serve_diffusion(
        FLUX["arch"], smoke=False, n_vision=FLUX["n_vision"], batch=FLUX["batch"],
        num_requests=1, num_steps=STEPS, mesh=M1_MESH, device=DEVICE, verbose=False,
        keep_plans=True))
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    r = res[0]
    out = {"rank": rank, "latency_s": r["latency"], "finite": bool(torch.isfinite(r["out"]).all()),
           "kinds": [s["kind"] for s in r["trace"]], "step_s": [s["seconds"] for s in r["trace"]],
           "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "b2_vs_plain": b2_vs_plain(call) if call else None}
    del call
    if rank == 0:
        cpu = lambda p: p._replace(**{f: None if v is None else v.cpu()
                                      for f, v in zip(p._fields, p)})
        out.update(latents=r["out"].cpu(), plans=[cpu(p) for p in r["plans"]])
    return out


def phase_mesh(p1: tuple, p1_plans: list) -> dict:
    """The ``mesh`` phase: the layer cell on mesh (2, 4), then M1 on mesh
    (1, 2), every rank a process of its own on the one card over ``gloo``
    (NCCL refuses two ranks on one card).  The kernels are built here,
    before any rank starts.  Fails if a rank fails, a case's sharded output
    is not ``torch.equal`` to a rank's single-device Dispatch, B2 did not
    launch on every rank, B2 at a shard's shapes (a case's, or M1's first
    Dispatch layer's) disagrees with its plain version on the same card
    tensors, an M1 integer plan field differs from P1's, or M1's latents lie
    beyond ``M1_REL_L2`` of P1's.  M1's latency is not a
    speed number: its two ranks share one card and exchange through the
    host.  ``p1``: P1's (latency, latents); ``p1_plans``: its last plans."""
    import torch
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_local_mesh
    from repro_torch.launch.serve import get_config, serving_engine_config
    _build.load()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local_mesh(mesh_layer_rank, *MESH_LAYER, timeout=MESH_JOIN_S)
    layer_s = time.perf_counter() - t0
    cases = []
    for i, (label, *_) in enumerate(MESH_CASES):
        per_rank = [r[i] for r in ranks]
        cases.append({**{k: v for k, v in per_rank[0].items()
                         if k not in ("rank", "b2_launches", "peak_mem_gb", "mesh_dispatch_s",
                                      "b2_vs_plain")},
                      "equal": all(r["equal"] for r in per_rank),
                      "max_abs_diff": max(r["max_abs_diff"] for r in per_rank),
                      "plans_agree": all(r["plans_agree"] for r in per_rank),
                      "b2_launches_by_rank": [r["b2_launches"] for r in per_rank],
                      "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in per_rank],
                      "mesh_dispatch_s_by_rank": [r["mesh_dispatch_s"] for r in per_rank],
                      "b2_vs_plain_by_rank": [r["b2_vs_plain"] for r in per_rank]})
    res = {"phase": "mesh", "layer_cell": {"mesh": MESH_LAYER, "transport": "gloo", **FULL,
                                           "seconds": layer_s, "cases": cases}}
    bad = [c["case"] for c in cases if not (c["equal"] and c["plans_agree"]
                                            and all(n == 1 for n in c["b2_launches_by_rank"])
                                            and all(b2_agrees(v) for v in c["b2_vs_plain_by_rank"]))]
    if bad:
        emit(res)
        raise AssertionError(f"mesh layer cell: cases {bad} differ from one device, "
                             "disagree on the plan, did not launch B2 on every rank or "
                             "B2 disagrees with its plain version at a shard's shapes")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m1 = run_local_mesh(m1_rank, *M1_MESH, timeout=MESH_JOIN_S)
    m1_s = time.perf_counter() - t0
    cfg = get_config(FLUX["arch"])
    want = cfg.n_layers * dispatch_steps(resolve_schedule(serving_engine_config(), STEPS,
                                                          cfg.n_layers))
    latents, plans = m1[0].pop("latents"), m1[0].pop("plans")
    p1_latency, p1_out = p1
    ref = p1_out.cpu().double()
    rel = float((latents.double() - ref).norm() / ref.norm())
    differ, row_score_equal = [], True
    for li, (a, b) in enumerate(zip(p1_plans, plans)):
        for f, va in zip(a._fields, a):
            if va is None:
                continue
            vb = getattr(b, f)
            if f == "row_score":
                row_score_equal &= bool(torch.equal(va.cpu(), vb))
            elif not torch.equal(va.cpu(), vb):
                differ.append([li, f])
    res["m1"] = {"mesh": M1_MESH, "transport": "gloo", **FLUX, "layers": cfg.n_layers,
                 "steps": STEPS, "wall_s": m1_s, "ranks": m1,
                 "p1_latency_s": p1_latency,
                 "latency_note": "not a speed number: two ranks share one card and the "
                                 "exchange goes through the host",
                 "latents_rel_l2_vs_p1": rel, "latents_bit_equal": rel == 0.0,
                 "plan_layers": len(plans), "plan_fields_differ": differ,
                 "shd_fields": sorted(f for f in plans[0]._fields
                                      if f.startswith("shd_") and getattr(plans[0], f) is not None),
                 "row_score_equal": row_score_equal,
                 "expected_launches": {name: want for name in P1_KERNELS}}
    emit(res)
    for r in m1:
        if not r["finite"] or any(r["launches"][name] != want for name in P1_KERNELS):
            raise AssertionError(f"M1 rank {r['rank']}: non-finite latents or launches "
                                 f"{r['launches']}, expected {want} of each of {P1_KERNELS}")
        if not b2_agrees(r["b2_vs_plain"]):
            raise AssertionError(f"M1 rank {r['rank']}: B2 at the shard's shapes disagrees "
                                 f"with its plain version: {r['b2_vs_plain']}")
    if differ or len(plans) != cfg.n_layers or not rel <= M1_REL_L2:
        raise AssertionError(f"M1: {len(differ)} plan fields differ from P1's, rel-L2 "
                             f"{rel:.3e} (limit {M1_REL_L2})")
    return m1[0]["launches"]


def phase_dense(served: dict) -> None:
    """The dense baseline: P1's request under ``force_dense`` (every step
    dense, no kernel may launch) on the weights, latents, text and patch
    embedding that served P1 and P2; each sparse run's speedup (dense
    latency / its latency) and rel-L2 / PSNR against the dense latents.
    Then P1 and the dense run again in bfloat16, each also read against the
    float32 dense latents.  ``served``: path -> (latency, latents)."""
    import torch
    from repro_torch.launch.serve import get_config, serving_engine_config, serving_inputs
    cfg = get_config(FLUX["arch"])
    inputs = serving_inputs(cfg, n_vision=FLUX["n_vision"], batch=FLUX["batch"],
                            num_requests=1, num_steps=STEPS, device=DEVICE)
    ecfgs = {"P1": (serving_engine_config(), P1_KERNELS),
             "P2": (serving_engine_config("sliding-window", kv_buckets=0), P2_KERNELS)}
    dense32, ref32 = serve_request("dense", cfg, ecfgs["P1"][0], inputs, dense=True)
    dense16, ref16 = serve_request("dense", cfg, ecfgs["P1"][0], inputs, dtype="bfloat16",
                                   dense=True)
    runs, compare = [dense32, dense16], []
    for path, (ecfg, kernels) in ecfgs.items():
        latency, out = served[path]
        compare.append({"path": path, "dtype": "float32", "latency_s": latency,
                        "dense_latency_s": dense32["latency_s"],
                        "speedup": dense32["latency_s"] / latency,
                        "vs_dense": fidelity(out, ref32)})
        if path != "P1":              # bf16: P1 alone (P2's run cut for the time limit)
            continue
        rec, out16 = serve_request(path, cfg, ecfg, inputs, kernels, dtype="bfloat16")
        runs.append(rec)
        compare.append({"path": path, "dtype": "bfloat16", "latency_s": rec["latency_s"],
                        "dense_latency_s": dense16["latency_s"],
                        "speedup": dense16["latency_s"] / rec["latency_s"],
                        "vs_dense": fidelity(out16, ref16),
                        "vs_dense_float32": fidelity(out16, ref32)})
    compare.append({"path": "dense", "dtype": "bfloat16",
                    "speedup_over_dense_float32": dense32["latency_s"] / dense16["latency_s"],
                    "vs_dense_float32": fidelity(ref16, ref32)})
    emit({"phase": "dense", **FLUX, "layers": cfg.n_layers, "steps": STEPS, "runs": runs,
          "compare": compare})


def step_median(rec, kind) -> float:
    import statistics
    return statistics.median(s for s, k in zip(rec["step_s"], rec["kinds"]) if k == kind)


def phase_hunyuan() -> dict:
    """H1, the paper's 33K cell: hunyuan-video-dit at full width (48 blocks,
    B = 1, 256 text + 32 768 vision tokens) under the ``hunyuan-1.5x``
    schedule on the uniform layout in float32, served by ``serve_diffusion``;
    then its dense run on the same inputs.  Reports the speedup, rel-L2 and
    PSNR against dense, and the 50-step projection ``50 t_dense / (n_U t_U +
    n_D t_D)`` from the measured median step times and the schedule's step
    counts at 50 steps."""
    import torch
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.core.schedule import MODE_DISPATCH, MODE_UPDATE
    from repro_torch.launch.serve import get_config, serving_engine_config, serving_inputs
    res, launches, outs = serve_path("hunyuan", P1_KERNELS, 1, steps=H1_STEPS,
                                     schedule="hunyuan-1.5x", kv_buckets=1, **H1)
    cfg, ecfg = get_config(H1["arch"]), serving_engine_config()
    inputs = serving_inputs(cfg, n_vision=H1["n_vision"], batch=H1["batch"],
                            num_requests=1, num_steps=H1_STEPS, device=DEVICE)
    dense, ref = serve_request("dense", cfg, ecfg, inputs, dense=True)
    del inputs
    torch.cuda.empty_cache()
    sparse = res["requests"][0]
    t_u, t_d = step_median(sparse, "update"), step_median(sparse, "dispatch")
    t_dense = step_median(dense, "dense")
    mode50 = resolve_schedule(ecfg, 50, cfg.n_layers, schedule="hunyuan-1.5x").mode
    n_u, n_d = int((mode50 == MODE_UPDATE).sum()), int((mode50 == MODE_DISPATCH).sum())
    res.update({
        "dense": dense, "speedup": dense["latency_s"] / sparse["latency_s"],
        "vs_dense": fidelity(outs[0]["out"], ref),
        "step_median_s": {"update": t_u, "dispatch": t_d, "dense": t_dense},
        "projection_50_steps": {
            "note": "a projection from this run's median step times, not a measurement",
            "n_update": n_u, "n_dispatch": n_d,
            "speedup": 50 * t_dense / (n_u * t_u + n_d * t_d)}})
    emit(res)
    return launches


def phase_ops() -> dict:
    """The quickstart at full width on the card, launch counts set to 0 just
    before and read just after; fails unless its checks pass and the
    symbols attention and the Taylor reuse each launched."""
    import torch
    from repro_torch import quickstart
    from repro_torch.kernels import KERNELS, reset_launches
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    report = quickstart.main(["--full", "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    res = {"phase": "ops", "command": "python -m repro_torch.quickstart --full",
           "wall_s": wall, "layer": report["layer"], "checks": report["ops"],
           "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    missing = [name for name in OPS_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"ops: {missing} never launched")
    return launches


def empty_kv_rows(plan, block_q: int, n: int) -> tuple:
    """``(empty, bad)``: the live q slots (B, H, cap_q) whose KV list is
    empty, and the token rows (B, N) where such a slot of some head lies.
    The twin gives those rows a uniform softmax, the kernels zeros, so a
    comparison of the two zeroes them first."""
    import torch
    live = torch.arange(plan.q_ids.shape[-1], device=plan.q_cnt.device) < plan.q_cnt[..., None]
    empty = live & (plan.kv_row_cnt == 0)
    t_q = n // block_q
    blocks = torch.zeros((*plan.q_ids.shape[:2], t_q + 1), dtype=torch.bool,
                         device=empty.device)
    blocks.scatter_(-1, torch.where(empty, plan.q_ids.long(), t_q), True)
    return empty, blocks[..., :t_q].any(dim=1).repeat_interleave(block_q, dim=-1)


def phase_twin(b=2, h=24, n=4608, dh=128, d=3072, n_text=512, iters=3) -> dict:
    """One Dispatch layer (``engine.dispatch_layer``) at the flux shapes under
    ``backend="kernels"`` and under ``backend="torch"`` (the structural twin,
    which launches no kernel), on three plans from a seeded Q/K: flashomni
    at ``cap_kv = T_kv`` (the twin's union layout), sliding-window at 2
    buckets, and flashomni at the serving ``cap_kv < T_kv`` (its per-row
    layout).  The layer outputs agree within the float32 tolerance once the
    token rows where some head's live row has an empty KV list are zeroed
    (the twin gives those a uniform softmax, the kernels zeros); the twin's
    time is the library figure of a whole Dispatch layer."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import taylorseer
    from repro_torch.core.strategy import SlidingWindowStrategy
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    rnd = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev).mul_(std)
    params = E.AttnParams(wq=rnd(d, h * dh, std=d ** -0.5), wk=rnd(d, h * dh, std=d ** -0.5),
                          wv=rnd(d, h * dh, std=d ** -0.5), wo=rnd(h * dh, d, std=d ** -0.5),
                          q_scale=torch.ones(dh, device=dev), k_scale=torch.ones(dh, device=dev))
    x = rnd(b, n, d)
    cases = [("flashomni, cap_kv = T_kv (union layout)", None, 1, dict(cap_kv_frac=1.0)),
             ("sliding-window, 2 buckets", SlidingWindowStrategy(), 2, {}),
             ("flashomni, cap_kv < T_kv (per-row layout)", None, 1, {})]
    rows = []
    for label, strategy, kb, over in cases:
        ecfg, syms, plan = serving_plan(dev, b, h, n, dh, n_text, strategy, kb, **over)
        spec = ecfg.caps(n)
        derivs = rnd(ecfg.mask.order + 1, b, n, d).to(ecfg.cache_dtype)
        state = E.LayerState(s_c=syms.s_c, s_s=syms.s_s, k_since=1, plan=plan,
                             taylor=taylorseer.TaylorState(derivs, n_updates=2))
        del syms
        run = {name: (lambda c=dataclasses.replace(ecfg, backend=name):
                      E.dispatch_layer(params, x, state, c, n_text=n_text, heads=h)[0])
               for name in ("kernels", "torch")}
        out_k, out_t = run["kernels"](), run["torch"]()
        empty, bad = empty_kv_rows(plan, ecfg.mask.block_q, n)
        zero = lambda o: torch.where(bad[..., None], 0.0, o)
        max_err, share = check_close(f"twin [{label}]", "float32", zero(out_t), zero(out_k))
        del out_k, out_t
        rows.append({"plan": label, "kv_buckets": kb, "cap_kv": spec.cap_kv, "t_kv": n // 16,
                     "layout": ("per-row" if spec.cap_kv < n // 16 or kb > 1 else "union"),
                     "empty_live_rows": int(empty.sum()), "zeroed_token_rows": int(bad.sum()),
                     "max_abs_err": max_err, "tol_share": share,
                     "kernels_ms": time_ms(run["kernels"], iters),
                     "twin_ms": time_ms(run["torch"], iters, warmup=1)})
        del run, state, plan
        torch.cuda.empty_cache()
    res = {"phase": "twin", "b": b, "h": h, "n": n, "dh": dh, "d": d, "dtype": "float32",
           "tolerance": TOL["float32"], "cases": rows}
    emit(res)
    return res


def phase_rope(b=2, h=24, n=4608, dh=128, d=3072, n_text=512, iters=3) -> dict:
    """The engine's RoPE at the flux shapes: for each case two Update layers
    (``update_layer(freqs=rope_freqs(n, dh))``, ``cap_q_frac`` 0.75 so the
    gathers are capacity-truncated) build the plan from the rotated Q/K,
    which must be sparse and not empty; then one Dispatch layer with the
    same ``freqs`` under the kernels (compact GEMM-Q rows rotated at their
    original positions; the case's kernels launched once each, no other)
    and under the twin, within the float32 tolerance once the token rows
    where some head's live row has an empty KV list are zeroed, as in
    ``phase_twin``.  The kernels' run without ``freqs`` must differ from it
    by more than 100x that tolerance (rel-L2); both layer times (median of
    ``iters``) and their difference."""
    import torch
    from repro_torch import kernels as TK
    from repro_torch.core import engine as E
    from repro_torch.launch.serve import serving_engine_config
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(1357)
    rnd = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev).mul_(std)
    params = E.AttnParams(wq=rnd(d, h * dh, std=d ** -0.5), wk=rnd(d, h * dh, std=d ** -0.5),
                          wv=rnd(d, h * dh, std=d ** -0.5), wo=rnd(h * dh, d, std=d ** -0.5),
                          q_scale=torch.ones(dh, device=dev), k_scale=torch.ones(dh, device=dev))
    x = rnd(b, n, d)
    freqs = E.rope_freqs(n, dh, device=dev)
    tol = TOL["float32"]
    cases = [("bias, flashomni, uniform", "bias", "flashomni", 1, P1_KERNELS),
             ("bias, sliding-window, 2 buckets", "bias", "sliding-window", 2, P2_KERNELS),
             ("o_cache, flashomni, uniform", "o_cache", "flashomni", 1, P1_KERNELS[:2])]
    rows = []
    for label, mode, strategy, kb, kernels in cases:
        ecfg = dataclasses.replace(serving_engine_config(strategy, kb), cache_mode=mode,
                                   cap_q_frac=0.75, cache_dtype=torch.float32)
        state = E.init_layer_state(b, h, n, d, dh, ecfg, dev)
        for _ in range(2):        # two Updates: the Taylor stack forecasts at order 1
            _, state = E.update_layer(params, x, state, ecfg, n_text=n_text, heads=h,
                                      freqs=freqs)
        plan = state.plan.widen()
        live = torch.arange(plan.q_ids.shape[-1], device=dev) < plan.q_cnt[..., None]
        pairs = int(plan.kv_row_cnt[live].sum())
        full = int(live.sum()) * (n // ecfg.mask.block_kv)
        if not 0 < pairs < full:
            raise AssertionError(f"rope [{label}]: the plan from the rotated Q/K holds "
                                 f"{pairs} of {full} live (q, kv) block pairs")
        run = {name: (lambda c=dataclasses.replace(ecfg, backend=name):
                      E.dispatch_layer(params, x, state, c, n_text=n_text, heads=h,
                                       freqs=freqs)[0])
               for name in ("kernels", "torch")}
        bare = lambda: E.dispatch_layer(params, x, state, ecfg, n_text=n_text, heads=h)[0]
        TK.reset_launches()
        out_k = run["kernels"]()
        launches = {fn.__name__: fn.launches for fn in TK.KERNELS}
        if launches != {name: int(name in kernels) for name in launches}:
            raise AssertionError(f"rope [{label}]: launches {launches}, want {kernels} once")
        out_t = run["torch"]()
        empty, bad = empty_kv_rows(plan, ecfg.mask.block_q, n)
        zero = lambda o: torch.where(bad[..., None], 0.0, o)
        max_err, share = check_close(f"rope [{label}]", "float32", zero(out_t), zero(out_k))
        out_b = bare()
        rel = float(torch.linalg.vector_norm(out_b - out_k) / torch.linalg.vector_norm(out_k))
        if not rel > 100 * tol:
            raise AssertionError(f"rope [{label}]: the layer without freqs is within "
                                 f"rel-L2 {rel:.3e} of the layer with them")
        del out_k, out_t, out_b
        rope_ms, bare_ms = median_ms(run["kernels"], iters), median_ms(bare, iters)
        rows.append({"case": label, "kv_buckets": kb, "cache_mode": mode,
                     "q_blocks_live": int(plan.q_cnt.sum()), "q_blocks": plan.q_ids.numel(),
                     "pairs_live": pairs, "pairs_full": full,
                     "empty_live_rows": int(empty.sum()), "zeroed_token_rows": int(bad.sum()),
                     "launches": {k: v for k, v in launches.items() if v},
                     "max_abs_err": max_err, "tol_share": share,
                     "rel_l2_without_freqs": rel, "kernels_ms": rope_ms,
                     "kernels_ms_without_freqs": bare_ms, "rope_ms": rope_ms - bare_ms})
        del run, bare, state, plan
        torch.cuda.empty_cache()
    res = {"phase": "rope", "b": b, "h": h, "n": n, "dh": dh, "d": d, "dtype": "float32",
           "cap_q_frac": 0.75, "tolerance": tol, "cases": rows}
    emit(res)
    return res


def stack_witness(params, cfg, ecfg, pe, reqs) -> dict:
    """Where stacking first changes a plan, and why.  C1's 8-step requests
    step once as the stacked batch ``run_stacked`` forms and once each
    alone, in lockstep from fresh states through at most ``WITNESS_STEPS``
    steps (after the first step whose plans differ, none).  Per step:
    each request's latent rel-L2 against its lone run and its count of
    differing integer plan fields (layer x field); at Update the largest
    difference of any layer's Q and K between the two runs and of the
    Q projection's library GEMM on one and the same input (the batch's
    rows at once against one sample's rows at a time).  At the first
    differing (step, layer, field): that layer's Q and K difference and its
    GEMM's.  Fails if a plan differs at a layer whose Q and K are equal in
    both runs (then the plan did not follow a rounding upstream), or if a
    request's step-0 latents lie beyond ``WITNESS_STEP0_REL_L2``."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core.plan import DispatchPlan
    from repro_torch.core.schedule import MODE_NAMES
    from repro_torch.diffusion.pipeline import _step_lanes
    from repro_torch.models import dit
    group = [r for r in reqs if r.num_steps == STEPS]
    sched = group[0].resolve(ecfg, cfg.n_layers)
    n_tokens = group[0].x0.shape[1] + group[0].text_emb.shape[1]
    xb, tb = torch.cat([r.x0 for r in group]), torch.cat([r.text_emb for r in group])
    sb = dit.init_engine_states(cfg, ecfg, len(group), n_tokens, xb.device)
    xs = [r.x0 for r in group]
    ss = [dit.init_engine_states(cfg, ecfg, 1, n_tokens, xb.device) for _ in group]
    orig_qk = E._qk

    def run(states, x, text, step, hook):
        E._qk = hook
        try:
            (x,), states = _step_lanes(params, cfg, ecfg, states, [x], [text], pe,
                                       mode=MODE_NAMES[int(sched.mode[step])], steps=[step],
                                       num_steps=[STEPS], strategies=sched.strategies,
                                       strategy_row=sched.strategy_ids[step],
                                       dtype=torch.float32)
        finally:
            E._qk = orig_qk
        return x, states

    steps, first = [], None
    for step in range(WITNESS_STEPS):
        stored = []                   # per layer: the batch's Q, K and its GEMM difference

        def keep(p, x, heads, freqs=None):
            q, k = orig_qk(p, x, heads, freqs)
            rows = torch.cat([x[i:i + 1] @ p.wq for i in range(x.shape[0])])
            stored.append((q.clone(), k.clone(), float((x @ p.wq - rows).abs().max())))
            return q, k

        xb, sb = run(sb, xb, tb, step, keep)
        qk_diff = []                  # [request][layer] = (Q, K) max abs difference
        for i in range(len(group)):
            seen = []

            def compare(p, x, heads, freqs=None, i=i, seen=seen):
                q, k = orig_qk(p, x, heads, freqs)
                qb, kb, _ = stored[len(seen)]
                seen.append((float((q - qb[i:i + 1]).abs().max()),
                             float((k - kb[i:i + 1]).abs().max())))
                return q, k

            xs[i], ss[i] = run(ss[i], xs[i], group[i].text_emb, step, compare)
            qk_diff.append(seen)
        rel, differ = [], []
        for i in range(len(group)):
            rel.append(fidelity(xb[i:i + 1], xs[i])["rel_l2"])
            n = 0
            for li, (stb, st1) in enumerate(zip(sb, ss[i])):
                mine = DispatchPlan(*(None if f is None else f[i:i + 1] for f in stb.plan))
                for f, a, b in zip(mine._fields, mine, st1.plan):
                    if a is None or f == "row_score" or torch.equal(a, b):
                        continue
                    n += 1
                    at = (li, mine._fields.index(f))
                    if first is None or (first["step"] == step and at < first["_at"]):
                        first = {"step": step, "layer": li, "field": f, "rid": group[i].rid,
                                 "_at": at}
            differ.append(n)
        entry = {"step": step, "mode": MODE_NAMES[int(sched.mode[step])],
                 "latent_rel_l2": rel, "plan_fields_differ": differ}
        if stored:
            entry.update(qk_max_abs_diff=max(max(max(d) for d in req) for req in qk_diff),
                         layer0_qk_max_abs_diff=max(max(req[0]) for req in qk_diff),
                         gemm_batch_vs_rows_max_abs=max(g for _, _, g in stored))
        if first is not None and first["step"] == step:
            li = first.pop("_at")[0]
            i = [r.rid for r in group].index(first["rid"])
            first.update(q_max_abs_diff=qk_diff[i][li][0] if stored else None,
                         k_max_abs_diff=qk_diff[i][li][1] if stored else None,
                         gemm_batch_vs_rows_max_abs=stored[li][2] if stored else None)
        steps.append(entry)
        del stored
        if first is not None:
            break
    del sb, ss, xb, xs
    torch.cuda.empty_cache()
    res = {"requests": [r.rid for r in group], "batch": len(group), "steps": steps,
           "first_difference": first}
    if first is not None and not (first["q_max_abs_diff"] or first["k_max_abs_diff"]):
        raise AssertionError(f"stack_witness: a plan differs where Q and K are equal: {res}")
    if not max(steps[0]["latent_rel_l2"]) <= WITNESS_STEP0_REL_L2:
        raise AssertionError(f"stack_witness: step-0 latents beyond {WITNESS_STEP0_REL_L2} "
                             f"of the lone runs: {res}")
    return res


def phase_serve_batched() -> dict:
    """C1: flux-mmdit at full width, ``C1["requests"]`` requests of batch 1
    arriving together, steps alternating 8 and 6 (``mixed_steps``), served
    in turn by ``run_sequential``, ``run_stacked`` and the continuous batcher
    (``C1["lanes"]`` lanes, ``grouped="auto"``), each with the launch counts
    set to 0 just before and read just after.  Per mode: requests per second,
    p50 / p95 latency, peak memory and, for each request, rel-L2 / PSNR of its
    latents and the count of integer plan fields (layer x field) that differ
    from its sequential run.  Fails if a request's latents are not finite or
    lie beyond ``C1_REL_L2`` of sequential, if the batcher ran no grouped or
    no scan tick, if a request's trace holds another count of Dispatch steps
    than its schedule or the batcher's Dispatch lane steps another sum, or
    if a Dispatch kernel's launches differ from layers x the Dispatch
    ``denoise_step`` calls of the mode.  Then :func:`stack_witness`, outside
    the counted runs."""
    import numpy as np
    import torch
    from repro_torch.core.schedule import MODE_DISPATCH
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.batching import ContinuousBatcher, run_sequential, run_stacked
    from repro_torch.launch.serve import get_config, serving_engine_config, serving_inputs
    cfg, ecfg = get_config(C1["arch"]), serving_engine_config()
    params, pe, reqs = serving_inputs(cfg, n_vision=C1["n_vision"], batch=C1["batch"],
                                      num_requests=C1["requests"], num_steps=STEPS,
                                      mixed_steps=True, device=DEVICE)
    n_dispatch = {r.rid: int((r.resolve(ecfg, cfg.n_layers).mode == MODE_DISPATCH).sum())
                  for r in reqs}
    runs, seq, total = [], None, {fn.__name__: 0 for fn in KERNELS}
    for mode in ("sequential", "stacked", "continuous"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        stats = {}
        if mode == "continuous":
            bat = ContinuousBatcher(params, cfg, ecfg, patch_embed=pe, lanes=C1["lanes"],
                                    grouped="auto", keep_plans=True)
            bat.submit_all(reqs)
            res = bat.run()
            stats = {k: bat.stats[k] for k in ("ticks", "grouped_ticks", "scan_ticks",
                                               "denoise_calls", "lane_steps", "lockstep")}
            calls = stats["denoise_calls"]["dispatch"]
            # The batcher's own count cannot vouch for itself: every request
            # ran its schedule's Dispatch steps, and the folds advanced as many
            # lane steps.
            kinds = {r.rid: sum(s["kind"] == "dispatch" for s in res[r.rid]["trace"])
                     for r in reqs}
            if kinds != n_dispatch or stats["lane_steps"]["dispatch"] != sum(
                    n_dispatch.values()):
                raise AssertionError(f"serve_batched [continuous]: Dispatch steps by request "
                                     f"{kinds} and lane steps {stats['lane_steps']}, expected "
                                     f"{n_dispatch} (sum {sum(n_dispatch.values())})")
        else:
            run = run_sequential if mode == "sequential" else run_stacked
            res = run(params, cfg, ecfg, reqs, patch_embed=pe, keep_plans=True)
            # Stacked: one sampler call per step count (the two groups).
            calls = (sum(n_dispatch.values()) if mode == "sequential"
                     else sum({r.num_steps: n_dispatch[r.rid] for r in reqs}.values()))
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in KERNELS}
        for name, count in launches.items():
            total[name] += count
        expected = {name: cfg.n_layers * calls if name in P1_KERNELS else 0
                    for name in launches}
        seq = res if seq is None else seq
        lat = np.asarray([res[r.rid]["latency"] for r in reqs])
        per_req = []
        for r in reqs:
            out, want = res[r.rid]["out"], seq[r.rid]["out"]
            differ = sum(int(not torch.equal(a, b_))
                         for pa, pb in zip(res[r.rid]["plans"], seq[r.rid]["plans"])
                         for f, a, b_ in zip(pa._fields, pa, pb)
                         if a is not None and f != "row_score")
            per_req.append({"rid": r.rid, "steps": r.num_steps, "latency_s": float(lat[r.rid]),
                            "finite": bool(torch.isfinite(out).all()),
                            "plan_fields_differ": differ, **fidelity(out, want)})
        runs.append({"mode": mode, "wall_s": wall, "req_per_s": len(reqs) / wall,
                     "latency_p50_s": float(np.percentile(lat, 50)),
                     "latency_p95_s": float(np.percentile(lat, 95)),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "dispatch_calls": calls, "launches": launches, **stats,
                     "requests": per_req})
        bad = [q for q in per_req if not q["finite"] or not q["rel_l2"] <= C1_REL_L2]
        if bad or launches != expected or (mode == "continuous" and not (
                stats["grouped_ticks"] and stats["scan_ticks"])):
            emit({"phase": "serve_batched", "runs": runs, "expected_launches": expected})
            raise AssertionError(f"serve_batched [{mode}]: requests {bad} beyond rel-L2 "
                                 f"{C1_REL_L2} or not finite, launches {launches} (expected "
                                 f"{expected}), or a tick kind missing: {stats}")
        if mode != "sequential":
            for r in reqs:
                res[r.rid].pop("plans")
    witness = stack_witness(params, cfg, ecfg, pe, reqs)
    emit({"phase": "serve_batched", **C1, "steps": [r.num_steps for r in reqs],
          "layers": cfg.n_layers, "dtype": "float32", "rel_l2_limit": C1_REL_L2,
          "runs": runs, "stack_witness": witness})
    return total


# Profiler kernel name (the ``__global__`` function in csrc/*.cu) -> the
# wrapper that launches it; first match wins.
KERNEL_GROUPS = (("gemm_q_kernel", "gemm_q_sparse_kernel"),
                 ("csr_bucketed_kernel", "flashomni_attention_csr_bucketed"),
                 ("csr_attention_kernel", "flashomni_attention_csr"),
                 ("symbols_attention_kernel", "flashomni_attention_symbols"),
                 ("gemm_o_bucketed_kernel", "gemm_o_sparse_bucketed_kernel"),
                 ("gemm_o_kernel", "gemm_o_sparse_kernel"),
                 ("taylor_reuse_kernel", "taylor_reuse_kernel"))


# The device side of the dispatch-purity claim: a Dispatch step launches
# no kernel of this group, an Update step (which builds the plans) at least
# one.  Scans (cumulative sums) are a group of their own, reported and not
# held to it: the reference's index-decode set has no cumsum.
SORT_GROUP = "sort/top-k (plan build)"
SCAN_GROUP = "scan"


def _kernel_group(name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in name:
            return group
    lowered = name.lower()
    if "gemm" in lowered or "cutlass" in lowered or "xmma" in lowered:
        return "library GEMM (dense projections, MLP, dense attention)"
    if any(key in lowered for key in ("sort", "radix", "topk", "kthvalue")):
        return SORT_GROUP
    if "scan" in lowered:
        return SCAN_GROUP
    return "other (elementwise, reductions, copies)"


# The profile's group for the kernels that the chunked dense attention
# (core.attention.dense_attention) launches.
DENSE_ATTENTION = "dense attention (chunked: Update and dense steps)"


@contextlib.contextmanager
def annotated_dense_attention(spans: list):
    """Runs every ``dense_attention`` call of the engine and the DiT inside a
    ``record_function("dense_attention")`` range and between two CUDA
    events, appended to ``spans``."""
    import torch
    from torch.profiler import record_function
    from repro_torch.core import engine
    from repro_torch.models import dit
    plain = engine.dense_attention

    def annotated(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with record_function("dense_attention"):
            start.record()
            out = plain(*args, **kw)
            end.record()
        spans.append((start, end))
        return out

    engine.dense_attention = dit.dense_attention = annotated
    try:
        yield
    finally:
        engine.dense_attention = dit.dense_attention = plain


def dense_attention_kernels(events, calls) -> list:
    """``(kernel name, us)`` of every kernel that ran within the device-side
    spans of the ``dense_attention`` ranges (one stream, so nothing else
    ran there).  Fails if ``calls`` (the calls the CUDA events timed) is not
    0 and the trace holds no such span."""
    import bisect
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type == cuda and ev.name == "dense_attention")
    if calls and not spans:
        raise AssertionError(f"{calls} dense_attention calls ran, but the trace holds no "
                             "device-side span of them")
    kernels = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                     for ev in events if ev.device_type == cuda
                     and ev.name != "dense_attention" and not ev.is_user_annotation)
    starts = [k[0] for k in kernels]
    found = []
    for lo, hi in spans:
        found.extend((name, us) for _, name, us in
                     kernels[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)])
    return found


def profile_path(label, ecfg, cfg, params, xe, text, t) -> dict:
    """Device time by kernel group within one Update and one Dispatch step
    (the Update step's strategies from the path's schedule at step 0); the
    dense attention's kernels form a group of their own, whose total is
    reported beside the time CUDA events took around each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.models import dit
    b, nv = xe.shape[:2]
    sched = resolve_schedule(ecfg, STEPS, cfg.n_layers)
    states = dit.init_engine_states(cfg, ecfg, b, nv + cfg.n_text_tokens, xe.device)
    report = {}
    for mode in ("update", "dispatch"):
        torch.cuda.synchronize()
        spans = []
        # The traces hold millions of Python objects: no collection may pause
        # the host inside the timed step.
        gc.collect()
        gc.disable()
        with annotated_dense_attention(spans), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, states = dit.denoise_step(params, cfg, ecfg, states, xe, text, t,
                                         mode=mode, dtype=torch.float32,
                                         strategies=sched.strategies,
                                         strategy_row=sched.strategy_ids[0],
                                         step_idx=0, num_steps=STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        gc.enable()
        groups, busy = {}, 0.0

        def add(name, ms, calls):
            grp = groups.setdefault(name, {"ms": 0.0, "calls": 0})
            grp["ms"] += ms
            grp["calls"] += calls

        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation
                    or ev.key == "dense_attention"):
                continue
            ms = ev.self_device_time_total / 1e3
            busy += ms
            add(_kernel_group(ev.key), ms, ev.count)
        # The dense attention's kernels move from their own groups to its group.
        for name, us in dense_attention_kernels(prof.events(), len(spans)):
            add(_kernel_group(name), -us / 1e3, -1)
            add(DENSE_ATTENTION, us / 1e3, 1)
        groups = {k: v for k, v in groups.items() if v["calls"]}
        report[mode] = {"wall_ms": wall_ms, "device_busy_ms": busy or None,
                        "idle_share": (1 - busy / wall_ms) if busy else None,
                        "by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
                        "dense_attention_event_ms": sum(a.elapsed_time(z) for a, z in spans)}
        del prof
    return {"path": label, "arch": cfg.name, "layers": cfg.n_layers, "batch": b,
            "n_tokens": nv + cfg.n_text_tokens, "strategy": ecfg.strategy,
            "kv_buckets": ecfg.resolved_kv_buckets(), **report}


def profile_inputs(cfg, batch, n_vision, seed=0):
    """Weights and one step's inputs (latent patch embeddings, text, t = 0.5)."""
    import torch
    from repro_torch.models import dit
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (dit.init_params(cfg, g, dev),
            torch.randn((batch, n_vision, cfg.d_model), generator=g, device=dev),
            torch.randn((batch, cfg.n_text_tokens, cfg.d_model), generator=g, device=dev),
            torch.full((batch,), 0.5, device=dev))


def phase_profile():
    """One Update and one Dispatch step of P1 at full width."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serving_engine_config
    cfg = get_config(FLUX["arch"])
    paths = [profile_path("P1", serving_engine_config(), cfg,
                          *profile_inputs(cfg, FLUX["batch"], FLUX["n_vision"]))]
    torch.cuda.empty_cache()
    calls = lambda path, mode, group: path[mode]["by_group"].get(group, {}).get("calls", 0)
    purity = {p["path"]: {"dispatch_sort_kernels": calls(p, "dispatch", SORT_GROUP),
                          "update_sort_kernels": calls(p, "update", SORT_GROUP),
                          "dispatch_scan_kernels": calls(p, "dispatch", SCAN_GROUP),
                          "update_scan_kernels": calls(p, "update", SCAN_GROUP)}
              for p in paths}
    emit({"phase": "profile",
          "note": "one denoise step per mode under torch.profiler (profiler on)",
          "paths": paths, "dispatch_purity": purity})
    bad = {path: c for path, c in purity.items()
           if c["dispatch_sort_kernels"] or not c["update_sort_kernels"]}
    if bad:
        raise AssertionError(f"dispatch purity on the card: a Dispatch step launched a sort or "
                             f"top-k kernel, or an Update step none: {bad}")


# The dry run (``launch/dryrun``): the step builders' steps traced on
# ``meta`` tensors over a fake world and costed on the host, in a process of
# its own (its fake world must not meet the script's gloo worlds), each
# prediction printed beside what this run measured on the card.  T1 (world
# 1): its peak against T1's ``max_memory_allocated``, and its FLOPs over
# T1's measured step as a share of the f32 peak; S2 (world 2, mesh (2, 1)):
# the peak a rank against S2's, and the wire bytes a step against the bytes
# a rank copied from its peer (``fn.stats["peer_bytes"]``); S3's Dispatch:
# B1-B3 once a layer, billed at the plan's capacity, as S3 launched them;
# and the planning cell, flux-mmdit at all 38 blocks trained as T1 is, FSDP
# over 4 ranks on mesh (4, 1), batch 1 a rank: its peak a rank and whether
# it fits one H100's 80 GB.  A prediction more than DRYRUN_RATIO off its
# measurement either way fails the phase, as does a cell that raises or a
# kernel launch in the dry-run process.
DRYRUN_PLAN = dict(n_layers=38, world=4, batch_per_rank=1)
DRYRUN_RATIO = 2.0
DRYRUN_JOIN_S = 180
F32_FLOPS = 67e12                 # one H100 SXM at 700 W, f32 outside the tensor cores


def dryrun_cells() -> None:
    """The dry run's predictions of T1, S2, S3's Dispatch, S3-tp's Dispatch,
    S5 and the planning cell, printed as one JSON line (``phase_dryrun`` runs this in a process
    of its own)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.optim.optimizer import AdamWConfig

    def cell(world, n_layers, batch, n_vision, mode=None):
        cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=n_layers)
        kind = "train" if mode is None else "dit"
        shape = ShapeSpec(kind, n_vision + cfg.n_text_tokens, batch, kind)
        kw = (dict(opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=T1["steps"]))
              if mode is None else dict(mode=mode, ecfg=serving_engine_config()))
        with D.fake_world(world):
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                              mesh_dim_names=("data", "model"))
            return D.record_cell(cfg, shape, mesh, R, dtype=torch.float32, **kw)

    def s3tp_cell():
        cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=S3["n_layers"])
        n_tok = S3["n_vision"] + cfg.n_text_tokens
        with D.fake_world(2):
            mesh = DeviceMesh("cpu", torch.arange(2).reshape(S5_MESH),
                              mesh_dim_names=("data", "model"))
            return D.record_cell(cfg, ShapeSpec("dit", n_tok, S3["batch"], "dit"), mesh, R,
                                 dtype=torch.float32, mode="dispatch",
                                 ecfg=serving_engine_config())

    def s5_cell():
        cfg = get_config(S5["arch"])
        opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=LTRAIN_STEPS + 1)
        with D.fake_world(2):
            mesh = DeviceMesh("cpu", torch.arange(2).reshape(S5_MESH),
                              mesh_dim_names=("data", "model"))
            return D.record_cell(cfg, ShapeSpec("S5", S5["seq_len"], S5["batch"], "train"),
                                 mesh, R, dtype=torch.float32, opt_cfg=opt)

    t0 = time.perf_counter()
    reset_launches()
    out = {"T1": cell(1, T1["n_layers"], T1["batch"], T1["seq_len"]),
           "S5": s5_cell(),
           "S2": cell(2, S2["n_layers"], S2["batch"], S2["seq_len"]),
           "S3": cell(2, S3["n_layers"], S3["batch"], S3["n_vision"], mode="dispatch"),
           "S3tp": s3tp_cell(),
           "plan": cell(DRYRUN_PLAN["world"], DRYRUN_PLAN["n_layers"],
                        DRYRUN_PLAN["world"] * DRYRUN_PLAN["batch_per_rank"], T1["seq_len"]),
           "launches": _launches()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def start_dryrun() -> tuple:
    """:func:`dryrun_cells` started in a process of its own: the predictions
    come from shapes alone, so it runs on the host while H1 runs on the card;
    ``(process, start time)`` for :func:`phase_dryrun`."""
    return (subprocess.Popen([sys.executable, "-c",
                              "import chip_smoke; chip_smoke.dryrun_cells()"],
                             cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def phase_dryrun(started: tuple, t1: dict, s2: dict, s3: dict, s5: dict, s3tp: dict) -> dict:
    """The ``dryrun`` phase: the predictions of the process :func:`start_dryrun`
    started, beside T1's, S2's, S3's, S5's and S3-tp's measurements (``t1``,
    ``s2``, ``s3``, ``s5``, ``s3tp``: their records, rank 0's for S2, S3, S5
    and S3-tp)."""
    import statistics
    proc, t_start = started
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DRYRUN_JOIN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"dryrun: the dry-run process failed:\n{err[-4000:]}")
    pred = json.loads(out.strip().splitlines()[-1])
    gb = lambda cell: pred[cell]["peak_bytes"] / 1e9
    t1_step_s = t1["median_s"]["grad"] + t1["median_s"]["update"]
    s2_peer = statistics.median(st["peer_bytes"] for st in s2["steps"])
    rows = {"T1 peak_gb": (gb("T1"), t1["peak_mem_gb"]),
            "S2 peak_gb": (gb("S2"), s2["peak_gb"]),
            "S2 bytes a step": (pred["S2"]["wire_bytes"], s2_peer),
            "S5 peak_gb": (gb("S5"), s5["peak_gb"]),
            "S3-tp Dispatch peak_gb": (gb("S3tp"), s3tp["dispatch"]["peak_gb"])}
    res = {"phase": "dryrun",
           "note": "predicted for one H100 (80 GB) by launch/dryrun on the host (meta "
                   "tensors, a fake world), beside this run's measurements on the card",
           "compared": {k: {"predicted": p, "measured": m, "ratio": p / m}
                        for k, (p, m) in rows.items()},
           "T1": {"predicted_flops": pred["T1"]["flops_per_device"],
                  "measured_step_s": t1_step_s,
                  "f32_peak_share": pred["T1"]["flops_per_device"] / t1_step_s / F32_FLOPS},
           "S2": {"collectives": pred["S2"]["collective_bytes"]},
           "S3": {"predicted_kernels": pred["S3"]["kernels"],
                  "kernel_billing": pred["S3"]["kernel_billing"],
                  "measured_launches": {k: s3["dispatch"]["launches"][k] for k in P1_KERNELS},
                  "predicted_peak_gb": gb("S3")},
           "plan": {**DRYRUN_PLAN, "arch": "flux-mmdit", "seq_len": T1["seq_len"],
                    "predicted_peak_gb": gb("plan"), "fits_80gb": pred["plan"]["fits"],
                    "argument_gb": pred["plan"]["argument_bytes"] / 1e9,
                    "wire_gb": pred["plan"]["wire_bytes"] / 1e9},
           "S5": {"collectives": pred["S5"]["collective_bytes"],
                  "argument_gb": pred["S5"]["argument_bytes"] / 1e9,
                  "measured_peer_bytes": s5["peer_bytes"]},
           "S3tp": {"predicted_kernels": pred["S3tp"]["kernels"],
                    "collectives": pred["S3tp"]["collective_bytes"],
                    "argument_gb": pred["S3tp"]["argument_bytes"] / 1e9,
                    "measured_max_gathered": s3tp["dispatch"]["max_gathered_bytes"]},
           "trace_s": {c: pred[c]["trace_s"] for c in ("T1", "S2", "S3", "S5", "S3tp", "plan")},
           "launches": pred["launches"], "seconds": time.perf_counter() - t0,
           "process_s": pred["seconds"], "started_s_before": t0 - t_start}
    emit(res)
    faults = [f"{k}: predicted {p:.4g}, measured {m:.4g}" for k, (p, m) in rows.items()
              if not 1 / DRYRUN_RATIO <= p / m <= DRYRUN_RATIO]
    want = {name: S3["n_layers"] for name in P1_KERNELS}
    if pred["S3"]["kernels"] != want or res["S3"]["measured_launches"] != want \
            or pred["S3"]["kernel_billing"] != "capacity":
        faults.append(f"S3: predicted kernels {pred['S3']['kernels']}, launched "
                      f"{res['S3']['measured_launches']}, want {want} at capacity")
    if any(pred["launches"].values()):
        faults.append(f"a kernel launched on meta: {pred['launches']}")
    if faults:
        raise AssertionError("dryrun: " + "; ".join(faults))
    return res


def main() -> int:
    t0 = time.perf_counter()
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
    dry = None
    try:
        smi = timed(phase_build)
        rows = timed(phase_kernels, torch.cuda.get_device_name(0), **FULL)
        timed(phase_small)
        timed(phase_analysis)
        served, by_path = {}, {}
        launches, t1 = timed(phase_train)
        by_path.update(launches)
        by_path.update(timed(phase_lm))
        by_path["long_context"] = timed(phase_long_context)
        by_path["P1"], served["P1"], p1_plans = timed(phase_serve)
        by_path["P2"], served["P2"] = timed(phase_serve_bucketed)
        by_path["ops"] = timed(phase_ops)
        timed(phase_twin, **FULL)
        timed(phase_rope, **FULL)
        by_path["M1"] = timed(phase_mesh, served["P1"], p1_plans)
        launches, shard_rank0 = timed(phase_sharding)
        by_path.update(launches)
        del p1_plans
        timed(phase_dense, served)
        del served
        by_path["C1"] = timed(phase_serve_batched)
        dry = start_dryrun()
        by_path["H1"] = timed(phase_hunyuan)
        timed(phase_kernels, torch.cuda.get_device_name(0), **H1_SHAPE,
              plans=("flashomni", "hunyuan-1.5x interior"), dtypes=("float32",),
              with_ops=False, iters=3, phase="kernels_33k")
        timed(phase_profile)
        timed(phase_dryrun, dry, t1, shard_rank0["S2"], shard_rank0["S3"], shard_rank0["S5"],
              shard_rank0["S3tp"])
    except Exception:                     # report the failing phase, then fail
        traceback.print_exc()
        return 1
    finally:
        if dry is not None and dry[0].poll() is None:
            dry[0].kill()
            dry[0].communicate()
    emit({"phase": "total", "seconds": round(time.perf_counter() - t0, 1)})
    # A kernel's launches are those of the path it belongs to (GEMM-Q runs on
    # every path; its count is P1's, and all are listed).
    path_of = lambda name: ("P1" if name in P1_KERNELS else
                            "P2" if name in P2_KERNELS else "ops")
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "path": path_of(name),
        "launches": by_path[path_of(name)][name],
        "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"], "library_ms": rows[name]["library_ms"],
        "library_call": LIBRARY[name]}
        for name in SOURCES]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
