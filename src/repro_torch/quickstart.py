"""FlashOmni quickstart on the PyTorch/CUDA port: the Update–Dispatch engine
on one attention layer, then every entry of the unified kernel entry
(:mod:`repro_torch.kernels.ops`) on that layer's own symbols.

  1. builds an MMDiT-style joint attention layer (text + vision tokens);
  2. Update step: full attention, sparse symbols refreshed from Q/K;
  3. Dispatch step: sparse attention guided by the packed uint8 symbols;
  4. shows the packed symbols, the live fraction and the error against a
     full-attention step;
  5. cross-checks the ``ops`` entries on the layer's symbols: the three
     attention variants (``symbols``, ``csr``, ``csr`` with 2 occupancy
     buckets) against the mask oracle ``ref.attention_ref`` (and the symbols
     variant bit for bit against ``csr``), ``taylor_reuse`` against
     ``taylorseer.forecast`` of the layer's per-head attention outputs on
     the cached blocks, ``gemm_q`` and ``gemm_o`` against dense products.

Usage (a port of ``examples/quickstart.py``, with the same flags):

    python -m repro_torch.quickstart [--strategy NAME] [--schedule NAME]
                                     [--full] [--device cpu]

It runs on the card unless given ``--device cpu`` (there each kernel
wrapper runs its plain version), and raises when asked for the card without
one.  ``--full`` runs the layer at flux-mmdit width (B=2, 24 heads × 128,
d_model 3072, 512 text + 4096 vision tokens, the serving launcher's
MaskConfig); the default is the reference's small layer.  ``--strategy``
swaps the sparse-symbol producer (any registry name) behind the same
engine; ``--schedule`` also runs a named SparsitySchedule through the
sampler on a smoke-size MMDiT.  A check beyond its tolerance raises.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from repro_torch.core import taylorseer
from repro_torch.core.attention import dense_attention
from repro_torch.core.engine import (AttnParams, EngineConfig, _project_heads, _qk,
                                     dispatch_layer, init_layer_state, update_layer)
from repro_torch.core.masks import MaskConfig
from repro_torch.core.schedule import MODE_NAMES, available_schedules, schedule_summaries
from repro_torch.core.strategy import available_strategies, strategy_summaries
from repro_torch.core.symbols import unpack_bits
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import resolve_device, serving_engine_config

__all__ = ["main", "run_layer", "check_ops", "demo_schedule", "TOL"]

#: rtol = atol of every float check (the layer runs in float32).
TOL = 1e-4


def _randn(g: torch.Generator, device, *shape, std: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device).mul_(std)


def _layer(full: bool, strategy: str, device, g: torch.Generator):
    """(cfg, params, x, heads, n_text): the reference quickstart's small
    layer, or one flux-mmdit block's attention at full width."""
    if full:
        b, h, n, dm, dh, n_text = 2, 24, 4608, 3072, 128, 512
        cfg = dataclasses.replace(serving_engine_config(strategy), cache_dtype=torch.float32)
    else:
        b, h, n, dm, dh, n_text = 1, 4, 512, 128, 32, 128
        cfg = EngineConfig(mask=MaskConfig(tau_q=0.5, tau_kv=0.05, interval=5, order=1,
                                           block_q=32, block_kv=32, pool=64, warmup_steps=1),
                           strategy=strategy, cache_dtype=torch.float32)
    params = AttnParams(
        wq=_randn(g, device, dm, h * dh, std=dm ** -0.5),
        wk=_randn(g, device, dm, h * dh, std=dm ** -0.5),
        wv=_randn(g, device, dm, h * dh, std=dm ** -0.5),
        wo=_randn(g, device, h * dh, dm, std=(h * dh) ** -0.5),
        q_scale=torch.ones(dh, device=device), k_scale=torch.ones(dh, device=device))
    return cfg, params, _randn(g, device, b, n, dm), h, n_text


def run_layer(cfg, params, x, heads: int, n_text: int,
              g: torch.Generator) -> tuple[dict, torch.Tensor, object]:
    """One Update and one Dispatch step; returns (report, x2, state)."""
    b, n, dm = x.shape
    dh = params.wq.shape[-1] // heads
    init = lambda: init_layer_state(b, heads, n, dm, dh, cfg, x.device)
    out_u, state = update_layer(params, x, init(), cfg, n_text=n_text, heads=heads)
    t = cfg.mask.n_blocks(n)
    m_c = unpack_bits(state.s_c, t)
    x2 = x + 0.02 * _randn(g, x.device, *x.shape)                  # the next denoising step
    out_d, state = dispatch_layer(params, x2, state, cfg, n_text=n_text, heads=heads)
    want, _ = update_layer(params, x2, init(), cfg, n_text=n_text, heads=heads)
    rel = float(torch.linalg.norm(out_d - want) / torch.linalg.norm(want))
    report = {"batch": b, "heads": heads, "n_tokens": n, "d_model": dm,
              "live_fraction": float(m_c.float().mean()), "dispatch_rel_err": rel,
              "finite": bool(torch.isfinite(out_u).all() and torch.isfinite(out_d).all())}
    print(f"S_c packed bytes (head 0): {state.s_c[0, 0].tolist()}")
    print(f"caching mask (head 0)    : {m_c[0, 0].int().tolist()} "
          "(1 = compute, 0 = cache-then-reuse)")
    print(f"live fraction            : {report['live_fraction']:.2f}")
    print(f"dispatch vs full-attention relative error: {rel:.4f}")
    print("  (random weights make attention near-uniform, the worst case for")
    print("   sparsity; on trained DiTs the skipped mass is ~0)")
    if not report["finite"]:
        raise AssertionError(f"the layer produced non-finite outputs: {report}")
    return report, x2, state


def _err(got: torch.Tensor, want: torch.Tensor, rows: Optional[torch.Tensor] = None) -> dict:
    """Max abs error (over ``rows`` of the second-last axis) and whether it is
    within TOL."""
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    return {"max_abs_err": float((got - want).abs().max()) if got.numel() else 0.0,
            "ok": bool(torch.allclose(got, want, rtol=TOL, atol=TOL))}


def check_ops(cfg, params, x_prev, x, state, heads: int, g: torch.Generator) -> dict:
    """Every ``ops`` entry on the layer's own symbols (``state``, the layer
    after its Update on ``x_prev`` and its Dispatch on ``x``) against its
    yardstick."""
    m = cfg.mask
    b, n, dm = x.shape
    bh, dev = b * heads, x.device
    dh = params.wq.shape[-1] // heads
    t, t_q, t_kv = m.n_blocks(n), n // m.block_q, n // m.block_kv
    fq, fkv = m.pool // m.block_q, m.pool // m.block_kv
    m_c_cmp = unpack_bits(state.s_c, t)                                     # (B, H, T)
    m_s_cmp = unpack_bits(state.s_s, t * t).reshape(b, heads, t, t)
    m_c = torch.repeat_interleave(m_c_cmp, fq, dim=-1)[..., :t_q].reshape(bh, t_q)
    m_s = torch.repeat_interleave(torch.repeat_interleave(m_s_cmp, fq, dim=-2), fkv,
                                  dim=-1)[..., :t_q, :t_kv].reshape(bh, t_q, t_kv)
    q, k = _qk(params, x, heads)
    flat = lambda a: a.reshape(bh, n, dh).contiguous()
    q, k, v = flat(q), flat(k), flat(_project_heads(x, params.wv, heads))
    o_reuse = _randn(g, dev, bh, n, dh)
    kw = dict(block_q=m.block_q, block_kv=m.block_kv)
    res = {}

    # Attention: the three variants against the mask oracle, on the rows
    # where oracle and kernels agree (cached rows, and live rows with a
    # non-empty mask row: ROADMAP C.4).
    want = ref.attention_ref(q, k, v, m_c, m_s, o_reuse, **kw)
    rows = torch.repeat_interleave(~m_c | m_s.any(dim=-1), m.block_q, dim=-1)
    sym = ops.flashomni_attention(q, k, v, m_c, m_s, o_reuse, variant="symbols", **kw)
    csr = ops.flashomni_attention(q, k, v, m_c, m_s, o_reuse, variant="csr", **kw)
    res["symbols"], res["csr"] = _err(sym, want, rows), _err(csr, want, rows)
    res["symbols_equal_csr"] = bool(torch.equal(sym, csr))
    del sym, csr, want
    # At 2 buckets a row's KV list may be cut to its bucket's width, so the
    # bucketed kernel is held against its plain version on the same layout.
    bkt, geometry = ops.bucketed_layout(m_c, m_s, kv_buckets=2, heads=heads)
    got = ops.flashomni_attention(q, k, v, m_c, m_s, o_reuse, kv_buckets=2, heads=heads, **kw)
    plain = ref.attention_csr_bucketed_ref(
        q, k, v, o_reuse, bkt["bkt_head"], bkt["bkt_q_ids"], bkt["bkt_q_src"],
        bkt["bkt_kv_ids"], bkt["bkt_kv_cnt"], geometry, heads=heads, **kw)
    res["bucketed"] = _err(got, plain)
    live_kv = int((m_s & m_c[..., None]).sum())
    res["bucketed"].update(geometry=[list(r) for r in geometry], live_kv_blocks=live_kv,
                           kept_kv_blocks=int(bkt["bkt_kv_cnt"].sum()),
                           dropped_share=1 - int(bkt["bkt_kv_cnt"].sum()) / max(live_kv, 1))
    del got, plain, q, k, v, o_reuse

    # OP_reuse over the cached blocks: the TaylorSeer stack of the layer's
    # per-head attention outputs at its two steps (what the o_cache mode
    # keeps), forecast one step on, against the stack's own forecast there.
    taylor = taylorseer.init_state((bh, n, dh), m.order, torch.float32, dev)
    for xi in (x_prev, x):
        qi, ki = _qk(params, xi, heads)
        taylor = taylorseer.update(taylor, flat(dense_attention(
            qi, ki, _project_heads(xi, params.wv, heads))))
    coef = taylorseer.reuse_coefficients(m.order, 1, m.interval)
    base = _randn(g, dev, bh, n, dh)
    got = ops.taylor_reuse(taylor.derivs, coef, base, ~m_c, block=m.block_q)
    tok = torch.repeat_interleave(~m_c, m.block_q, dim=-1)[..., None]
    res["taylor_reuse"] = _err(got, torch.where(tok, taylorseer.forecast(taylor, 1, m.interval),
                                                base))
    res["taylor_reuse"]["cached_blocks"] = int((~m_c).sum())
    del got, base, taylor

    # GEMM-Q (batch 0, scattered back) and GEMM-O (batch 0) on the live rows.
    row_mask = m_c_cmp[0].any(dim=0)                                       # (T,)
    y, _, _ = ops.gemm_q(x[0], params.wq, row_mask, block_rows=m.pool, compact=False)
    tok = torch.repeat_interleave(row_mask, m.pool)[:n, None]
    res["gemm_q"] = _err(y, torch.where(tok, x[0] @ params.wq, 0.0))
    m_ch = m_c_cmp[0].transpose(0, 1).contiguous()                         # (T, H)
    o_heads = _randn(g, dev, heads, n, dh)
    w = params.wo.reshape(heads, dh, dm)
    bias = _randn(g, dev, n, dm)
    got = ops.gemm_o(o_heads, w, bias, m_ch, block_rows=m.pool)
    live = torch.repeat_interleave(m_ch, m.pool, dim=0)[:n].transpose(0, 1)[..., None]
    res["gemm_o"] = _err(got, bias + torch.einsum("hnd,hdf->nf",
                                                  torch.where(live, o_heads, 0.0), w))
    lay = ops.gemm_o_layout(m_ch, hc_buckets=2)
    got = ops.gemm_o(o_heads, w, bias, m_ch, block_rows=m.pool, hc_buckets=2)
    gmo = lay["gmo"]
    plain = ref.gemm_o_bucketed_ref(o_heads[None], w, bias[None], gmo["gmo_rows"],
                                    gmo["gmo_src"], gmo["gmo_head_ids"],
                                    gmo["gmo_head_cnt"], lay["geometry"], block=m.pool)[0]
    res["gemm_o_bucketed"] = _err(got, plain)
    return res


def demo_schedule(name: str, device, g: torch.Generator) -> dict:
    """A named schedule driving the sampler on a smoke-size MMDiT."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core.engine import resolve_schedule
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    from repro_torch.models import dit
    print(f"\nschedule: {name} — {schedule_summaries()[name]}")
    cfg = get_smoke("flux-mmdit")
    ecfg = EngineConfig(
        mask=MaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.0,
                        block_q=16, block_kv=16, pool=16, warmup_steps=2),
        schedule=name, cache_dtype=torch.float32, cap_q_frac=1.0, cap_kv_frac=1.0)
    params = dit.init_params(cfg, g, device)
    x0 = _randn(g, device, 1, 64, cfg.patch_dim)
    text = _randn(g, device, 1, cfg.n_text_tokens, cfg.d_model)
    pe = _randn(g, device, cfg.patch_dim, cfg.d_model, std=0.2)
    out = sample(params, cfg, ecfg, text_emb=text, x0=x0, patch_embed=pe,
                 scfg=SamplerConfig(num_steps=8))
    sched = resolve_schedule(ecfg, 8, cfg.n_layers)
    print(f"  strategies: {[s.name for s in sched.strategies]}")
    print(f"  mode       : {[MODE_NAMES[int(mo)][0].upper() for mo in sched.mode]}")
    for i in range(sched.num_steps):
        print(f"  step {i} ids: {sched.strategy_ids[i].tolist()}")
    finite = bool(torch.isfinite(out).all())
    print(f"  out {tuple(out.shape)} finite={finite}")
    if not finite:
        raise AssertionError(f"schedule {name}: non-finite latents")
    return {"name": name, "strategies": [s.name for s in sched.strategies],
            "mode": sched.kinds(), "finite": finite}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strategy", default="flashomni", choices=available_strategies(),
                    help="sparse-symbol producer (see repro_torch.core.strategy)")
    ap.add_argument("--schedule", default=None, choices=available_schedules(),
                    help="also run a named SparsitySchedule through the sampler")
    ap.add_argument("--full", action="store_true",
                    help="the attention layer at flux-mmdit width")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False       # float32 checks at 1e-4
    print(f"strategy: {args.strategy} — {strategy_summaries()[args.strategy]}")
    g = torch.Generator(device=device)
    g.manual_seed(0)
    cfg, params, x, heads, n_text = _layer(args.full, args.strategy, device, g)
    layer, x2, state = run_layer(cfg, params, x, heads, n_text, g)
    res = check_ops(cfg, params, x, x2, state, heads, g)
    for key in ("symbols", "csr", "bucketed", "taylor_reuse", "gemm_q", "gemm_o",
                "gemm_o_bucketed"):
        print(f"ops {key:16s} max |err| {res[key]['max_abs_err']:.2e}")
    print(f"symbols variant bit-equal to csr: {res['symbols_equal_csr']}; the 2 buckets "
          f"dropped {res['bucketed']['dropped_share']:.1%} of the live KV blocks")
    bad = [key for key, r in res.items() if isinstance(r, dict) and not r["ok"]]
    if bad or not res["symbols_equal_csr"]:
        raise AssertionError(f"ops checks failed: {bad or 'symbols != csr'}: {res}")
    report = {"device": str(device), "strategy": args.strategy, "layer": layer, "ops": res}
    if args.schedule:
        report["schedule"] = demo_schedule(args.schedule, device, g)
    print("quickstart OK")
    return report


if __name__ == "__main__":
    main()
