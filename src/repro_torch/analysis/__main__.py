"""CLI of the port's invariant analyzer: ``python -m repro_torch.analysis``.

    python -m repro_torch.analysis [--passes GLOBS] [--fixture NAME] [--src DIR]
                                   [--device cuda|cpu] [-q]
    torchrun --nproc-per-node 2 -m repro_torch.analysis --device cpu

Exit code 0 = no findings; 1 = at least one finding.  The engine runs on
the card unless ``--device cpu`` is given (the kernel wrappers then run
their plain versions); without a card the default raises.  Under
``torchrun`` with two ranks the mesh combos run too (a ``gloo`` world;
rank 0 prints); in one process they are noted skips.

``--fixture NAME`` runs the owning pass against a deliberately broken input
instead of the repo: each fixture MUST produce findings (exit 1).

* ``injected-sort``          — a dispatch-shaped function with a smuggled sort
* ``bad-plan``               — a real plan hand-mutated to violate fold-back
                               (counts past widths, out-of-range ids)
* ``uncovered-field``        — a plan leaf ``widen()`` does not cover (int16)
* ``id-cache``               — a module caching by ``id(obj)`` in an unbounded
                               module-level dict
* ``dense-einsum-dispatch``  — a dispatch body hiding a dense ``T_kv``-wide
                               einsum (cost super-linear in ``T_kv``)
* ``rebuild-every-dispatch`` — an engine paying Update's plan build on every
                               Dispatch step
* ``memory-hog``             — a call whose peak live bytes blow the budget
* ``mesh-allgather``         — a mesh body all-gathering the full K and V
                               instead of the plan-live blocks (needs the
                               two-rank world; without one it exits 1 with
                               the reason)
"""

from __future__ import annotations

import argparse
import os
import sys

FIXTURES = ("injected-sort", "bad-plan", "uncovered-field", "id-cache",
            "dense-einsum-dispatch", "rebuild-every-dispatch", "memory-hog")
# Fixtures that need the two-rank world of the mesh combos.
MESH_FIXTURES = ("mesh-allgather",)


def _fixture_findings(name: str, device: str):
    import torch

    from repro_torch.analysis import Finding
    from repro_torch.analysis.op_walk import record_call
    if name == "injected-sort":
        from repro_torch.analysis.op_walk import index_decode_ops

        def dispatch_like(x, ids):
            # Pretends to read a plan but re-derives the order.
            return x[torch.sort(ids).values]

        _, rec = record_call(dispatch_like, torch.ones((8, 4), device=device),
                             torch.arange(8, device=device))
        return [Finding("dispatch-purity", "no-index-decode-in-dispatch",
                        "fixture[injected-sort]", f"{node.overload} in the dispatch record")
                for _, node in index_decode_ops(rec)]
    if name in ("bad-plan", "uncovered-field"):
        from repro_torch.analysis import PlanValidator
        from repro_torch.analysis.passes import _N, _engine_cfg
        from repro_torch.analysis.plan_check import check_plan
        cfg = _engine_cfg(kv_buckets=3)
        plan = PlanValidator.plan(cfg, device)
        if name == "bad-plan":
            plan = plan._replace(
                # counts past the bucket widths AND ids out of range
                bkt_kv_cnt=plan.bkt_kv_cnt + 7,
                kv_row_ids=torch.full_like(plan.kv_row_ids, 2 ** 14))
        else:
            # a field widen() does not know about stays int16
            plan = plan._replace(q_cnt=plan.q_cnt.to(torch.int16))
        return [Finding("plan-validator", "plan-invariant", f"fixture[{name}]", msg)
                for msg in check_plan(plan, cfg, _N)]
    if name == "dense-einsum-dispatch":
        from repro_torch.analysis.cost_model import cost_of_record
        from repro_torch.analysis.cost_passes import (KAPPA_TOKEN, KAPPA_TOKEN_BYTES,
                                                      token_reference_slope,
                                                      token_scaling_findings)
        cap = 32                         # fixed live plan slots

        def dispatch_like(x, k):
            # legitimate plan-capacity work: gather `cap` rows...
            live = x[torch.arange(cap, device=x.device)]
            # ...plus a smuggled dense T_kv x T_kv score matrix.
            scores = torch.einsum("nd,md->nm", x, k)
            return live.sum() + scores.sum()

        ns = (128, 256, 384)
        costs = [cost_of_record(record_call(dispatch_like, torch.ones((n, 16), device=device),
                                            torch.ones((n, 16), device=device))[1])
                 for n in ns]
        ref_f, ref_b = token_reference_slope(device)
        return token_scaling_findings(
            "cost-dispatch-scaling", "fixture[dense-einsum-dispatch]", costs, ns,
            budget_flops=KAPPA_TOKEN * ref_f, budget_bytes=KAPPA_TOKEN_BYTES * ref_b)
    if name == "rebuild-every-dispatch":
        from repro_torch.analysis.cost_passes import (_costs, amortization_findings,
                                                      dense_reference_cost, matched)
        from repro_torch.analysis.passes import _N, _engine_cfg
        cfg = matched(_engine_cfg(kv_buckets=1), 2, 2, _N)
        u, _ = _costs(cfg, _N, device)
        # dispatch cost := update cost: the plan is rebuilt every step
        return amortization_findings("cost-update-amortization",
                                     "fixture[rebuild-every-dispatch]", u, u,
                                     dense_reference_cost(_N, device), cfg.mask.interval)
    if name == "memory-hog":
        from repro_torch.analysis.cost_model import peak_bytes_of
        from repro_torch.analysis.cost_passes import PEAK_BUDGETS, footprint_findings

        def hog(x):
            big = torch.zeros((512, 512), device=x.device)      # 1 MB scratch
            return (x[:, None] * big).sum() + x.sum()

        _, rec = record_call(hog, torch.ones(512, device=device))
        return footprint_findings("cost-memory-footprint", "fixture[memory-hog]",
                                  peak_bytes_of(rec), PEAK_BUDGETS["dispatch_layer"])
    if name == "id-cache":
        from repro_torch.analysis.source_lint import lint_source
        src = ("_PLAN_CACHE = {}\n"
               "def lookup(spec):\n"
               "    key = id(spec)\n"
               "    if key not in _PLAN_CACHE:\n"
               "        _PLAN_CACHE[key] = build(spec)\n"
               "    return _PLAN_CACHE[key]\n")
        return [Finding("source-lint", rule, f"fixture[id-cache]:{line}", msg)
                for _, line, rule, msg in lint_source(src)]
    if name == "mesh-allgather":
        import torch.distributed as dist

        from repro_torch.analysis.cost_model import cost_of_record
        from repro_torch.analysis.cost_passes import (collective_findings,
                                                      expected_a2a_payload,
                                                      expected_gather_payload, matched)
        from repro_torch.analysis.passes import (_B, _DH, _H, MESH, _engine_cfg,
                                                 mesh_skip_reason)
        from repro_torch.distributed.plan_shard import _all_gather
        if mesh_skip_reason() is not None:
            raise SystemExit(f"mesh-allgather fixture {mesh_skip_reason()}")
        n = 256
        cfg = matched(_engine_cfg(mesh_dp=MESH[0], mesh_sp=MESH[1]), 2, 2, n)

        def body(k, v):
            # ships the FULL K and V instead of the plan-live pair_cap blocks
            out = []
            for x in (k, v):
                full = x.new_empty((dist.get_world_size() * x.shape[0], *x.shape[1:]))
                _all_gather(full, x)
                out.append(full)
            return out

        kv = torch.ones((_B * _H * n // dist.get_world_size(), _DH), device=device)
        _, rec = record_call(body, kv, kv)
        return collective_findings(
            "cost-collective-bytes", "fixture[mesh-allgather]", cost_of_record(rec),
            expected_a2a_payload(cfg, n), 2.0 * (_B * _H * n * _DH) * 4,
            expected_gather_payload(n))
    raise SystemExit(f"unknown fixture {name!r}; known: {list(FIXTURES + MESH_FIXTURES)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="FlashOmni port: engine invariant analyzer")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass names or fnmatch globs, e.g. 'cost-*' "
                         "(default: all)")
    ap.add_argument("--fixture", default=None,
                    help="run against an adversarial fixture instead of the repo "
                         "(expected to FAIL)")
    ap.add_argument("--src", default=None, help="source root to lint (holds repro_torch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default: the card)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis import ALL_PASSES, _check_device, run_analysis
    _check_device(args.device)
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_process_group("gloo")              # torchrun's env:// variables
    if dist.is_initialized() and dist.get_rank() != 0:
        args.quiet = True
    if args.fixture:
        findings = _fixture_findings(args.fixture, args.device)
        if not args.quiet:
            for f in findings:
                print(f"  {f}")
        print(f"fixture {args.fixture}: {len(findings)} finding(s)")
        return 1 if findings else 0

    passes = ALL_PASSES()
    if args.passes:
        import fnmatch
        pats = [p.strip() for p in args.passes.split(",") if p.strip()]
        known = {p.name for p in passes}
        bad = [pat for pat in pats if not any(fnmatch.fnmatch(n, pat) for n in known)]
        if bad:
            raise SystemExit(f"pattern(s) {sorted(bad)} match no pass; known: {sorted(known)}")
        passes = [p for p in passes if any(fnmatch.fnmatch(p.name, pat) for pat in pats)]
    findings = run_analysis(passes=passes, src_root=args.src, device=args.device,
                            verbose=not args.quiet)
    print(f"invariant analysis: {len(findings)} finding(s) across {len(passes)} pass(es)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
