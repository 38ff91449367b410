"""The dry run, port of ``repro.launch.dryrun``: one rank's sharded step of
every (arch × shape × mesh) cell, traced on ``meta`` tensors over a fake
world of the production mesh's size, and costed for one H100.

Usage (a CPU host; nothing is allocated and no card is needed)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sharded-gate [--mesh-sp 8]

Records: ``artifacts/dryrun/<arch>__<shape>__mesh<16x16|2x16x16>[__<mode>].json``.

The reference lowers each cell's step with ``jax.jit`` on 512 forced host
devices and reads XLA's cost, memory and HLO analyses.  Here:

* :func:`fake_world` initialises a fake process group (torch's ``"fake"``
  backend: every collective returns at once and moves nothing) of the
  mesh's size, as rank 0.  Every rank of a production mesh is symmetric,
  so rank 0's record is every rank's.
* :func:`run_cell` builds the cell's step with
  :mod:`repro_torch.launch.steps`, turns its ``in_shapes`` into ``meta``
  DTensors laid out by its ``in_placements`` (each at rank 0's local shard
  shape) and runs the step once under
  :func:`~repro_torch.analysis.op_walk.record_call`.  Every op of the rank
  reaches the recorder with its shapes; nothing is computed.  The kernel
  wrappers (B1-B7) take their ``meta`` route: they check the shapes and
  return an empty output, so a kernel is one region of the record, billed
  at its plan's capacity (a plan's live counts are data, which ``meta``
  tensors do not have; the reference's Pallas calls run the same static
  grid).
* The record is costed by :func:`~repro_torch.analysis.cost_model.
  cost_of_record` (FLOPs, bytes, each collective's payload and wire bytes)
  and :func:`~repro_torch.analysis.cost_model.peak_bytes_of`, in place of
  XLA's ``cost_analysis`` and ``memory_analysis``: ``argument_bytes`` (the
  rank's input shards), ``output_bytes``, ``peak_bytes`` and ``fits`` (the
  peak within one H100's 80 GB) stand for the reference's memory fields,
  and ``trace_s`` for its ``lower_s``/``compile_s``.

The port's models loop over their layers in Python (nothing reads
``ArchConfig.scan_layers``), so a step always records every layer, which is
the reference's ``--unroll``; there is no such flag.  A step reads a
value on the host only where the reference's step has it static: the
decode position (the port's ``decode_step`` takes an int) is given as the
cache's last slot, ``seq_len - 1``; the port's decode attends over every
slot under a length mask, so its cost does not depend on the position, as
the reference's traced step's does not.

These are predictions of the step's cost on one card made on the host,
not measurements; ``chip_smoke.py``'s ``dryrun`` phase holds them to what
its earlier phases measured on the H100.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Iterator, Optional

import torch

__all__ = ["H100", "fake_world", "mesh_label", "meta_args", "trace_step", "cost_fields",
           "roofline_terms", "build_cell", "record_cell", "run_cell", "sharded_dispatch_report",
           "sharded_gate_faults", "main"]

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates):
# peak FLOP/s in bf16/fp16 and in f32 outside the tensor cores (the port
# runs f32 products with TF32 off), HBM bytes/s, device memory, and NVLink's
# one-way bytes/s.
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_s": 3.35e12,
        "hbm_bytes": 80e9, "nvlink_bytes_s": 450e9}
_HALF = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A fake ``torch.distributed`` world of ``n`` ranks, this process rank
    0, for the block.  Raises if a world exists already.  On exit the group
    is destroyed and the sharding caches that hold its groups are cleared,
    so no later world meets them."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh
    if dist.is_initialized():
        raise RuntimeError("fake_world: a torch.distributed world is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sharding._ONE_HOST.clear()
        sharding._HOST_MESHES.clear()
        mesh._MESHES.clear()


def mesh_label(mesh) -> str:
    """``"16x16"``, ``"2x16x16"``: the mesh's shape."""
    return "x".join(str(s) for s in mesh.mesh.shape)


def _meta_dtensor(t: torch.Tensor, pl, mesh):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from repro_torch.launch.steps import _dtensor
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return _dtensor(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl, t.shape)


def meta_args(in_shapes, in_placements, mesh) -> tuple:
    """A builder's ``in_shapes`` as ``meta`` DTensors laid out by its
    ``in_placements``, each at this rank's local shard shape (the DiT's
    per-layer :class:`~repro_torch.core.engine.LayerState` lists through
    ``steps._state_tree``; host ints kept)."""
    from repro_torch.core.engine import LayerState
    from repro_torch.launch import steps as ST
    from repro_torch.tree import tree_map

    def one(t, pl):
        if isinstance(t, LayerState):
            tree = tree_map(one, ST._state_tree(t), ST._state_tree(pl), is_leaf=ST._is_pl)
            return ST._state_from_tree(tree, t)
        return _meta_dtensor(t, pl, mesh) if isinstance(t, torch.Tensor) else t

    return tuple(tree_map(one, s, p, is_leaf=ST._is_pl) for s, p in zip(in_shapes, in_placements))


def trace_step(fn, args: tuple) -> tuple:
    """``(record, seconds)``: ``fn(*args)`` run once under the op recorder."""
    from repro_torch.analysis.op_walk import record_call
    t0 = time.perf_counter()
    _, rec = record_call(fn, *args)
    return rec, time.perf_counter() - t0


def cost_fields(rec) -> dict:
    """The record's cost for one rank: FLOPs (and by the dtype of each op's
    operands), bytes, collectives (payload and wire bytes and count by
    kind), argument, output and peak bytes, whether the peak fits one H100,
    and the kernel regions (billed at capacity)."""
    from collections import Counter
    from repro_torch.analysis.cost_model import CostEstimate, op_cost, peak_bytes_of
    from repro_torch.analysis.op_walk import kernel_regions
    cost, by_dtype = CostEstimate(), Counter()
    for node in rec.nodes:                   # cost_of_record's sum, split by dtype
        if not node.path:
            one = op_cost(node)
            cost.add(one)
            dt = next((m.dtype for m in node.inputs if m.dtype.is_floating_point), None)
            by_dtype["bf16" if dt in _HALF else "f32"] += one.flops
    coll = {}
    for kind in sorted(cost.coll_payload):
        coll[kind] = cost.coll_payload[kind]
        coll[f"{kind}_wire"] = cost.coll_wire.get(kind, 0.0)
        coll[f"{kind}_count"] = cost.coll_count.get(kind, 0)
    peak = peak_bytes_of(rec)
    size = rec.storage_bytes
    return {"flops_per_device": cost.flops, "flops_by_dtype": dict(by_dtype),
            "bytes_per_device": cost.hbm_bytes, "collective_bytes": coll,
            "wire_bytes": cost.wire_bytes,
            "argument_bytes": float(sum(size[k] for k in rec.inputs)),
            "output_bytes": float(sum(size[k] for k in rec.outputs)),
            "peak_bytes": peak, "fits": peak <= H100["hbm_bytes"],
            "kernels": dict(Counter(kernel_regions(rec))), "kernel_billing": "capacity",
            "n_ops": len(rec.nodes)}


def roofline_terms(fields: dict) -> dict:
    """Seconds of one H100 at 700 W for a cost: compute (bf16 FLOPs at the
    tensor cores' peak, the rest at the f32 peak), memory (bytes at HBM's
    rate) and collective (wire bytes at NVLink's one-way rate; a lower
    bound: a mesh axis that crosses hosts is slower, and is not modelled),
    and the dominant term."""
    fl = fields["flops_by_dtype"]
    terms = {"t_compute_s": fl.get("bf16", 0.0) / H100["bf16_flops"]
             + fl.get("f32", 0.0) / H100["f32_flops"],
             "t_memory_s": fields["bytes_per_device"] / H100["hbm_bytes_s"],
             "t_collective_s": fields["wire_bytes"] / H100["nvlink_bytes_s"]}
    terms["dominant"] = max(("compute", "memory", "collective"),
                            key=lambda k: terms[f"t_{k}_s"])
    return terms


def build_cell(cfg, shape, mesh, rules, *, mode: str = "dispatch", ecfg=None, **kw):
    """``(entry, builder output)`` of the step of one cell, the reference's
    choice by the shape's kind, a DiT's serving cell its denoise step in
    ``mode`` (a train cell of a DiT, as ``chip_smoke.py`` runs, its train
    step)."""
    from repro_torch.launch import steps as ST
    if shape.kind == "train":
        return "train_step", ST.build_train_step(cfg, shape, mesh, rules, **kw)
    if cfg.family == "dit":
        return f"denoise_{mode}", ST.build_dit_step(cfg, shape, mesh, rules, mode=mode,
                                                    ecfg=ecfg, **kw)
    if shape.kind == "prefill":
        return "prefill", ST.build_prefill_step(cfg, shape, mesh, rules, **kw)
    return "decode_step", ST.build_decode_step(cfg, shape, mesh, rules, **kw)


def record_cell(cfg, shape, mesh, rules, *, mode: str = "dispatch", ecfg=None, **kw) -> dict:
    """The cost fields of one rank's step of a cell over ``mesh`` (a fake
    world of its size must be initialised)."""
    entry, (fn, in_shapes, in_pl, _) = build_cell(cfg, shape, mesh, rules, mode=mode,
                                                  ecfg=ecfg, **kw)
    args = meta_args(in_shapes, in_pl, mesh)
    if entry == "decode_step":
        args = args[:3] + (shape.seq_len - 1,)       # the position, static (module doc)
    rec, seconds = trace_step(fn, args)
    return {"entry": entry, **cost_fields(rec), "trace_s": round(seconds, 2)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, *,
             mode_override: Optional[str] = None) -> dict:
    """Trace and cost rank 0's step of one cell on the production mesh over
    a fake world of its size; write and return the record.  A DiT cell is
    its Dispatch step unless ``mode_override`` says ``"update"``.  Every
    layer is recorded (module doc)."""
    from repro_torch.configs.registry import arch_shapes, get_config
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    cfg = get_config(arch)
    shape = {s.name: s for s in arch_shapes(cfg)}[shape_name]
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = rules_for(cfg, shape, multi_pod=multi_pod)
        fields = record_cell(cfg, shape, mesh, rules, mode=mode_override or "dispatch")
        label = mesh_label(mesh)
    rec = {"arch": arch, "shape": shape_name, "entry": fields.pop("entry"),
           "mesh": label, "n_devices": world, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, **fields,
           "roofline": roofline_terms(fields),
           "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
           "device": "predicted for one NVIDIA H100 (80 GB, 700 W), traced on the host"}
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{mode_override}" if mode_override else ""
    path = out_dir / f"{arch}__{shape_name}__mesh{label}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    print(f"[dryrun] OK {arch} {shape_name} mesh{label}{suffix} "
          f"flops/dev={rec['flops_per_device']:.4g} peak={rec['peak_bytes'] / 1e9:.2f}GB "
          f"fits={rec['fits']} trace={rec['trace_s']}s -> {path}", flush=True)
    return rec


def sharded_dispatch_report(out_dir: Path, *, mesh_sp: int = 8, density: float = 0.25,
                            pair_slack: float = 1.5) -> dict:
    """Account the plan-sharded dispatch's collective bytes, the reference's
    cell: b 1, 2 heads, 1024 tokens, d_model 32, dh 16, blocks 16, at
    ``cap_kv_frac = density``.  The plan is built on the CPU from seeded
    inputs; then the seq-mode attention of
    :class:`~repro_torch.core.backend.MeshBackend` and a dense baseline that
    all-gathers K and V over the same seq group are recorded over a fake
    world of ``mesh_sp`` ranks and costed by the cost model.

    The plan-aware exchange ships ``mesh_sp · pair_cap`` blocks a shard
    (against ``T_kv`` for the dense all-gather), so at 25 % density and the
    default slack the ratio is ``⌈slack · cap_kv / P⌉ · P / T_kv = 0.375``.
    The port all-gathers the attention output besides (GEMM-Q and GEMM-O
    run replicated, :mod:`repro_torch.distributed.plan_shard`); that
    gather is reported on its own key with its formula.  The reference also
    parses the compiled HLO as a cross-check; the recorder is the only
    reading here, so there is none."""
    import torch.distributed as dist
    from repro_torch.analysis.cost_model import cost_of_record
    from repro_torch.analysis.op_walk import record_call
    from repro_torch.core.backend import get_backend
    from repro_torch.core.engine import (AttnParams, EngineConfig, _project_heads, _qk,
                                         init_layer_state, update_layer)
    from repro_torch.core.masks import MaskConfig
    from repro_torch.distributed.plan_shard import (dense_exchange_blocks, exchange_blocks,
                                                    shard_geometry)
    from repro_torch.launch.mesh import make_engine_mesh

    b, heads, n, dm, dh = 1, 2, 1024, 32, 16
    m = MaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3, block_q=16,
                   block_kv=16, pool=16, warmup_steps=2)
    cfg = EngineConfig(mask=m, cap_kv_frac=density, mesh_dp=1, mesh_sp=mesh_sp,
                       mesh_pair_slack=pair_slack)
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g)
    params = AttnParams(wq=rnd(dm, heads * dh) * 0.05, wk=rnd(dm, heads * dh) * 0.05,
                        wv=rnd(dm, heads * dh) * 0.05, wo=rnd(heads * dh, dm) * 0.05,
                        q_scale=torch.ones(dh), k_scale=torch.ones(dh))
    x = rnd(b, n, dm)
    _, st = update_layer(params, x, init_layer_state(b, heads, n, dm, dh, cfg, "cpu"), cfg,
                         heads=heads)
    plan, spec = st.plan.widen(), cfg.caps(n)
    q, k = _qk(params, x, heads)
    v = _project_heads(x, params.wv, heads)
    o_reuse = torch.zeros((b, heads, n, dh), dtype=q.dtype)

    with fake_world(mesh_sp):
        backend = get_backend(cfg)                           # MeshBackend
        _, rec = record_call(backend.attention, q, k, v, o_reuse, plan, spec)
        seq = make_engine_mesh(1, mesh_sp).seq
        n_l = n // mesh_sp

        def dense(k_, v_):                                   # this rank's token shard
            out = []
            for t in (k_, v_):
                full = t.new_empty((mesh_sp, *t.shape[:2], n_l, dh))
                dist.all_gather_into_tensor(full, t[:, :, :n_l].contiguous(), group=seq)
                out.append(full)
            return out

        _, drec = record_call(dense, k, v)
    scost, dcost = cost_of_record(rec), cost_of_record(drec)
    plan_bytes = scost.coll_payload.get("all_to_all", 0.0)
    dense_bytes = dcost.coll_payload.get("all_gather", 0.0)
    output_gather = scost.coll_payload.get("all_gather", 0.0)
    t_q = m.n_blocks(n) * (m.pool // m.block_q)
    t_kv = m.n_blocks(n) * (m.pool // m.block_kv)
    geom = shard_geometry(spec, t_q, t_kv, mesh_sp, pair_slack)
    itemsize = q.dtype.itemsize
    # One exchange each for K and V of (b, heads, P·pair_cap·block_kv, dh).
    formula_bytes = 2.0 * (b * heads * mesh_sp * geom.pair_cap * m.block_kv * dh) * itemsize
    rec_out = {
        "mesh_sp": mesh_sp, "density": density, "pair_slack": pair_slack,
        "plan_collective_bytes": plan_bytes,
        "plan_collective_wire": scost.coll_wire.get("all_to_all", 0.0),
        "plan_collective_count": scost.coll_count.get("all_to_all", 0),
        "dense_collective_bytes": dense_bytes,
        "ratio": plan_bytes / dense_bytes if dense_bytes else float("inf"),
        "formula_bytes": formula_bytes,
        "output_gather_bytes": output_gather,
        "output_gather_count": scost.coll_count.get("all_gather", 0),
        "output_gather_formula_bytes": float(b * heads * n * dh * itemsize),
        "extra_collectives": {k_: v_ for k_, v_ in scost.coll_payload.items()
                              if k_ not in ("all_to_all", "all_gather") and v_},
        "exchange_blocks_per_shard": exchange_blocks(geom),
        "dense_exchange_blocks": dense_exchange_blocks(t_kv),
        "sharded_collectives": {"payload": scost.coll_payload, "wire": scost.coll_wire,
                                "count": scost.coll_count},
        "dense_collectives": {"payload": dcost.coll_payload, "wire": dcost.coll_wire,
                              "count": dcost.coll_count},
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"sharded_dispatch__sp{mesh_sp}__d{density}.json"
    path.write_text(json.dumps(rec_out, indent=1, default=str))
    print(f"[dryrun] sharded dispatch: plan={plan_bytes:.0f}B dense={dense_bytes:.0f}B "
          f"ratio={rec_out['ratio']:.3f} output all-gather={output_gather:.0f}B -> {path}")
    return rec_out


def sharded_gate_faults(rec: dict) -> list:
    """What ``--sharded-gate`` fails on: a vanished exchange, a payload off
    the ``pair_cap`` formula, a collective besides the two all-to-alls and
    the output all-gather, a ratio of 0.5 or more."""
    faults = []
    if not rec["plan_collective_bytes"]:
        faults.append("the recorder sees 0 all_to_all bytes in the sharded dispatch: the "
                      "exchange vanished from the op stream")
    if rec["plan_collective_bytes"] != rec["formula_bytes"]:
        faults.append(f"a2a payload {rec['plan_collective_bytes']:.0f}B != pair_cap formula "
                      f"{rec['formula_bytes']:.0f}B")
    if rec["plan_collective_count"] != 2 or rec["output_gather_count"] != 1 \
            or rec["output_gather_bytes"] != rec["output_gather_formula_bytes"] \
            or rec["extra_collectives"]:
        faults.append(f"unexpected collectives {rec['sharded_collectives']} (want 2 "
                      f"all_to_all and the output all_gather of "
                      f"{rec['output_gather_formula_bytes']:.0f}B)")
    if rec["ratio"] >= 0.5:
        faults.append(f"plan-aware exchange at {rec['ratio']:.3f}x dense (>= 0.5)")
    return faults


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell; a DiT cell in both modes unless "
                         "--mode names one")
    ap.add_argument("--mode", default=None, help="dit: update|dispatch")
    ap.add_argument("--sharded-gate", action="store_true",
                    help="record the plan-sharded dispatch at 25%% density and assert its "
                         "all-to-all payload is the pair_cap formula, < 0.5x the dense "
                         "K/V all-gather over the same mesh")
    ap.add_argument("--mesh-sp", type=int, default=8, help="seq-shard count for --sharded-gate")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.sharded_gate:
        rec = sharded_dispatch_report(out_dir, mesh_sp=args.mesh_sp)
        faults = sharded_gate_faults(rec)
        if faults:
            raise SystemExit("[dryrun] sharded gate FAIL: " + "; ".join(faults))
        print(f"[dryrun] sharded gate OK: {rec['ratio']:.3f}x dense (payload == pair_cap "
              f"formula; output all-gather {rec['output_gather_bytes']:.0f}B apart)")
        return

    from repro_torch.configs.registry import ARCH_IDS, arch_shapes, get_config
    if args.all:
        cells = []
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            modes = [args.mode] if args.mode or cfg.family != "dit" else [None, "update"]
            cells += [(arch, sh.name, mode) for sh in arch_shapes(cfg) for mode in modes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, or --sharded-gate)")
        cells = [(args.arch, args.shape, args.mode)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, sh, mode in cells:
        for mp in meshes:
            try:
                run_cell(arch, sh, mp, out_dir, mode_override=mode)
            except Exception as e:  # noqa: BLE001 — record and go on to the next cell
                failures.append((arch, sh, mode, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} {sh} mode={mode} multi_pod={mp}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nAll {len(cells) * len(meshes)} dry-run cells traced OK.")


if __name__ == "__main__":
    main()
