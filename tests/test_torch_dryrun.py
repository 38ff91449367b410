"""The port's dry run (``repro_torch.launch.dryrun``): sharded steps traced
on ``meta`` tensors over a fake world, costed by the op recorder's cost
model.

  * ``arch_shapes``, ``n_params`` and ``n_active_params`` equal the
    reference's for all twelve archs;
  * collective accounting on a fake world of 8: a functional all-gather
    bills its result, a reduce-scatter its shard, an all-reduce the tensor,
    ``all_to_all_single`` the moved total, an in-place c10d op its output
    buffer; the wire bytes follow the reference's factors at the group's
    size, and ``_wrap_tensor_autograd`` / ``wait_tensor`` count as nothing;
  * each of the seven kernel wrappers on ``meta`` returns the shape and
    dtype of its plain version on the CPU and launches nothing;
  * the smoke gemma3-1b train, prefill and decode cells on a fake world of
    8: FLOPs, bytes, collectives and peak recorded on ``meta`` equal those
    recorded on CPU tensors of the same shapes;
  * the smoke gemma3-1b train cell (3 layers) at 4096 tokens over a fake world of 2 on
    mesh (1, 2): splitting the ``model`` axis predicts a lower peak than
    computing it replicated, and bills the row's all-reduces;
  * the smoke train cells of mamba2, recurrentgemma, whisper and
    llama-3.2-vision (64 tokens) over a fake world of 2 on mesh (1, 2): with
    the ``model`` axis split, their weight products (``aten.mm``/``addmm``,
    forward and backward) take at most 0.56 of the FLOPs they take computed
    replicated (a half, plus what every rank computes whole: the ssm's B
    and C columns, the vlm's K/V), and the peak is no higher;
  * gemma3-1b's ``decode_32k`` cell on the production mesh (16, 16) keeps
    each rank's ``sp`` shard of the cache: the step moves no cache byte,
    its all-gathers carry less in all than gathering the cache over the
    ``sp`` group alone would, and its peak lies less than one layer's K/V,
    whole over the group, above its arguments;
  * the flux-mmdit smoke DiT cell records in both modes; Dispatch holds
    B1-B3 once a layer, each billed at the plan's capacity;
  * hunyuan-video-dit's ``dit_serve`` cell on the production mesh (16, 16),
    where each rank computes its ``sp`` rows of the 33 024 tokens: FLOPs a
    rank at most 1/8 of what the step cost when every rank computed the
    whole sequence (8.155e14 at Update, 4.639e14 at Dispatch) and a peak no
    higher than it was (23.86 / 21.91 GB);
  * whisper-large-v3's ``train_4k`` cell on (16, 16), whose 20 heads the
    row of 16 now splits 2 and 1 (ROADMAP C.14): a peak a rank below the
    92.5 GB it took computed replicated;
  * ``sharded_dispatch_report``'s payload equals the formula from the
    reference's pure ``shard_geometry`` and ``exchange_blocks``, under half
    the dense all-gather, with the output all-gather reported apart;
  * ``fake_world`` leaves no process group behind and refuses to nest.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as ref_registry
from repro_torch.analysis.cost_model import (CostEstimate, cost_of_record, kernel_cost, op_cost,
                                             peak_bytes_of)
from repro_torch.analysis.op_walk import collective_kind, record_call
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _kernel_cases import KERNEL_NAMES, kernel_call, kernel_calls, on  # noqa: E402

WORLD = 8


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_arch_shapes_and_parameter_counts_match_the_reference(arch):
    cfg, ref = registry.get_config(arch), ref_registry.get_config(arch)
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert ([dataclasses.astuple(s) for s in registry.arch_shapes(cfg)]
            == [dataclasses.astuple(s) for s in ref_registry.arch_shapes(ref)])
    assert (cfg.n_params(), cfg.n_active_params()) == (ref.n_params(), ref.n_active_params())


def test_all_has_37_cells():
    assert sum(len(registry.arch_shapes(registry.get_config(a)))
               for a in registry.ARCH_IDS) == 37


def _functional(kind, t):
    import torch.distributed._functional_collectives as funcol
    g = dist.group.WORLD
    out = {"all_gather": lambda: funcol.all_gather_tensor(t, 0, g),
           "reduce_scatter": lambda: funcol.reduce_scatter_tensor(t, "sum", 0, g),
           "all_reduce": lambda: funcol.all_reduce(t, "sum", g),
           "all_to_all": lambda: funcol.all_to_all_single(t, None, None, g)}[kind]()
    return out * 1                                        # waits on the result


# (kind, payload in units of the input's bytes, wire in units of the payload)
FUNCTIONAL = [("all_gather", WORLD, (WORLD - 1) / WORLD),
              ("reduce_scatter", 1 / WORLD, WORLD - 1),
              ("all_reduce", 1, 2 * (WORLD - 1) / WORLD),
              ("all_to_all", 1, (WORLD - 1) / WORLD)]


@pytest.mark.parametrize("kind,payload,wire", FUNCTIONAL, ids=[c[0] for c in FUNCTIONAL])
def test_functional_collective_bills_its_result(kind, payload, wire):
    x = torch.empty((WORLD, 16), device="meta")
    with D.fake_world(WORLD):
        _, rec = record_call(_functional, kind, x)
    coll = [n for n in rec.nodes if collective_kind(n.name) is not None]
    assert [(collective_kind(n.name), n.group_size) for n in coll] == [(kind, WORLD)]
    cost = cost_of_record(rec)
    assert cost.coll_payload == {kind: payload * x.nbytes}
    assert cost.coll_wire == {kind: pytest.approx(wire * payload * x.nbytes)}
    assert cost.coll_count == {kind: 1}
    # the bookkeeping around the result is neither a collective nor work
    hand_on = [n for n in rec.nodes if n.name.startswith("_c10d_functional.")
               and collective_kind(n.name) is None]
    assert hand_on and all(op_cost(n) == CostEstimate() for n in hand_on)


def test_bookkeeping_ops_are_not_collectives():
    for name in ("_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"):
        assert collective_kind(name) is None
    assert collective_kind("c10d.alltoall_base_") == "all_to_all"
    assert collective_kind("c10d._reduce_scatter_base_") == "reduce_scatter"
    assert collective_kind("_c10d_functional.all_gather_into_tensor") == "all_gather"
    assert collective_kind("c10d.barrier") == "c10d.barrier"
    assert collective_kind("aten.mm") is None


def test_c10d_in_place_collectives_bill_their_output_buffer():
    x = torch.zeros((WORLD, 16))

    def c10d_ops(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        full = t.new_empty((WORLD * WORLD, 16))
        dist.all_gather_into_tensor(full, t)
        dist.all_reduce(t)
        return out, full

    with D.fake_world(WORLD):
        _, rec = record_call(c10d_ops, x)
    cost = cost_of_record(rec)
    assert cost.coll_payload == {"all_to_all": x.nbytes, "all_gather": WORLD * x.nbytes,
                                 "all_reduce": x.nbytes}
    assert cost.coll_wire == pytest.approx({"all_to_all": x.nbytes * 7 / 8,
                                            "all_gather": x.nbytes * 7,
                                            "all_reduce": x.nbytes * 14 / 8})


def test_the_cases_cover_every_wrapper():
    assert sorted(c[0].__name__ for c in kernel_calls()) == sorted(KERNEL_NAMES)
    assert len(KERNEL_NAMES) == 7


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_wrapper_on_meta_returns_its_shape_and_launches_nothing(name):
    fn, args, kw = kernel_call(name)
    want = fn(*args, **kw)
    launches = fn.launches
    got = fn(*on("meta", args), **kw)
    assert got.is_meta and (got.shape, got.dtype) == (want.shape, want.dtype)
    assert fn.launches == launches


def _cpu_twin(args):
    """The meta DTensor args as CPU DTensors of the same shapes (zeros)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import _dtensor
    from repro_torch.tree import tree_map
    twin = lambda x: (_dtensor(torch.zeros(x.to_local().shape, dtype=x.dtype), x.device_mesh,
                               list(x.placements), x.shape) if isinstance(x, DTensor) else x)
    return tuple(tree_map(twin, a) for a in args)


def _cost(rec) -> tuple:
    c = cost_of_record(rec)
    return c.flops, c.hbm_bytes, c.coll_payload, c.coll_wire, peak_bytes_of(rec)


LM_CELLS = [ShapeSpec("train", 32, 2, "train"), ShapeSpec("prefill", 32, 2, "prefill"),
            ShapeSpec("decode", 64, 4, "decode")]


def _mesh_2x4():
    """(data 2, model 4) over the fake world of 8: both the fsdp and the tp
    dims of the parameters are sharded."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 4), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("shape", LM_CELLS, ids=[s.kind for s in LM_CELLS])
def test_smoke_lm_cell_costs_the_same_on_meta_and_on_the_cpu(shape):
    from repro_torch.launch.mesh import rules_for
    cfg = registry.get_smoke("gemma3-1b")
    with D.fake_world(WORLD):
        mesh = _mesh_2x4()
        entry, (fn, in_shapes, in_pl, _) = D.build_cell(
            cfg, shape, mesh, rules_for(cfg, shape, multi_pod=False), dtype=torch.float32)
        args = D.meta_args(in_shapes, in_pl, mesh)
        if entry == "decode_step":
            args = args[:3] + (shape.seq_len - 1,)
        rec_meta, _ = D.trace_step(fn, args)
        rec_cpu, _ = D.trace_step(fn, _cpu_twin(args))
    assert _cost(rec_meta) == _cost(rec_cpu)
    fields = D.cost_fields(rec_meta)
    assert fields["flops_per_device"] > 0 and fields["peak_bytes"] >= fields["argument_bytes"]
    assert fields["collective_bytes"]["all_gather"] > 0
    if shape.kind == "train":                 # the gradients' and the loss's sums over dp
        assert fields["collective_bytes"]["all_reduce"] > 0


def test_split_model_axis_lowers_the_predicted_peak_and_bills_the_row(monkeypatch):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch import steps as ST
    cfg = dataclasses.replace(registry.get_smoke("gemma3-1b"), n_layers=3)   # one cycle
    shape = ShapeSpec("train_4k", 4096, 2, "train")
    fields = {}
    for split in (True, False):
        monkeypatch.setattr(ST, "_splits_model", lambda *a, split=split: split)
        with D.fake_world(2):
            mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                              mesh_dim_names=("data", "model"))
            fields[split] = D.record_cell(cfg, shape, mesh, DEFAULT_RULES, dtype=torch.float32)
    assert fields[True]["peak_bytes"] < fields[False]["peak_bytes"]
    assert fields[True]["flops_per_device"] < fields[False]["flops_per_device"]
    row = fields[True]["collective_bytes"]
    assert row["all_reduce"] > fields[False]["collective_bytes"].get("all_reduce", 0)
    assert row["all_reduce_count"] >= 2 * cfg.n_layers      # g after attention and MLP


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_split_families_run_their_products_on_the_ranks_width(monkeypatch, arch):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch import steps as ST
    cfg = registry.get_smoke(arch)
    shape = ShapeSpec("train", 64, 2, "train")
    mm, peak = {}, {}
    for split in (True, False):
        monkeypatch.setattr(ST, "_splits_model", lambda *a, split=split: split)
        with D.fake_world(2):
            mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                              mesh_dim_names=("data", "model"))
            _, (fn, in_shapes, in_pl, _) = D.build_cell(cfg, shape, mesh, DEFAULT_RULES,
                                                        dtype=torch.float32)
            rec, _ = D.trace_step(fn, D.meta_args(in_shapes, in_pl, mesh))
        mm[split] = sum(op_cost(n).flops for n in rec.nodes
                        if n.name in ("aten.mm", "aten.addmm"))
        peak[split] = peak_bytes_of(rec)
    assert 0 < mm[True] <= 0.56 * mm[False]
    assert peak[True] <= peak[False]


def test_decode_cell_keeps_the_cache_sequence_shard_on_its_rank():
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_leaves
    cfg, shape = registry.get_config("gemma3-1b"), SHAPES["decode_32k"]
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rules = rules_for(cfg, shape, multi_pod=False)
        _, (fn, in_shapes, in_pl, _) = D.build_cell(cfg, shape, mesh, rules)
        args = D.meta_args(in_shapes, in_pl, mesh)
        rec, _ = D.trace_step(fn, args[:3] + (shape.seq_len - 1,))
        moved = fn.stats["cache_moved_bytes"]
        n_sp = mesh.size(mesh.mesh_dim_names.index("model"))
    fields = D.cost_fields(rec)
    # One rank's batch (the cache's dp shard): every K/V slot of the cache
    # whole over the sp group, and one global layer's K and V.
    cache = get_model(cfg).init_cache(shape.global_batch // mesh.size(0), shape.seq_len,
                                      device="meta")
    kv_bytes = lambda t: t.numel() * t.element_size()
    whole = sum(kv_bytes(t) for key, c in cache.items() if key != "len" for t in tree_leaves(c))
    layer = 2 * kv_bytes(cache["globals"]["k"][0])
    assert n_sp == 16 and moved == 0
    assert fields["collective_bytes"]["all_gather"] < whole
    assert fields["peak_bytes"] - fields["argument_bytes"] < layer


def test_smoke_dit_cell_records_both_modes_with_kernels_at_capacity():
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    from repro_torch.launch.steps import default_dit_engine_config
    cfg = registry.get_smoke("flux-mmdit")
    ecfg = default_dit_engine_config()
    ecfg = dataclasses.replace(ecfg, mask=dataclasses.replace(ecfg.mask, block_q=16,
                                                              block_kv=16, pool=32))
    shape = ShapeSpec("dit", cfg.n_text_tokens + 96, 2, "dit")
    fields = {}
    with D.fake_world(WORLD):
        mesh = make_production_mesh(device_type="cpu")
        rules = rules_for(cfg, shape, multi_pod=False)
        for mode in ("update", "dispatch"):
            fields[mode] = D.record_cell(cfg, shape, mesh, rules, mode=mode, ecfg=ecfg)
    b2 = "flashomni_attention_csr"
    assert fields["update"]["kernels"] == {}
    assert fields["dispatch"]["kernels"] == {k: cfg.n_layers for k in
                                             ("gemm_q_sparse_kernel", b2,
                                              "gemm_o_sparse_kernel")}
    assert fields["dispatch"]["kernel_billing"] == "capacity"
    # B2 at capacity: every (b·h, q slot, KV slot) of the static grid live.
    spec, m = ecfg.caps(shape.seq_len), ecfg.mask
    bh, dh = shape.global_batch * cfg.n_heads, cfg.hd
    want = kernel_cost(b2, dict(bh=bh, n=shape.seq_len, dh=dh, block_q=m.block_q,
                                block_kv=m.block_kv, live_slots=bh * spec.cap_q,
                                kv_live_blocks=bh * spec.cap_q * spec.cap_kv,
                                kv_union_blocks=bh * spec.cap_q * spec.cap_kv), torch.bfloat16)
    with D.fake_world(WORLD):
        mesh = make_production_mesh(device_type="cpu")
        _, (fn, in_shapes, in_pl, _) = D.build_cell(cfg, shape, mesh, rules, ecfg=ecfg)
        rec, _ = D.trace_step(fn, D.meta_args(in_shapes, in_pl, mesh))
    b2_nodes = [n for n in rec.nodes if n.name == b2]
    assert len(b2_nodes) == cfg.n_layers
    assert all(op_cost(n) == want for n in b2_nodes)
    for mode in ("update", "dispatch"):
        assert fields[mode]["flops_per_device"] > 0
        assert D.roofline_terms(fields[mode])["dominant"] in ("compute", "memory",
                                                              "collective")


# hunyuan-video-dit dit_serve on (16, 16) with the whole sequence on every
# rank (the parent tree's dry run): FLOPs a rank and peak bytes, by mode.
HUNYUAN_WHOLE_SEQUENCE = {"update": (8.155e14, 23.86e9), "dispatch": (4.639e14, 21.91e9)}


@pytest.mark.parametrize("mode", ["update", "dispatch"])
def test_hunyuan_dit_cell_computes_each_ranks_sequence_rows(mode):
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    cfg = registry.get_config("hunyuan-video-dit")
    (shape,) = registry.arch_shapes(cfg)
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        fields = D.record_cell(cfg, shape, mesh, rules_for(cfg, shape, multi_pod=False),
                               mode=mode)
    flops, peak = HUNYUAN_WHOLE_SEQUENCE[mode]
    assert fields["flops_per_device"] <= flops / 8
    assert fields["peak_bytes"] <= peak


def test_whisper_train_cell_splits_its_heads_unevenly_over_the_row():
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    cfg, shape = registry.get_config("whisper-large-v3"), SHAPES["train_4k"]
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        entry, (fn, in_shapes, in_pl, _) = D.build_cell(cfg, shape, mesh,
                                                        rules_for(cfg, shape, multi_pod=False))
        rec, _ = D.trace_step(fn, D.meta_args(in_shapes, in_pl, mesh))
    assert entry == "train_step" and fn.stats["tp_replicated"] == []
    assert D.cost_fields(rec)["peak_bytes"] < 92.5e9


def test_sharded_dispatch_report_meets_the_pair_cap_formula(tmp_path):
    from repro.core.engine import EngineConfig as RefEngineConfig
    from repro.core.masks import MaskConfig as RefMaskConfig
    from repro.distributed.plan_shard import exchange_blocks, shard_geometry
    rec = D.sharded_dispatch_report(tmp_path)
    m = RefMaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3, block_q=16,
                      block_kv=16, pool=16, warmup_steps=2)
    n, sp = 1024, 8
    t = m.n_blocks(n) * (m.pool // m.block_kv)
    geom = shard_geometry(RefEngineConfig(mask=m, cap_kv_frac=0.25).caps(n), t, t, sp, 1.5)
    b, heads, dh = 1, 2, 16
    assert rec["plan_collective_bytes"] == 2 * b * heads * exchange_blocks(geom) * 16 * dh * 4
    assert rec["exchange_blocks_per_shard"] == exchange_blocks(geom)
    assert rec["dense_collective_bytes"] == 2 * b * heads * n * dh * 4
    assert rec["ratio"] == pytest.approx(0.375) and rec["ratio"] < 0.5
    assert rec["output_gather_bytes"] == rec["output_gather_formula_bytes"] == b * heads * n * dh * 4
    assert D.sharded_gate_faults(rec) == []
    assert (tmp_path / "sharded_dispatch__sp8__d0.25.json").exists()
    assert not dist.is_initialized()


def test_fake_world_leaves_no_group_and_refuses_to_nest():
    from repro_torch.distributed import sharding
    with D.fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="initialised already"):
            with D.fake_world(2):
                pass
        sharding._HOST_MESHES["stale"] = object()
    assert not dist.is_initialized()
    assert sharding._HOST_MESHES == {} and sharding._ONE_HOST == []


def test_perf_probe_prints_the_three_h100_terms(tmp_path, capsys):
    from repro_torch.launch import perf_probe
    rec = perf_probe.probe("gemma3-1b", "decode_32k", out=str(tmp_path))
    line = capsys.readouterr().out
    for part in ("compute=", "memory=", "collective>=", "dom=", "lower bound", "700 W"):
        assert part in line
    assert rec["device"] == D.H100
    assert rec["t_memory_s"] == rec["bytes"] / 3.35e12
    assert rec["t_collective_s"] == rec["coll_wire_bytes"] / 450e9
    assert rec["t_compute_s"] == pytest.approx(rec["flops_by_dtype"].get("bf16", 0) / 989e12
                                               + rec["flops_by_dtype"].get("f32", 0) / 67e12)
    assert rec["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda k: rec[f"t_{k}_s"])
    assert (tmp_path / "gemma3-1b__decode_32k__probe.json").exists()


def test_roofline_sweep_runs_every_cell_smallest_first(monkeypatch, capsys):
    from repro_torch.launch import roofline_sweep
    seen = []

    def run_cell(arch, shape, multi_pod, out):
        seen.append((arch, shape))
        if (arch, shape) == ("llama3-405b", "train_4k"):
            raise RuntimeError("out of memory")

    monkeypatch.setattr(D, "run_cell", run_cell)
    roofline_sweep.main()
    assert len(seen) == len(set(seen)) == 37
    weight = {"decode_32k": 0, "long_500k": 0, "dit_serve": 1, "prefill_32k": 2, "train_4k": 3}
    assert [weight[s] for _, s in seen] == sorted(weight[s] for _, s in seen)
    assert "37 cells, 1 failures" in capsys.readouterr().out


def test_dryrun_cli_gates_and_fails_a_cell_that_raises(tmp_path, capsys):
    D.main(["--sharded-gate", "--out", str(tmp_path)])
    assert "sharded gate OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "gemma3-1b", "--shape", "no_such_shape", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert not dist.is_initialized()
