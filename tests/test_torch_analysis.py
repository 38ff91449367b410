"""The port's engine invariant analyzer (``repro_torch.analysis``) on the CPU.

* Validator parity: plans of every strategy x ``kv_buckets`` in {1, 2, 3},
  built by the reference and by the port from the same seeded masks, are
  valid under both validators (each plan under each validator); on
  hand-mutated plans the port's findings equal the reference's
  ``check_plan`` findings string for string; stacked axes are tolerated;
  an int16 field ``widen()`` leaves is flagged; the mesh block (``shd_*``)
  gives the reference's findings on the reference's mesh plan, moved into
  the port's DispatchPlan.
* The ``validate_plans`` hook: once per build under the flag and under
  ``REPRO_VALIDATE_PLANS=1``, raising on a corrupted plan, never when off.
* The op walk and the passes: kernel regions with their plain ops nested,
  an injected sort (also inside a region) and the uint8 unpack flagged, a
  missing region flagged as vacuous; DispatchPurity per strategy x backend;
  PromotionCheck green, its promotion fixture flagged.
* The cost model: matmul FLOPs exact against 2·M·N·K, ``FlopCounterMode``
  and the reference's ``cost_of_jaxpr``; gathers bill touched bytes; the
  peak sees liveness; ``kernel_cost`` against hand-reckoned numbers.
* The cost passes, the source lint and the CLI (exit codes, pass globs, the
  default device).

The bucketed plain versions order their layouts by a counting sort (no sort
op, as the kernels): held here to a stable ``argsort``.  Card-only cases are
in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.cost_model import cost_of_jaxpr
from repro.analysis.plan_check import check_plan as ref_check_plan
from repro.core import engine as JE
from repro.core import masks as JM
from repro.core import plan as JP
from repro_torch.analysis import AnalysisContext, Finding, run_analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import cost_passes as CP
from repro_torch.analysis import passes as PS
from repro_torch.analysis import plan_check
from repro_torch.analysis.cost_model import (cost_of_record, kernel_cost, peak_bytes_of,
                                             plan_counts)
from repro_torch.analysis.op_walk import (collective_counts, eqn_count, find_ops,
                                          index_decode_ops, kernel_regions, primitive_counts,
                                          record_call)
from repro_torch.analysis.plan_check import PlanInvariantError, check_plan
from repro_torch.analysis.source_lint import lint_source, lint_sources
from repro_torch.core import engine as TE
from repro_torch.core import masks as TM
from repro_torch.core import plan as TP
from repro_torch.core.strategy import StrategyContext, available_strategies, get_strategy
from repro_torch.kernels import ref as KR

ROOT = Path(__file__).resolve().parents[1]
MASK = dict(tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.0, block_q=16,
            block_kv=16, pool=32, warmup_steps=1)
_j_build_plan = jax.jit(JP.build_dispatch_plan, static_argnums=(2, 3))


def _cfgs(**kw):
    base = dict(cap_q_frac=0.75, cap_kv_frac=0.9)
    base.update(kw)
    return (JE.EngineConfig(mask=JM.MaskConfig(**MASK), cache_dtype=jnp.float32, **base),
            TE.EngineConfig(mask=TM.MaskConfig(**MASK), cache_dtype=torch.float32, **base))


def _ctx():
    return AnalysisContext(src_root=str(ROOT / "src"), device="cpu")


def _port_plan(leaves: dict) -> TP.DispatchPlan:
    return TP.DispatchPlan(**{f: None if leaves.get(f) is None
                              else torch.from_numpy(np.array(leaves[f]))
                              for f in TP.DispatchPlan._fields})


def _ref_plan(leaves: dict) -> JP.DispatchPlan:
    return JP.DispatchPlan(**{f: None if leaves.get(f) is None else np.array(leaves[f])
                              for f in JP.DispatchPlan._fields})


def _leaves(plan) -> dict:
    return {f: None if v is None else np.array(v) for f, v in zip(plan._fields, plan)}


# ---------------------------------------------------------------------------
# Plan validator parity
# ---------------------------------------------------------------------------

def _strategy_masks(strategy, n=128, b=1, h=2, seed=0):
    """The port strategy's post-clamp masks and row score on seeded Q/K (the
    reference's emission matches them: tests/test_torch_strategy_schedule.py)."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((b, h, n, 32)).astype(np.float32))
            for _ in range(2))
    syms = get_strategy(strategy).emit(q, k, StrategyContext(cfg=tcfg, n_text=32, n_tokens=n))
    row_score = torch.where(syms.m_c, syms.q_scores, 0.0).sum(dim=-2)
    return syms.m_c.numpy(), syms.m_s.numpy(), row_score.numpy()


@pytest.mark.parametrize("kv_buckets", [1, 2, 3])
@pytest.mark.parametrize("strategy", list(available_strategies()))
def test_real_plans_valid_under_both_validators(strategy, kv_buckets):
    n = 128
    jcfg, tcfg = _cfgs(kv_buckets=kv_buckets)
    m_c, m_s, rs = _strategy_masks(strategy, n)
    ref = _j_build_plan(jnp.asarray(m_c), jnp.asarray(m_s), jcfg, n, row_score=jnp.asarray(rs))
    port = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, n,
                                  row_score=torch.from_numpy(rs))
    ref_np, port_np = _leaves(ref), _leaves(port)
    assert ref_check_plan(_ref_plan(ref_np), jcfg, n) == []
    assert ref_check_plan(_ref_plan(port_np), jcfg, n) == []
    assert check_plan(port, tcfg, n) == []
    assert check_plan(_port_plan(ref_np), tcfg, n) == []


def _mutable_base():
    """A bucketed plan (kv_buckets 3) with padding row slots, dead layout
    rows and live rows, as NumPy leaves, with the two configs."""
    n, h = 256, 3
    jcfg, tcfg = _cfgs(kv_buckets=3)
    rng = np.random.default_rng(11)
    t = tcfg.mask.n_blocks(n)
    m_c = rng.random((2, h, t)) < 0.45
    m_c[1, :, :3] = False                              # rows cached in every head
    m_s = rng.random((2, h, t, t)) < 0.5
    plan = TP.build_dispatch_plan(torch.from_numpy(m_c), torch.from_numpy(m_s), tcfg, n,
                                  row_score=torch.from_numpy(rng.random((2, t))
                                                             .astype(np.float32)))
    return _leaves(plan), jcfg, tcfg, n


def _mutate(name, p, n):
    t_q, t_kv = n // 16, n // 16
    if name == "id past T":
        p["kv_row_ids"][0, 0, 0, 0] = t_kv + 5
    elif name == "count past capacity":
        p["kv_row_cnt"][0, 0, 0] = p["kv_row_ids"].shape[-1] + 1
    elif name == "head_cnt != mask sum":
        b, s = np.argwhere((p["head_cnt"] > 0) & (p["head_cnt"] < p["head_mask"].shape[-1]))[0]
        p["head_cnt"][b, s] += 1
    elif name == "padding slot with heads":
        b = int(np.argmin(p["row_cnt"]))
        slot = int(p["row_cnt"][b])
        assert slot < p["row_ids"].shape[-1], "the base plan has a padding row slot"
        p["head_mask"][b, slot, 0] = True
        p["head_cnt"][b, slot] = 1
    elif name == "occ_hist mismatch":
        p["occ_hist"][0, 0] += 1
    elif name == "bkt_kv_cnt past width":
        p["bkt_kv_cnt"] += 7
    elif name == "dead bkt row with live KV":
        b, r = np.argwhere(p["bkt_q_ids"] == t_q)[0]
        p["bkt_kv_cnt"][b, r] = 1
    elif name == "gmo_head_cnt past width":
        p["gmo_head_cnt"][:, -1] = p["head_mask"].shape[-1] + 1
    elif name == "q_ids not ascending":
        b, hh = np.argwhere(p["q_cnt"] >= 2)[0]
        p["q_ids"][b, hh, [0, 1]] = p["q_ids"][b, hh, [1, 0]]
    elif name == "bkt_kv_ids diverge":
        b, r = np.argwhere((p["bkt_q_ids"] < t_q) & (p["bkt_kv_cnt"] > 0))[0]
        off = int(TP.bucket_row_offsets(TP.bucket_geometry(
            p["q_ids"].shape[-1], p["kv_row_ids"].shape[-1], p["q_ids"].shape[1], 3))[r])
        p["bkt_kv_ids"][b, off] = (p["bkt_kv_ids"][b, off] + 1) % t_kv
    elif name == "gmo_head_ids diverge":
        b, r = np.argwhere((p["gmo_rows"] < n // 32) & (p["gmo_head_cnt"] > 0))[0]
        off = int(TP.bucket_row_offsets(TP.bucket_geometry(
            p["row_ids"].shape[-1], p["head_mask"].shape[-1], 1, 3))[r])
        p["gmo_head_ids"][b, off] = (p["gmo_head_ids"][b, off] + 1) % p["head_mask"].shape[-1]
    elif name == "int16 field left by widen":
        p["q_cnt"] = p["q_cnt"].astype(np.int16)
    else:
        raise KeyError(name)


MUTATIONS = ["id past T", "count past capacity", "head_cnt != mask sum",
             "padding slot with heads", "occ_hist mismatch", "bkt_kv_cnt past width",
             "dead bkt row with live KV", "gmo_head_cnt past width", "q_ids not ascending",
             "bkt_kv_ids diverge", "gmo_head_ids diverge", "int16 field left by widen"]


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_plan_findings_equal_reference(mutation):
    leaves, jcfg, tcfg, n = _mutable_base()
    assert check_plan(_port_plan(leaves), tcfg, n) == []
    _mutate(mutation, leaves, n)
    want = ref_check_plan(_ref_plan(leaves), jcfg, n)
    got = check_plan(_port_plan(leaves), tcfg, n)
    assert want, mutation
    assert got == want


def test_validate_plan_raises_with_every_finding():
    leaves, _, tcfg, n = _mutable_base()
    _mutate("bkt_kv_cnt past width", leaves, n)
    with pytest.raises(PlanInvariantError, match="bucket width"):
        plan_check.validate_plan(_port_plan(leaves), tcfg, n)


def test_stacked_axes_are_tolerated():
    leaves, _, tcfg, n = _mutable_base()
    stacked = {f: None if v is None else np.broadcast_to(v, (2, 3, *v.shape))
               for f, v in leaves.items()}
    assert check_plan(_port_plan(stacked), tcfg, n) == []
    _mutate("occ_hist mismatch", leaves, n)
    bad = {f: None if v is None else np.stack([np.array(v)] * 2) for f, v in leaves.items()}
    assert check_plan(_port_plan(bad), tcfg, n) == [
        "occ_hist inconsistent with the truncation-folded kv_row_cnt/q_cnt (histogram "
        "computed before a later clamp?)"]


def test_int16_field_left_by_widen_is_flagged_on_a_torch_plan():
    leaves, _, tcfg, n = _mutable_base()
    plan = _port_plan(leaves)
    assert plan.kv_row_ids.dtype == torch.int16           # compact ids widen fine
    bad = check_plan(plan._replace(head_cnt=plan.head_cnt.to(torch.int16)), tcfg, n)
    assert bad == ["widen(): field 'head_cnt' stayed int16 — add it to "
                   "DispatchPlan.widen()'s _replace call"]


@pytest.mark.parametrize("mutate", [False, True])
def test_mesh_block_matches_reference(mutate):
    jcfg, tcfg = _cfgs(kv_buckets=1)
    jcfg = dataclasses.replace(jcfg, mesh_dp=1, mesh_sp=2)
    n, b, h, dm, dh = 128, 1, 2, 32, 16
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    p = JE.AttnParams(*(jax.random.normal(k, s) * 0.05 for k, s in
                        zip(ks, [(dm, h * dh)] * 3 + [(h * dh, dm)])),
                      q_scale=jnp.ones(dh), k_scale=jnp.ones(dh))
    x = jax.random.normal(jax.random.PRNGKey(2), (b, n, dm)) * 0.3
    st0 = JE.init_layer_state(b, h, n, dm, dh, jcfg)
    _, st = JE.update_layer(p, x, st0, jcfg, n_text=32, heads=h, step_idx=2, num_steps=8)
    leaves = _leaves(st.plan)
    assert leaves["shd_q_ids"] is not None
    if mutate:
        leaves["shd_send_cnt"] = leaves["shd_send_cnt"] + 1000
        leaves["shd_gather_idx"] = leaves["shd_gather_idx"] - 1000
    mesh_cfg = types.SimpleNamespace(mask=tcfg.mask, caps=tcfg.caps, mesh_sp=2,
                                     mesh_pair_slack=1.5)
    plan = TP.DispatchPlan(**{f: None if leaves.get(f) is None else torch.from_numpy(leaves[f])
                              for f in TP.DispatchPlan._fields})
    want = ref_check_plan(_ref_plan(leaves), jcfg, n)
    assert (want != []) == mutate
    assert check_plan(plan, mesh_cfg, n) == want


# ---------------------------------------------------------------------------
# The validate_plans hook
# ---------------------------------------------------------------------------

def _update(cfg, seed=5):
    state = TE.init_layer_state(PS._B, PS._H, PS._N, PS._DM, PS._DH, cfg, "cpu")
    before = plan_check.hook_validate.calls
    _, st = TE.update_layer(PS._params("cpu"), PS._x("cpu", seed=seed), state, cfg,
                            n_text=32, heads=PS._H, step_idx=2, num_steps=8)
    return st, plan_check.hook_validate.calls - before


@pytest.mark.parametrize("how", ["flag", "env"])
def test_hook_fires_once_per_build(monkeypatch, how):
    monkeypatch.delenv("REPRO_VALIDATE_PLANS", raising=False)
    cfg = PS._engine_cfg(kv_buckets=3)
    if how == "flag":
        cfg = dataclasses.replace(cfg, validate_plans=True)
    else:
        monkeypatch.setenv("REPRO_VALIDATE_PLANS", "1")
    assert plan_check.validation_enabled(cfg)
    _, calls = _update(cfg)
    assert calls == 1


def test_hook_raises_on_a_corrupted_plan(monkeypatch):
    monkeypatch.delenv("REPRO_VALIDATE_PLANS", raising=False)
    cfg = dataclasses.replace(PS._engine_cfg(kv_buckets=3), validate_plans=True)
    real = TP.occupancy_histogram
    monkeypatch.setattr(TP, "occupancy_histogram", lambda *a: real(*a) + 1)
    with pytest.raises(PlanInvariantError, match="occ_hist"):
        _update(cfg)


def test_hook_never_runs_when_off(monkeypatch):
    monkeypatch.delenv("REPRO_VALIDATE_PLANS", raising=False)

    def boom(*a):
        raise AssertionError("the validator ran with validation off")

    boom.calls = 0
    monkeypatch.setattr(plan_check, "hook_validate", boom)
    cfg = PS._engine_cfg(kv_buckets=3)
    for value in ("0", ""):
        monkeypatch.setenv("REPRO_VALIDATE_PLANS", value)
        assert not plan_check.validation_enabled(cfg)
        _update(cfg)


# ---------------------------------------------------------------------------
# The op walk and the op-stream passes
# ---------------------------------------------------------------------------

def test_walker_records_kernel_regions_with_their_plain_ops():
    _, disp = PS.trace_pair(PS._engine_cfg(kv_buckets=1), PS._N, "cpu")
    assert kernel_regions(disp) == ["gemm_q_sparse_kernel", "flashomni_attention_csr",
                                    "gemm_o_sparse_kernel"]
    inner = {n.path for n in disp.nodes if n.path}
    assert inner == {(name,) for name in kernel_regions(disp)}
    assert eqn_count(disp, recursive=True) > eqn_count(disp)
    counts = primitive_counts(disp)
    assert counts["gemm_q_sparse_kernel"] == 1 and counts["aten.mm"] >= 2
    assert [p for p, _ in find_ops(disp, ["gemm_o_sparse_kernel"])] == [()]
    assert collective_counts(disp) == {}


@pytest.mark.parametrize("inside_region", [False, True])
def test_injected_sort_is_flagged(monkeypatch, inside_region):
    if not inside_region:
        _, rec = record_call(lambda x, ids: x[torch.sort(ids).values], torch.ones(8, 4),
                             torch.arange(8))
        assert [(p, n.overload) for p, n in index_decode_ops(rec)] == [((), "aten.sort.default")]
        return
    from repro_torch.kernels import gemm_q as GQ
    real = GQ.gemm_q_ref

    def sorting_ref(x, w, row_ids, row_cnt, *, block):
        return real(x, w, torch.sort(row_ids, dim=-1).values, row_cnt, block=block)

    monkeypatch.setattr(GQ, "gemm_q_ref", sorting_ref)
    cfg = PS._engine_cfg(kv_buckets=1, strategy="cache-all")   # a config no test records
    PS.trace_pair.cache_clear()
    try:
        found = PS.DispatchPurity().check("injected", cfg, "cpu")
    finally:
        PS.trace_pair.cache_clear()
    assert [f.rule for f in found] == ["no-index-decode-in-dispatch"]
    assert "aten.sort.default at gemm_q_sparse_kernel" in found[0].message


def test_uint8_unpack_signature_is_flagged():
    from repro_torch.core.symbols import decode_spatial, pack_bits, unpack_bits
    sym = pack_bits(torch.rand(2, 20) < 0.5)
    for fn, args in ((unpack_bits, (sym, 20)), (decode_spatial, (sym, torch.arange(5)))):
        _, rec = record_call(fn, *args)
        assert any(n.name == "aten.__rshift__" for _, n in index_decode_ops(rec))
    # a shift of an int32 tensor that never held the symbols is not a decode
    _, rec = record_call(lambda a: (a >> 1) & 1, torch.arange(8, dtype=torch.int32))
    assert index_decode_ops(rec) == []


def test_missing_kernel_region_is_vacuous(monkeypatch):
    from repro_torch.core import backend
    monkeypatch.setattr(backend, "gemm_o_sparse_kernel",
                        backend.gemm_o_sparse_kernel.__wrapped__)
    cfg = dataclasses.replace(PS._engine_cfg(kv_buckets=1, strategy="skip-only"),
                              cap_kv_frac=0.8)            # a config no other test records
    PS.trace_pair.cache_clear()
    try:
        found = PS.DispatchPurity().check("unwrapped", cfg, "cpu")
    finally:
        PS.trace_pair.cache_clear()
    assert [f.rule for f in found] == ["walker-vacuous"]
    assert "gemm_o_sparse_kernel missing" in found[0].message


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("strategy", list(available_strategies()))
def test_dispatch_purity(strategy, backend):
    dp = PS.DispatchPurity()
    for kvb in (1, 3):
        cfg = PS._engine_cfg(strategy=strategy, backend=backend, kv_buckets=kvb)
        assert dp.check(f"{strategy}/{backend}/{kvb}", cfg, "cpu") == []


def test_promotion_check_green_and_its_fixture_flagged():
    assert PS.PromotionCheck().run(_ctx()) == []
    x = [torch.ones(1, 4, dtype=torch.bfloat16)]
    st = [[torch.ones(2, dtype=torch.bfloat16), torch.zeros(2, dtype=torch.int16)]]
    promoted = [x[0] * torch.ones(1)]                  # a stray f32 tensor promotes
    st_out = [[st[0][0].float(), st[0][1]]]
    found = PS.promotion_findings("promotion-check", "fixture", x, st, promoted, st_out)
    assert [f.rule for f in found] == ["latent-promotion", "state-promotion"]


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

GEMMS = {
    "mm": (lambda a, b: a @ b, [(24, 40), (40, 16)]),
    "bmm": (lambda a, b: torch.bmm(a, b), [(3, 24, 40), (3, 40, 16)]),
    "addmm": (lambda a, b: torch.addmm(torch.ones(16), a, b), [(24, 40), (40, 16)]),
    "linear": (lambda a, b: torch.nn.functional.linear(a, b.t()), [(24, 40), (40, 16)]),
    "einsum": (lambda a, b: torch.einsum("bnhd,hdf->bnf", a, b), [(2, 12, 3, 8), (3, 8, 20)]),
}


@pytest.mark.parametrize("case", list(GEMMS))
def test_gemm_flops_exact_against_flop_counter(case):
    fn, shapes = GEMMS[case]
    ins = [torch.randn(s) for s in shapes]
    with FlopCounterMode(display=False) as fc:
        fn(*ins)
    got = cost_of_record(record_call(fn, *ins)[1]).flops
    assert got == fc.get_total_flops()
    if case in ("mm", "addmm", "linear"):
        assert got == 2 * 24 * 40 * 16


REF_CASES = {
    "dense gemm": ("nk,kf->nf", [(96, 64), (64, 48)]),
    "attention scores": ("bhqd,bhkd->bhqk", [(1, 2, 64, 32), (1, 2, 80, 32)]),
    "attention values": ("bhqk,bhkd->bhqd", [(1, 2, 64, 80), (1, 2, 80, 32)]),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_flops_equal_reference_cost_of_jaxpr(case):
    eq, shapes = REF_CASES[case]
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = cost_of_jaxpr(jax.make_jaxpr(lambda a, b: jnp.einsum(eq, a, b))(*arrs)).flops
    got = cost_of_record(record_call(torch.einsum, eq,
                                     *[torch.from_numpy(a) for a in arrs])[1]).flops
    assert got == want


def test_gather_bills_touched_bytes_not_the_operand():
    kv = torch.randn(4096, 64)
    idx = torch.tensor([3, 17, 400, 4000])
    for fn in (lambda t, i: t[i], lambda t, i: torch.index_select(t, 0, i),
               lambda t, i: torch.gather(t, 0, i[:, None].expand(4, 64))):
        c = cost_of_record(record_call(fn, kv, idx)[1])
        assert c.flops == 0
        assert 2 * 4 * 64 * 4 <= c.hbm_bytes <= 2 * 4 * 64 * 4 + 4 * 64 * 8
        assert c.hbm_bytes < kv.numel() * 4 / 100


def test_scatter_and_sort_rules():
    base, idx, vals = torch.zeros(1000), torch.tensor([1, 5, 9]), torch.ones(3)
    c = cost_of_record(record_call(lambda b, i, v: b.index_put((i,), v), base, idx, vals)[1])
    assert (c.flops, c.hbm_bytes) == (3, 2 * 3 * 4 + 3 * 8)
    c = cost_of_record(record_call(lambda s: torch.sort(s, dim=-1, stable=True),
                                   torch.randn(4, 8))[1])
    assert c.flops == 4 * 8 * 3                       # 4 lanes of 8: n log2 n each


def test_views_and_in_place_ops_are_not_double_billed():
    x = torch.randn(64, 32)
    view = cost_of_record(record_call(lambda t: t.t().reshape(32, 64)[:, :8], x)[1])
    assert (view.flops, view.hbm_bytes) == (0, 0)
    out = cost_of_record(record_call(lambda t: t + 1, x)[1])
    inplace = cost_of_record(record_call(lambda t: t.clone().add_(1), x)[1])
    clone = cost_of_record(record_call(lambda t: t.clone(), x)[1])
    assert inplace.flops == out.flops == x.numel()
    assert inplace.hbm_bytes - clone.hbm_bytes == out.hbm_bytes


def test_peak_sees_liveness_not_total_allocation():
    def chain(x):
        for _ in range(20):
            x = x * 2
        return x

    x = torch.randn(1000)
    rec = record_call(chain, x)[1]
    total = sum(n.outputs[0].nbytes for n in rec.nodes)
    assert total == 20 * 4000
    assert peak_bytes_of(rec) == 4000 + 2 * 4000      # the input + two live temporaries

    def fan(x):
        parts = [x * i for i in range(5)]              # five live at once
        return sum(parts)

    assert peak_bytes_of(record_call(fan, x)[1]) >= 4000 + 5 * 4000
    # a view shares its base's bytes
    assert peak_bytes_of(record_call(lambda t: (t * 2).view(10, 100).t(), x)[1]) == 8000


KERNEL_CASES = {
    "gemm_q_sparse_kernel": (dict(b=1, cr=2, block=4, k=8, f=16, live_rows=1), "float32",
                             1024, 1164),
    "flashomni_attention_csr": (dict(bh=2, n=64, dh=32, block_q=16, block_kv=16,
                                     live_slots=3, kv_live_blocks=5, kv_union_blocks=4),
                                "float32", 163840, 55352),
    "flashomni_attention_csr_bucketed": (dict(bh=2, n=64, dh=32, block_q=16, block_kv=16,
                                              live_slots=3, kv_live_blocks=5,
                                              kv_union_blocks=4, layout_rows=6),
                                         "float32", 163840, 55364),
    "gemm_o_sparse_kernel": (dict(b=1, n=64, f=48, dh=32, h=2, cr=2, block=32, live_heads=3,
                                  heads_used=2), "bfloat16", 294912, 24608),
    "gemm_o_sparse_bucketed_kernel": (dict(b=1, n=64, f=48, dh=32, h=2, cr=2, block=32,
                                           live_heads=3, heads_used=2), "bfloat16",
                                      294912, 24608),
    "flashomni_attention_symbols": (dict(bh=2, n=64, dh=32, block_q=16, block_kv=16,
                                         live_rows=5, live_pairs=7, kv_union_blocks=6,
                                         symbol_bytes=10), "float32", 229376, 57354),
    "taylor_reuse_kernel": (dict(orders=2, bh=2, n=64, dh=32, block=16, cached=3), "float32",
                            6144, 38940),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_cost_matches_hand_reckoning(name):
    counts, dtype, flops, nbytes = KERNEL_CASES[name]
    c = kernel_cost(name, counts, dtype)
    assert (c.flops, c.hbm_bytes) == (flops, nbytes)
    assert kernel_cost(name, counts, getattr(torch, dtype)).hbm_bytes == nbytes


def test_kernel_regions_bill_capacity_and_plan_counts_bill_live():
    cfg = PS._engine_cfg(kv_buckets=1)
    _, disp = PS.trace_pair(cfg, PS._N, "cpu")
    node = next(n for n in disp.nodes if n.name == "flashomni_attention_csr")
    bh, cq, ckv = node.args["kv_ids"].shape
    want = kernel_cost("flashomni_attention_csr", dict(
        bh=bh, n=PS._N, dh=PS._DH, block_q=16, block_kv=16, live_slots=bh * cq,
        kv_live_blocks=bh * cq * ckv, kv_union_blocks=bh * cq * ckv), torch.float32)
    from repro_torch.analysis.cost_model import op_cost
    assert op_cost(node) == want
    plan = _validator_plan(cfg)
    live = plan_counts(plan.widen(), cfg, PS._B, PS._H, PS._N)
    q_live = torch.arange(cq) < plan.q_cnt.reshape(-1, 1)
    assert live["live_slots"] == int(q_live.sum()) <= bh * cq
    assert live["kv_live_blocks"] == int(plan.kv_row_cnt.reshape(bh, cq)[q_live].sum())
    assert live["live_rows"] == int(plan.row_cnt.sum())
    assert live["live_heads"] == int(plan.head_mask.sum())
    assert live["kv_union_blocks"] <= live["kv_live_blocks"]


def _validator_plan(cfg):
    from repro_torch.analysis import PlanValidator
    return PlanValidator.plan(cfg, "cpu")


# ---------------------------------------------------------------------------
# Cost passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", CP.COST_PASSES, ids=lambda c: c.name)
def test_cost_passes_green_on_the_real_engine(cls):
    ctx = _ctx()
    assert cls().run(ctx) == []
    if cls is CP.DispatchCostScaling:
        assert sum("token slope" in n for n in ctx.notes) == 4


@pytest.mark.parametrize("fixture", ["dense-einsum-dispatch", "rebuild-every-dispatch",
                                     "memory-hog"])
def test_cost_fixtures_are_flagged(fixture):
    found = cli._fixture_findings(fixture, "cpu")
    assert found and all(isinstance(f, Finding) and f.pass_name.startswith("cost-")
                         for f in found)


# ---------------------------------------------------------------------------
# Source lint
# ---------------------------------------------------------------------------

def test_source_lint_green_on_the_port():
    assert lint_sources(ROOT / "src") == []


def test_id_keyed_cache_is_flagged_and_a_transient_id_dict_is_not():
    hits = lint_source("_PLAN_CACHE = {}\n"
                       "def lookup(spec):\n"
                       "    key = id(spec)\n"
                       "    if key not in _PLAN_CACHE:\n"
                       "        _PLAN_CACHE[key] = build(spec)\n"
                       "    return _PLAN_CACHE[key]\n")
    assert {rule for _, _, rule, _ in hits} == {"module-dict-cache", "id-keyed-cache"}
    assert lint_source("def group(reqs):\n"
                       "    by_id = {id(r): r for r in reqs}\n"
                       "    return [by_id[id(r)] for r in reqs]\n") == []


def test_plan_field_coverage_lints(tmp_path):
    src = (ROOT / "src" / "repro_torch" / "core" / "plan.py").read_text()
    src = src.replace("    occ_hist: torch.Tensor    # (B, OCC_BINS) int32\n",
                      "    occ_hist: torch.Tensor    # (B, OCC_BINS) int32\n"
                      "    foo_ids: Optional[torch.Tensor] = None\n")
    (tmp_path / "repro_torch" / "core").mkdir(parents=True)
    (tmp_path / "repro_torch" / "core" / "plan.py").write_text(src)
    rules = sorted(rule for _, _, rule, msg in lint_sources(tmp_path) if "'foo_ids'" in msg)
    assert rules == ["plan-rebuild-coverage", "plan-widen-coverage"]


def test_plan_spec_coverage_lint(tmp_path):
    """A plan field with no logical spec in ``dit.engine_state_specs``."""
    pkg = ROOT / "src" / "repro_torch"
    src = (pkg / "core" / "plan.py").read_text()
    src = src.replace("    occ_hist: torch.Tensor    # (B, OCC_BINS) int32\n",
                      "    occ_hist: torch.Tensor    # (B, OCC_BINS) int32\n"
                      "    foo_cnt: Optional[torch.Tensor] = None\n")
    dit_src = (pkg / "models" / "dit.py").read_text()
    for sub, text in (("core/plan.py", src), ("models/dit.py", dit_src)):
        (tmp_path / "repro_torch" / sub).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "repro_torch" / sub).write_text(text)
    rules = sorted(rule for _, _, rule, msg in lint_sources(tmp_path) if "'foo_cnt'" in msg)
    assert rules == ["plan-rebuild-coverage", "plan-spec-coverage"]
    (tmp_path / "repro_torch" / "models" / "dit.py").write_text("def other():\n    pass\n")
    assert ("plan-spec-coverage", "engine_state_specs not found") in {
        (rule, msg) for _, _, rule, msg in lint_sources(tmp_path)}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_green_on_cpu(capsys):
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "invariant analysis: 0 finding(s) across 10 pass(es)" in out
    assert "note: executable-budget: N/A" in out


@pytest.mark.parametrize("fixture", cli.FIXTURES)
def test_cli_fixture_exits_1(fixture, capsys):
    assert cli.main(["--device", "cpu", "--fixture", fixture, "-q"]) == 1
    assert f"fixture {fixture}:" in capsys.readouterr().out


def test_cli_pass_globs(capsys):
    assert cli.main(["--device", "cpu", "--passes", "cost-*", "-q"]) == 0
    assert "across 4 pass(es)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="match no pass"):
        cli.main(["--device", "cpu", "--passes", "no-such-*"])
    # The mesh fixture needs the two-rank world: in one process it exits
    # with the reason (tests/test_torch_mesh.py runs it in the world).
    with pytest.raises(SystemExit, match="world of 2 ranks"):
        cli.main(["--device", "cpu", "--fixture", "mesh-allgather"])


def test_cli_defaults_to_the_card_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--passes", "source-lint"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_analysis(passes=[], verbose=False)


def test_module_entry_point_runs():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
                          "--passes", "source-lint,plan-validator"],
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
                              "HOME": str(ROOT)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) across 2 pass(es)" in out.stdout


# ---------------------------------------------------------------------------
# The plain versions' counting sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_layout_order_equals_a_stable_argsort(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    b, groups, per, hi = 3, 4, 6, 9
    key = torch.full((b, groups * per), hi)
    group = torch.arange(groups).repeat_interleave(per).expand(b, -1)
    for bi in range(b):
        for gi in range(groups):
            n_live = int(torch.randint(0, per + 1, (1,), generator=g))
            key[bi, gi * per:gi * per + n_live] = torch.randperm(hi, generator=g)[:n_live]
    perm = torch.stack([torch.randperm(groups * per, generator=g) for _ in range(b)])
    key, group = torch.gather(key, 1, perm), torch.gather(group, 1, perm)
    want = torch.argsort(group * (hi + 1) + key, dim=-1, stable=True)
    assert torch.equal(KR._layout_order(key, group, groups, hi), want)
