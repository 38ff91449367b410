"""CPU tests of the port's benchmark at smoke size: the harness finds what
later changes add as files, the import check, the work counts, the plain
reference against the port, the control and the faults the check must
catch.  Run: ``python -m pytest omnibench/tests -q`` from the repository's
root (≈ 1 min)."""

import json
import sys

import pytest
import torch

from omnibench import check, harness, trace, work
from omnibench.reference import Reference, fp8_round
from omnibench.tests.smoke_cells import BENCH, TRAFFIC, make_root, smoke_config

CELLS = ("flux-smoke", "hunyuan-smoke")


def cell_limit(cell: str) -> float:
    """The limit of the full-size cell whose rules the smoke cell follows."""
    full = {"flux-smoke": "flux-t2i-1024", "hunyuan-smoke": "hunyuan-t2v-33k"}[cell]
    return json.loads((BENCH / "limits" / f"{full}.json").read_text())["latent_rel_l2"]["limit"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def test_a_config_cell_and_metric_added_as_files_are_found(tmp_path):
    root = make_root(tmp_path)
    folder = root / BENCH.name
    cfg = smoke_config("flux-mmdit")
    cfg["n_layers"] = 2
    (folder / "configs" / "extra.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "extra-mix.json").write_text(json.dumps(dict(TRAFFIC, steps=6,
                                                                       n_vision=64)))
    (folder / "metrics" / "extra_count.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    (folder / "limits" / "extra-cell.json").write_text(
        json.dumps({"latent_rel_l2": {"limit": 1.0}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "extra", "source": "https://example.org",
                            "file": f"{BENCH.name}/configs/extra.json", "reduced": [],
                            "why": "new"})
    spec["workloads"].append({"name": "extra-cell", "config": "extra", "traffic": "extra-mix",
                              "chips": 1, "why": "new"})
    spec["per_layer"].append({"name": "extra_count", "unit": "steps", "better": "higher",
                              "source": "program_span", "layer": "x", "moves": "gen_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(root, "extra-cell", 5, 3.0, True, device="cpu")
    assert out["metrics"]["extra_count"]["value"] == out["attempted"] > 0
    assert out["metrics"]["update_step_s"]["unit"] == "s"
    assert out["correct"]
    e2e = harness.run_cell(root, "extra-cell", 5, 0.5, False, device="cpu")
    assert set(e2e["metrics"]) == {"gen_s", "peak_gb", "setup_s"}
    assert list(e2e)[-1] == "checks"


def test_the_import_check_names_jax_and_the_jax_package_only(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla", "flax", "repro.core.engine", "benchmarks.run"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == ["benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_work_counts_match_hand_counts_at_a_small_plan():
    from repro_torch.core.backend import KernelBackend
    from repro_torch.core.plan import build_dispatch_plan
    from repro_torch.kernels._region import listening
    cfg = smoke_config("flux-mmdit")
    _, ecfg = harness.program_configs(cfg)
    b, h, n, dh, d = 1, 2, 128, 32, 64          # 4 pool rows of 32, 8 q blocks of 16
    m_c = torch.tensor([[[1, 1, 0, 0], [1, 0, 1, 0]]], dtype=torch.bool)
    m_s = torch.zeros((1, 2, 4, 4), dtype=torch.bool)
    m_s[0, 0, 0, :2] = m_s[0, 0, 1, :] = m_s[0, 1, 0, 0] = m_s[0, 1, 2, 1:3] = True
    plan = build_dispatch_plan(m_c, m_s, ecfg, n, row_score=torch.tensor([[4., 3., 2., 1.]]))
    be, calls = KernelBackend(), trace.KernelCalls()
    x, w = torch.randn(b, n, d), torch.randn(d, h * dh)
    with listening(calls):
        q = be.gemm_q(x, w, plan, block=32).reshape(b, -1, h, dh).transpose(1, 2)
        k = v = torch.randn(b, h, n, dh)
        o = be.attention(q, k, v, torch.zeros(b, h, n, dh), plan, ecfg.caps(n), compact_q=True)
        be.gemm_o(o.transpose(1, 2), torch.randn(h, dh, d), plan, torch.zeros(b, n, d), block=32)
    got = dict(calls.resolved())
    # Rows 0-2 are live in a head (3 = the row capacity); live (row, head)
    # pairs 4, each 2 q blocks; KV blocks: head 0 rows 0, 1 list 2 and 4
    # pool blocks, head 1 rows 0, 2 list 1 and 2, each 2 KV blocks a pool
    # block, for each of the row's 2 q blocks.
    assert got["gemm_q_sparse_kernel"]["live_rows"] == 3
    assert got["flashomni_attention_csr"]["live_slots"] == 8
    assert got["flashomni_attention_csr"]["kv_live_blocks"] == 2 * 2 * (2 + 4 + 1 + 2)
    assert got["gemm_o_sparse_kernel"]["live_heads"] == 4
    assert got["gemm_o_sparse_kernel"]["rows"] == 3
    flops, nbytes = work.kernel_work("flashomni_attention_csr", got["flashomni_attention_csr"],
                                     "bfloat16")
    assert flops == 4.0 * 36 * 16 * 16 * dh
    # Q of 8 live q blocks, K and V whole, o_reuse of the 8 dead blocks,
    # the output whole (bf16); ids of 36 KV blocks, 8 slots twice, 2 rows.
    assert nbytes == 2 * (128 * dh + 2 * 256 * dh + 128 * dh + 256 * dh) + 4 * (36 + 16 + 2)
    flops_q, _ = work.kernel_work("gemm_q_sparse_kernel", got["gemm_q_sparse_kernel"],
                                  "bfloat16")
    assert flops_q == 2.0 * 3 * 32 * d * h * dh
    flops_o, _ = work.kernel_work("gemm_o_sparse_kernel", got["gemm_o_sparse_kernel"],
                                  "bfloat16")
    assert flops_o == 2.0 * 4 * 32 * dh * d


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port_at_smoke_size(root, cell):
    out = harness.run_cell(root, cell, 123456789012, 1.0, False, device="cpu")
    gap = out["checks"]["latent_rel_l2"]["value"]
    assert gap < cell_limit(cell) / 2, gap
    assert out["correct"]


@pytest.mark.parametrize("name", ["flux-mmdit", "hunyuan-video-dit"])
def test_the_fp8_control_fails_the_limit(name):
    cfg = smoke_config(name)
    cell = {"flux-mmdit": "flux-smoke", "hunyuan-video-dit": "hunyuan-smoke"}[name]
    dev = torch.device("cpu")
    params = harness.make_weights(cfg, 31, dev, torch.bfloat16)
    pe = harness.patch_embed(cfg, 31, dev)
    x0, text = harness.request_inputs(cfg, TRAFFIC, 31, 0, dev)
    control, steps = {}, TRAFFIC["steps"]
    Reference(cfg, params, rnd=fp8_round).run(x0, text, pe, steps, steps,
                                              lambda i, x: control.__setitem__(i, x))
    gap = check.latent_gap(Reference(cfg, params), x0, text, pe, control, steps)
    assert gap > cell_limit(cell), gap


def _stale_update(monkeypatch):
    """Each Update step returns the layer's state unchanged."""
    from repro_torch.core import engine
    plain = engine.update_layer
    monkeypatch.setattr(engine, "update_layer",
                        lambda params, x, state, cfg, **kw: (plain(params, x, state, cfg,
                                                                   **kw)[0], state))


def _altered_answer(monkeypatch):
    """Each step's latents have one token altered where they are produced."""
    from repro_torch.diffusion import pipeline
    plain = pipeline._step_lanes

    def altered(*args, **kw):
        out, states = plain(*args, **kw)
        x = out[0].clone()
        x[:, 0] += 1.0
        return [x], states

    monkeypatch.setattr(pipeline, "_step_lanes", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_stale_update, _altered_answer])
def test_a_broken_step_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    root = make_root(tmp_path, limit=cell_limit(cell))
    fault(monkeypatch)
    out = harness.run_cell(root, cell, 77, 2.0, False, device="cpu")
    assert not out["correct"], out["checks"]
