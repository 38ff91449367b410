"""Port parity: the DiT training path (repro_torch vs the JAX reference on the
same inputs).

Synthetic batches equal bit for bit for every family branch; the
differentiable dense attention's gradients against ``jax.vjp`` at f32 atol
1e-5 (also chunked over heads and rows); ``train_loss`` and every gradient
leaf against ``jax.value_and_grad`` on the reference's weights moved across
with ``params_from_jax`` (rtol 1e-4 / atol 1e-5); AdamW over 3 steps and the
cosine schedule (rtol 1e-5 / atol 1e-7 in f32; bf16 moments within one bf16
ulp); gradient compression (int8 ``q`` and top-k indices exact); the
checkpointer (roundtrip, retention, atomicity, and checkpoints cross-read
with the reference's leaf for leaf); the restartable loop as the
reference's own tests hold it; and ``train`` end to end with an injected
failure against the reference's losses (rtol 1e-4) and against its own
uninterrupted run (bit for bit).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.registry import get_smoke as j_get_smoke
from repro.core import attention as JA
from repro.data import synthetic as JD
from repro.distributed import compression as JC
from repro.launch.train import train as j_train
from repro.models import dit as jdit
from repro.optim import optimizer as JO
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import attention as TA
from repro_torch.data import synthetic as TD
from repro_torch.distributed import compression as TC
from repro_torch.launch import train as TT
from repro_torch.models import dit
from repro_torch.models.registry import get_model, param_count
from repro_torch.optim import optimizer as TO
from repro_torch.runtime.fault_tolerance import (FailureInjector, NodeFailure,
                                                 RestartableLoop, StepWatchdog)
from repro_torch.tree import tree_leaves, tree_map

SMOKE = "flux-mmdit"
# One smoke arch of each family branch of make_batch.
FAMILY_ARCHS = {"dense": "gemma3-1b", "moe": "mixtral-8x22b", "ssm": "mamba2-370m",
                "hybrid": "recurrentgemma-2b", "encdec": "whisper-large-v3",
                "vlm": "llama-3.2-vision-11b", "dit": "flux-mmdit"}


def _port_cfg(jcfg) -> ArchConfig:
    """The port's ArchConfig with the reference config's fields."""
    return ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j_params(seed=0):
    return _np(jdit.init_params(j_get_smoke(SMOKE), jax.random.PRNGKey(seed)))


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_matches_reference_bitwise(family, step):
    jcfg = j_get_smoke(FAMILY_ARCHS[family])
    assert jcfg.family == family
    dcfg = dict(seed=3, batch=2, seq_len=24)
    want = JD.make_batch(jcfg, JD.DataConfig(**dcfg), step)
    got = TD.make_batch(_port_cfg(jcfg), TD.DataConfig(**dcfg), step, device="cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_data_stream_is_make_batch_from_its_start():
    cfg, dcfg = get_smoke(SMOKE), TD.DataConfig(batch=1, seq_len=8)
    stream = TD.data_stream(cfg, dcfg, start_step=4, device="cpu")
    for want_step in (4, 5):
        step, batch = next(stream)
        assert step == want_step
        assert torch.equal(batch["patch_emb"],
                           TD.make_batch(cfg, dcfg, step, device="cpu")["patch_emb"])
    assert TD.DataState(step=7).as_dict() == {"step": 7}


# -- differentiable dense attention -----------------------------------------

@pytest.mark.parametrize("budget", [None, 96])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention_grads_match_reference(monkeypatch, budget, masked):
    """Gradients of the grad branch against ``jax.vjp``; a budget of 96 score
    elements at n = 24 gives chunks of one head and 4 rows."""
    if budget is not None:
        monkeypatch.setattr(TA, "_SCORE_ELEMS", budget)
    rng = np.random.default_rng(11)
    lead, n, d = (2, 3), 24, 16
    q, k, v, cot = (rng.standard_normal((*lead, n, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((*lead, n, n)) < 0.7 if masked else None
    _, vjp = jax.vjp(lambda q, k, v: JA.dense_attention(q, k, v, mask=mask, scale=0.3),
                     q, k, v)
    want = vjp(cot)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TA.dense_attention(tq, tk, tv, scale=0.3,
                             mask=None if mask is None else torch.from_numpy(mask))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("budget", [None, 64])
def test_dense_attention_grad_branch_forward_equals_the_in_place_body(monkeypatch, budget):
    """The grad branch (out of place) and the no-grad body (in place) give
    the same forward within 1e-6 relative; without grad the in-place body
    runs (its output has no autograd history)."""
    if budget is not None:
        monkeypatch.setattr(TA, "_SCORE_ELEMS", budget)
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 4, 16, 8), generator=g) for _ in range(3))
    plain = TA.dense_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert TA.dense_attention(q.requires_grad_(True), k, v).grad_fn is None
    grad = TA.dense_attention(q.requires_grad_(True), k, v)
    assert grad.grad_fn is not None
    rel = float((grad.detach() - plain).norm() / plain.norm())
    assert rel <= 1e-6, rel


# -- the loss ----------------------------------------------------------------

def test_train_loss_and_grads_match_reference():
    jcfg, cfg = j_get_smoke(SMOKE), get_smoke(SMOKE)
    jp = _j_params()
    jbatch = JD.make_batch(jcfg, JD.DataConfig(batch=2, seq_len=32), 1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jdit.train_loss(p, jcfg, b, dtype=jnp.float32)))(jp, jbatch)
    params = params_from_jax(jp)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    batch = TD.make_batch(cfg, TD.DataConfig(batch=2, seq_len=32), 1, device="cpu")
    loss = get_model(cfg).train_loss(params, batch, dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4, atol=1e-5)
    want = jax.tree.leaves(_np(grads_j))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=f"leaf {i}")


def test_model_registry_runs_dit_only():
    model = get_model(get_smoke(SMOKE))
    g = torch.Generator().manual_seed(0)
    params = model.init_params(g, "cpu")
    assert params["blocks"]["wq"].shape[0] == get_smoke(SMOKE).n_layers
    unknown = dataclasses.replace(get_smoke(SMOKE), family="rnn")
    with pytest.raises(KeyError, match="unknown model family 'rnn'"):
        get_model(unknown)


def test_n_params_matches_reference():
    for arch in ("flux-mmdit", "hunyuan-video-dit"):
        from repro.configs.registry import get_config as j_get_config
        assert get_config(arch).n_params() == j_get_config(arch).n_params()
        assert get_smoke(arch).n_params() == j_get_smoke(arch).n_params()


# -- optimizer ----------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": {"a": rng.standard_normal((2, 7)).astype(np.float32),
                       "b": rng.standard_normal((3,)).astype(np.float32)}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_over_three_steps(moment_dtype):
    rng = np.random.default_rng(2)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=moment_dtype)
    jcfg, cfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    p0 = _opt_tree(rng)
    jp, js = p0, JO.adamw_init(p0, jcfg)
    tp = params_from_jax(p0)
    ts = TO.adamw_init(tp, cfg)
    for _ in range(3):
        g = tree_map(lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32), p0)
        jp, js, jn = JO.adamw_update(g, js, jp, jcfg)
        tp, ts, tn = TO.adamw_update(params_from_jax(g), ts, tp, cfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
        for key in ("mu", "nu"):
            for t, j in zip(tree_leaves(ts[key]), jax.tree.leaves(js[key])):
                assert t.dtype == getattr(torch, moment_dtype)
                j = np.asarray(j.astype(jnp.float32))
                if moment_dtype == "float32":
                    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-7)
                else:                                   # one bf16 ulp
                    np.testing.assert_allclose(t.float().numpy(), j, rtol=2 ** -8, atol=0)


def test_cosine_lr_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=4, total_steps=12)
    steps = np.arange(0, 15, dtype=np.int32)
    want = np.asarray(JO.cosine_lr(JO.AdamWConfig(**cfg), jnp.asarray(steps)))
    got = TO.cosine_lr(TO.AdamWConfig(**cfg), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# -- compression ---------------------------------------------------------------

def test_compress_int8_matches_reference():
    rng = np.random.default_rng(4)
    cases = [(rng.standard_normal((5, 9)).astype(np.float32),
              (rng.standard_normal((5, 9)) * 0.01).astype(np.float32)),
             # scale 1: every quotient a half, rounded to even
             (np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32),
              np.zeros(7, np.float32))]
    for g, err in cases:
        (jq, jscale), jerr = JC.compress_int8(jnp.asarray(g), jnp.asarray(err))
        (tq, tscale), terr = TC.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(tscale), float(jscale), rtol=1e-7)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(TC.decompress_int8(TC.Int8Grad(tq, tscale)).numpy(),
                                   np.asarray(JC.decompress_int8(JC.Int8Grad(jq, jscale))),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_compress_topk_ties_keep_the_lower_index(frac):
    """Many equal magnitudes (±1, ±0.5, 0): ``lax.top_k``'s order, lower index
    first among ties, exactly."""
    rng = np.random.default_rng(6)
    g = (rng.integers(-2, 3, size=(8, 10)) * 0.5).astype(np.float32)
    err = np.zeros_like(g)
    jc, jerr = JC.compress_topk(jnp.asarray(g), jnp.asarray(err), frac=frac)
    tc, terr = TC.compress_topk(torch.from_numpy(g), torch.from_numpy(err), frac=frac)
    np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
    assert tc.indices.dtype == torch.int32 and tc.shape == jc.shape
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(TC.decompress_topk(tc).numpy(),
                                  np.asarray(JC.decompress_topk(jc)))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_tree_roundtrip_matches_reference(scheme):
    rng = np.random.default_rng(8)
    grads = _opt_tree(rng)
    err = tree_map(lambda x: (x * 0.01).astype(np.float32), _opt_tree(rng))
    jcomp, jerr = JC.compress_tree(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, err), scheme)
    tcomp, terr = TC.compress_tree(params_from_jax(grads), params_from_jax(err), scheme)
    for t, j in zip(tree_leaves(TC.decompress_tree(tcomp)),
                    jax.tree.leaves(JC.decompress_tree(jcomp))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    for t, j in zip(tree_leaves(terr), jax.tree.leaves(jerr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    zero = TC.init_error_state(params_from_jax(grads))
    assert all(float(z.abs().sum()) == 0 and z.dtype == torch.float32
               for z in tree_leaves(zero))


# -- checkpointer ---------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones((5,))},
            "m": torch.randn(4).to(torch.bfloat16), "s": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(7, tree, blocking=True)
    step, restored = ckpt.restore_latest(tree)
    assert step == 7
    for key in ("a", "m", "s"):
        assert restored[key].dtype == tree[key].dtype and torch.equal(restored[key], tree[key])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == \
        ["float32", "float32", "bfloat16", "int32"]
    kinds = [(h["kind"], h["step"]) for h in ckpt.history]
    assert kinds == [("save", 7), ("restore", 7)]
    assert ckpt.history[0]["bytes"] == 48 + 20 + 8 + 4


def test_checkpoint_retention_and_async(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2)
    tree = {"x": torch.zeros((4,))}
    for s in [1, 2, 3, 4]:
        ckpt.save(s, tree_map(lambda a: a + s, tree))
    ckpt.wait()
    assert ckpt.steps() == [3, 4]
    _, restored = ckpt.restore_latest(tree)
    np.testing.assert_allclose(restored["x"].numpy(), 4.0)


def test_checkpoint_atomicity(tmp_path):
    """A .tmp dir (a crash mid-write) is never visible to readers."""
    ckpt = Checkpointer(tmp_path, keep=3)
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "garbage").write_text("crash")
    assert ckpt.steps() == []
    assert ckpt.restore_latest({"x": torch.zeros(1)}) == (None, None)


def _train_states():
    """The reference's (params, opt_state) after one AdamW step, and the
    port's state of the same structure from other numbers."""
    jp = _j_params()
    jcfg = JO.AdamWConfig()
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.1), jp)
    jp2, js2, _ = JO.adamw_update(grads, JO.adamw_init(jp, jcfg), jp, jcfg)
    tp = params_from_jax(_j_params(seed=1))
    return (_np(jp2), _np(js2)), (tp, TO.adamw_init(tp))


def test_checkpoints_cross_read_with_the_reference(tmp_path):
    jstate, tstate = _train_states()
    JCheckpointer(tmp_path / "ref", keep=2).save(5, jstate, blocking=True)
    step, got = Checkpointer(tmp_path / "ref").restore_latest(tstate)
    assert step == 5
    want = jax.tree.leaves(jstate)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert isinstance(t, torch.Tensor) and t.numpy().dtype == w.dtype
        np.testing.assert_array_equal(t.numpy(), w)

    Checkpointer(tmp_path / "port", keep=2).save(6, tstate, blocking=True)
    step, got = JCheckpointer(tmp_path / "port").restore_latest(jstate)
    assert step == 6
    for j, t in zip(jax.tree.leaves(got), tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    port_manifest = json.loads((tmp_path / "port" / "step_6" / "manifest.json").read_text())
    ref_manifest = json.loads((tmp_path / "ref" / "step_5" / "manifest.json").read_text())
    assert port_manifest["treedef"] == ref_manifest["treedef"]
    assert port_manifest["leaves"] == ref_manifest["leaves"]


# -- restartable loop (as tests/test_fault_tolerance.py holds the reference) -----

def _counter_loop(tmp_path, fail_at=(), total=25, ckpt_every=5):
    ckpt = Checkpointer(tmp_path, keep=3)
    loop = RestartableLoop(ckpt, ckpt_every=ckpt_every)

    def step_fn(state, step):
        return state + step, {"v": float(state.sum())}

    return loop.run(torch.zeros((2,)), step_fn, total, injector=FailureInjector(fail_at))


def test_restart_recovers_exact_state(tmp_path):
    state_fail, res_fail = _counter_loop(tmp_path / "a", fail_at=(12, 18))
    state_ok, res_ok = _counter_loop(tmp_path / "b", fail_at=())
    assert torch.equal(state_fail, state_ok)
    assert res_fail.restarts == 2
    assert res_fail.final_step == res_ok.final_step == 25
    assert [h["step"] for h in res_fail.checkpoints if h["kind"] == "restore"] == [10, 15]


def test_restart_budget_exhausted(tmp_path):
    loop = RestartableLoop(Checkpointer(tmp_path, keep=3), ckpt_every=100, max_restarts=2)

    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step == 3:
                raise NodeFailure("persistent failure")

    with pytest.raises(NodeFailure):
        loop.run(torch.zeros(1), lambda s, i: (s, {}), 10, injector=AlwaysFail())


def test_straggler_detection():
    wd = StepWatchdog(window=16, straggler_factor=3.0)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 0.5) is True
    assert wd.observe(11, 0.12) is False
    assert wd.stragglers and wd.stragglers[0][0] == 10


# -- train end to end -----------------------------------------------------------

TRAIN = dict(steps=6, batch=2, seq_len=64, fail_at=(4,), ckpt_every=2)


@pytest.mark.parametrize("compress", [None, "int8", "topk"])
def test_train_matches_reference_and_restarts_exactly(tmp_path, compress):
    """6 steps of flux-smoke with a failure at step 4: the losses and gradient
    norms against the reference's ``train`` (rtol 1e-4), and the failed run
    equal bit for bit to the uninterrupted one."""
    _, jres = j_train(SMOKE, smoke=True, compress=compress, ckpt_dir=str(tmp_path / "j"),
                      **TRAIN)
    params = params_from_jax(_j_params())
    state, res = TT.train(SMOKE, compress=compress, ckpt_dir=str(tmp_path / "t"),
                          params=params, device="cpu", **TRAIN)
    assert res.restarts == jres.restarts == 1
    assert [m["step"] for m in res.metrics] == [m["step"] for m in jres.metrics]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in res.metrics],
                                   [m[key] for m in jres.metrics], rtol=1e-4, err_msg=key)
    ok_state, ok = TT.train(SMOKE, compress=compress, ckpt_dir=str(tmp_path / "ok"),
                            params=params, device="cpu", **{**TRAIN, "fail_at": ()})
    assert ok.restarts == 0
    assert [(m["loss"], m["grad_norm"]) for m in res.metrics] == \
        [(m["loss"], m["grad_norm"]) for m in ok.metrics]
    for a, b in zip(tree_leaves(state), tree_leaves(ok_state)):
        assert torch.equal(a, b)


def test_train_restart_repeats_the_step_bit_for_bit(tmp_path):
    """A failure after a checkpoint that is not the failing step's: the
    steps between are run twice, with the same loss and gradient norm."""
    _, res = TT.train(SMOKE, steps=5, batch=1, seq_len=32, fail_at=(4,), ckpt_every=3,
                      keep=1, ckpt_dir=str(tmp_path), device="cpu")
    assert res.restarts == 1
    step3 = [(m["loss"], m["grad_norm"]) for m in res.metrics if m["step"] == 3]
    assert len(step3) == 2 and step3[0] == step3[1]
    assert all(np.isfinite(m["loss"]) for m in res.metrics)


def test_train_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train(SMOKE, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(["--arch", SMOKE, "--steps", "1"])


def test_full_depth_state_does_not_fit_one_card():
    """flux-mmdit's 38 blocks need ≈ 103.8 GB of f32 training state before
    any activation: more than an 80 GB card holds; 2 blocks fit."""
    full = get_config("flux-mmdit")
    with pytest.raises(ValueError, match="sharded"):
        TT.check_state_fits(full, 80 * 10 ** 9)
    TT.check_state_fits(dataclasses.replace(full, n_layers=2), 80 * 10 ** 9)


@pytest.mark.parametrize("blocks", [30, 31, 32])
def test_state_check_refuses_what_the_formula_admitted(blocks):
    """At 30-32 blocks the reference's ``n_params`` formula bills flux-mmdit
    72.5-77.3 GB, under an 80 GB card's free memory, while its f32 state
    counted from the parameter shapes is 82.0-87.5 GB: the check refuses."""
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=blocks)
    assert cfg.n_params() * TT.STATE_BYTES_PER_PARAM < 80 * 10 ** 9
    assert param_count(cfg) * TT.STATE_BYTES_PER_PARAM > 80 * 10 ** 9
    with pytest.raises(ValueError, match="sharded"):
        TT.check_state_fits(cfg, 80 * 10 ** 9)


def test_state_count_is_the_parameters_numel():
    """The check counts T1's parameters from their shapes: 369 073 664 at 2
    blocks, what ``init_params`` allocates (the formula says 301 989 888);
    the activations it adds come from T1's measured peak (14.51 GB)."""
    cfg = dataclasses.replace(get_config("flux-mmdit"), n_layers=2)
    params = dit.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    assert param_count(cfg) == sum(p.numel() for p in tree_leaves(params)) == 369_073_664
    assert cfg.n_params() == 301_989_888
    act = 2 * TT.ACT_BYTES_PER_BLOCK_ELEM * 4608 * cfg.d_model
    assert abs(369_073_664 * TT.STATE_BYTES_PER_PARAM + act - 14.51e9) < 1e3
    TT.check_state_fits(cfg, int(14.52e9))
    with pytest.raises(ValueError, match="activations"):
        TT.check_state_fits(cfg, int(14.50e9))


@pytest.mark.parametrize("remat,peak", [(True, 41.629705216e9), (False, 53.260346368e9)])
def test_lm_state_check_bills_l_train_peaks(remat, peak):
    """An LM block is billed from L-train's measured peaks (gemma3-1b, 26
    layers, batch 1, 4096 tokens), with remat and without; the DiT keeps
    T1's constant."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), remat=remat)
    assert param_count(cfg) == 999_826_048
    assert TT.act_bytes_per_block_elem(cfg) == TT.LM_ACT_BYTES_PER_BLOCK_ELEM[remat]
    act = cfg.n_layers * TT.act_bytes_per_block_elem(cfg) * 4096 * cfg.d_model
    assert abs(999_826_048 * TT.STATE_BYTES_PER_PARAM + act - peak) < 1e3
    TT.check_state_fits(cfg, int(peak + 1e7), tokens=4096)
    with pytest.raises(ValueError, match="sharded train step"):
        TT.check_state_fits(cfg, int(peak - 1e7), tokens=4096)
    assert TT.act_bytes_per_block_elem(get_config("flux-mmdit")) == TT.ACT_BYTES_PER_BLOCK_ELEM


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    TT.main(["--arch", SMOKE, "--steps", "2", "--batch", "1", "--seq-len", "16",
             "--compress", "int8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "[train] flux-smoke: 2 steps" in capsys.readouterr().out


def test_dense_mode_step_uses_no_kernel():
    """Training runs the engine off: a train step launches no kernel wrapper."""
    from repro_torch import kernels as TK
    TK.reset_launches()
    cfg = get_smoke(SMOKE)
    params = dit.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = TD.make_batch(cfg, TD.DataConfig(batch=1, seq_len=16), 0, device="cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = dit.train_loss(params, cfg, batch, dtype=torch.float32)
    torch.autograd.grad(loss, leaves)
    assert all(fn.launches == 0 for fn in TK.KERNELS)


def test_a_train_step_leaves_no_reference_cycle():
    """With the cyclic garbage collector off, a step's input state is freed as
    soon as the caller drops it: nothing in the step (the tree helpers'
    walks, autograd, AdamW) holds it in a reference cycle, which on the card
    would keep every step's parameters, moments and gradients alive."""
    import gc
    import weakref
    cfg = get_smoke(SMOKE)
    params = dit.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    opt_cfg = TO.AdamWConfig()
    step_fn = TT.make_step_fn(get_model(cfg), opt_cfg, TD.DataConfig(batch=1, seq_len=16),
                              cfg, compress="int8", device="cpu")
    state = (params, TO.adamw_init(params))
    del params
    gc.collect()
    gc.disable()
    try:
        for step in range(2):
            old = [weakref.ref(x) for x in tree_leaves(state)]
            state, _ = step_fn(state, step)
            assert all(r() is None for r in old), f"step {step} kept its input state"
    finally:
        gc.enable()


def test_train_holds_one_state_between_steps(tmp_path, monkeypatch):
    """With the cyclic gc off, when a step starts no earlier step's input is
    alive: ``train`` keeps no name on the initial state, and the loop none
    on a restored one (each would be a second copy of the state on the
    card)."""
    import gc
    import weakref
    inputs = []
    make = TT.make_step_fn

    def watched(*args, **kw):
        step_fn = make(*args, **kw)

        def run(state, step):
            alive = [s for s, ref in inputs if ref() is not None]
            assert alive == [], f"step {step}: inputs of steps {alive} are alive"
            out = step_fn(state, step)
            inputs.append((step, weakref.ref(tree_leaves(state)[0])))
            return out
        return run

    monkeypatch.setattr(TT, "make_step_fn", watched)
    gc.collect()
    gc.disable()
    try:
        _, res = TT.train(SMOKE, steps=6, batch=1, seq_len=16, fail_at=(4,), ckpt_every=3,
                          keep=1, ckpt_dir=str(tmp_path), device="cpu")
    finally:
        gc.enable()
    assert res.restarts == 1 and len(inputs) == 7
