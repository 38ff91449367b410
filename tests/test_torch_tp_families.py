"""Tensor parallelism in the ssm, hybrid, encdec and vlm families
(``launch/steps`` with the ``model`` row split) in one spawned ``gloo`` world
of 4 CPU ranks on mesh (2, 2), ``("data", "model")`` under the default
rules, at the smoke configs of mamba2-370m, recurrentgemma-2b,
whisper-large-v3 and llama-3.2-vision-11b (the vlm's cross-attention gates
opened, so that its cross layers reach the loss and the logits).  The
weights (the port's ``init_params`` from a seed) and the batches are numpy
arrays handed to both packages.

  * **train**: one step of ``build_train_step`` (f32, batch 4 over data):
    loss, grad_norm and every parameter after AdamW within 1e-4 of the
    unsharded port step (and AdamW's first moment, the clipped gradients,
    whose scale one AdamW step hides) and of the reference's
    ``build_train_step`` fn
    (jitted over a (1, 1) CPU mesh); every rank's ``tp`` leaves its own
    shard (``_tp_leaves_local``), each block the step hands the model its
    rank's ``tp`` shards, and ``tp_replicated`` empty;
  * **prefill / decode**: the prefill builder on 16 tokens, then 2 greedy
    steps of the decode builder: tokens equal to the unsharded port's,
    logits within 1e-4 of the reference builders' fns;
  * **decode on the cache's ``sp`` shard**: recurrentgemma (its attention
    layers' ring) and llama-3.2-vision (its self blocks' caches) under
    ``rules_for``'s decode rules, from position 0 across the shards'
    boundary (the ring wraps), held as ``test_torch_steps``' SP cases are
    (:data:`SP_CASES`);
  * **a row that does not divide the heads** (ROADMAP C.14): the smoke
    configs of recurrentgemma (hybrid), gemma3-1b (transformer) and
    whisper-large-v3 (encdec) with 3 heads (``dataclasses.replace``) split
    them 2 and 1 over the row, as ``torch.tensor_split`` does, with
    ``tp_replicated`` empty, held as above (gemma3-1b's and whisper's also
    to the reference on the same config); and flux-mmdit smoke's DiT step
    with 3 heads (batch 2 over data, its engine on 2 heads and on 1):
    Update then Dispatch, the symbols and every integer plan field
    ``torch.equal`` to the unsharded port step's, its ``v`` and f32 state
    fields within 1e-5 and its bf16 stack within one unit in the last
    place of it, ``v`` within 1e-5 of the reference's ``build_dit_step``
    fn, the plain kernels once a layer at Dispatch on each rank;
  * **the ssm's packed split**: a mamba2 block at width 128 with 14 states
    on a (1, 4) row, where a rank's contiguous shard of ``in_proj`` (136 of
    544 columns) ends inside ``z`` (256 columns): its output and the
    gradients of its input and of every ``tp`` leaf equal the whole block's
    (each rank's gradient the shard of the whole one), and the decode block
    likewise, its SSD state the rank's heads and its packed conv window
    the rank's contiguous shard.

The ranks run a module-level function of this file, which imports neither
JAX nor the reference at module level.
"""

import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import run_local_mesh
from test_torch_steps import (DISPATCH_KERNELS, DIT_SLICE_BF16_ULPS, DIT_SLICE_REL, DIT_TOL,
                              _close, _dit_inputs, _f32_reference, _jit, _states_compare,
                              _torch, _tp_leaves_local, check_sp_decode, reference_sp_decode,
                              sp_decode_rank, sp_first_tokens, unsharded_sp_decode)

MESH = (2, 2)
JOIN_S = 300
ARCHS = ("mamba2-370m", "recurrentgemma-2b", "whisper-large-v3", "llama-3.2-vision-11b")
# A case's name, and the config it runs: the arch's smoke config, or (the
# "-3-heads" cases) the hybrid's, the transformer's and the encdec's with 3
# heads on the row of 2.
THREE_HEADS = ("recurrentgemma-2b", "gemma3-1b", "whisper-large-v3")
CASES = ARCHS + tuple(f"{a}-3-heads" for a in THREE_HEADS)
# The cases also held to the reference (recurrentgemma's 3-head case is not).
REFERENCE_CASES = ARCHS + ("gemma3-1b-3-heads", "whisper-large-v3-3-heads")
DIT_B, DIT_VISION = 2, 96
SEQ, TRAIN_B = 16, 4
SERVE_B, PROMPT, MAX_LEN, DECODE_STEPS = 4, 16, 32, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TOL = dict(rtol=1e-4, atol=1e-4)
PACKED_TOL = dict(rtol=1e-5, atol=1e-5)
PACKED = dict(d_model=128, ssm_state=14)      # 4 heads; in_proj 544 = 4 x 136 < d_inner 256
# Decode on the caches' sp shard (test_torch_steps.SP_CASES' layout): the
# decode rules, batch 4, 6 slots (3 a rank).
SP_CASES = {"recurrentgemma-2b": ("recurrentgemma-2b", 4, 6, 0, 7),
            "llama-3.2-vision-11b": ("llama-3.2-vision-11b", 4, 6, 0, 4)}


def three_heads(cfg):
    """``cfg`` with 3 heads of its width (and 3 K/V heads where it has one
    a head)."""
    return dataclasses.replace(cfg, n_heads=3, head_dim=cfg.hd,
                               n_kv_heads=3 if cfg.n_kv_heads == cfg.n_heads else cfg.n_kv_heads)


def _cfg(case: str, get=None):
    """The config of ``case`` from ``get`` (the port's ``get_smoke`` by
    default; the reference's for its runs)."""
    if get is None:
        from repro_torch.configs.registry import get_smoke as get
    if case.endswith("-3-heads"):
        return three_heads(get(case.removesuffix("-3-heads")))
    return get(case)


def _block_shards_expected(cfg, shapes: dict, m: int) -> bool:
    """Every leaf of each block the step gathered (``shapes``, by group) has
    its ``tp`` dim cut to the row's share and every other dim whole."""
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_flatten
    model = get_model(cfg)
    params = model.init_params(None, "meta")
    specs = model.param_specs()
    for group, got in shapes.items():
        leaves, _ = tree_flatten(params[group])
        leaf_specs = tree_flatten(specs[group], is_leaf=lambda x: isinstance(x, tuple))[0]
        stacked = len(leaves[0].shape) - len(got[0])
        for t, spec, shape in zip(leaves, leaf_specs, got):
            want = tuple(n // m if e == "tp" else n
                         for n, e in zip(t.shape[stacked:], spec[stacked:]))
            if tuple(shape) != want:
                return False
    return True


def packed_ssm_rank(mesh) -> dict:
    """A mamba2 block on the (1, 4) row whose contiguous ``in_proj`` shards
    end inside ``z``: this rank's results and the whole block's."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_smoke("mamba2-370m"), **PACKED)
    g = torch.Generator().manual_seed(4)
    blk = {k: v[0] for k, v in ssm.init_params(cfg, g, "cpu")["blocks"].items()}
    blk["a_log"] = torch.randn(blk["a_log"].shape, generator=g) * 0.5
    blk["dt_bias"] = torch.randn(blk["dt_bias"].shape, generator=g) * 0.5
    specs = ssm._block_specs(stack=False)
    r, m = mesh.get_coordinate()[1], mesh.size(1)
    cut = lambda t, spec: (t.narrow(spec.index("tp"), r * (t.shape[spec.index("tp")] // m),
                                    t.shape[spec.index("tp")] // m) if "tp" in spec else t)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    probe = torch.randn((2, 16, cfg.d_model), generator=g)

    def run(p, row: bool):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        with tp.model_parallel(mesh, (1,) if row else ()):
            out = ssm._block_apply(cfg, leaves, xi)
            grads = torch.autograd.grad((out * probe).sum(), [xi, *leaves.values()])
        return out.detach(), dict(zip(["x", *leaves], grads))

    want, want_g = run(blk, False)
    got, got_g = run({k: cut(v, specs[k]) for k, v in blk.items()}, True)
    d_inner, h, n = ssm._dims(cfg)
    ssm_state = torch.randn((2, h, ssm.HEAD_DIM, n), generator=g)
    conv = torch.randn((2, ssm.CONV_K - 1, d_inner + 2 * n), generator=g)
    x1 = x[:, :1]
    with torch.no_grad():
        dec_want = ssm._decode_block(cfg, blk, x1, ssm_state, conv)
        with tp.model_parallel(mesh, (1,)):
            dec_got = ssm._decode_block(cfg, {k: cut(v, specs[k]) for k, v in blk.items()}, x1,
                                        cut(ssm_state, (None, "tp")), cut(conv, (None, None,
                                                                                  "tp")))
    tp_leaves = [k for k, spec in specs.items() if "tp" in spec]
    return {"out": (got, want), "x_grad": (got_g["x"], want_g["x"]),
            "leaf_grads": {k: (got_g[k], cut(want_g[k], specs[k])) for k in tp_leaves},
            "decode": [(dec_got[0], dec_want[0]), (dec_got[1], cut(dec_want[1], (None, "tp"))),
                       (dec_got[2], cut(dec_want[2], (None, None, "tp")))],
            "shard_cols": blk["in_proj"].shape[-1] // m, "d_inner": d_inner}


def dit_rank(mesh, inputs: dict) -> dict:
    """flux-mmdit smoke's DiT step with 3 heads on this rank of the row of
    2 (batch over data): Update then Dispatch, each against the unsharded
    port step on the rank's batch slice."""
    from torch.distributed.tensor import Replicate
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import backend
    from repro_torch.distributed.sharding import DEFAULT_RULES as R, redistribute
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_map
    cfg, ecfg = three_heads(get_smoke("flux-mmdit")), serving_engine_config()
    n_tok = DIT_VISION + cfg.n_text_tokens
    shape = ShapeSpec("d", n_tok, DIT_B, "serve")
    whole = lambda x: redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()
    params = tree_map(lambda t: t.to(torch.bfloat16), _torch(inputs["dit"]["params"]))
    x = _torch(inputs["dit"]["inputs"])
    p = reshard_state(params, dit.param_specs(cfg), mesh, R)
    spec = dit.engine_state_specs(cfg, ecfg)
    states = ST.place_states(dit.init_engine_states(cfg, ecfg, DIT_B, n_tok, "cpu"), spec,
                             mesh, R)
    xd = reshard_state(x, S.dit_inputs_logical(cfg), mesh, R)
    compute = ST._compute_placements(ST._state_tree(spec), mesh, R)
    d = mesh.get_coordinate()[0]
    sl = slice(d, d + 1)
    one = dit.init_engine_states(cfg, ecfg, 1, n_tok, "cpu")
    kept = {name: getattr(backend, name) for name in DISPATCH_KERNELS}
    out = {}
    for mode in ("update", "dispatch"):
        fn = ST.build_dit_step(cfg, shape, mesh, R, mode=mode, ecfg=ecfg, dtype=torch.float32)[0]
        calls = dict.fromkeys(DISPATCH_KERNELS, 0)
        for name in DISPATCH_KERNELS:
            setattr(backend, name, lambda *a, _n=name, **kw: calls.__setitem__(
                _n, calls[_n] + 1) or kept[_n](*a, **kw))
        try:
            v, states = fn(p, states, xd)
        finally:
            for name in DISPATCH_KERNELS:
                setattr(backend, name, kept[name])
        v1, one = dit.denoise_step(params, cfg, ecfg, one, x["x_vision"][sl], x["text_emb"][sl],
                                   x["t"][sl], mode=mode, dtype=torch.float32)
        local = [ST._state_from_tree(tree_map(ST._to_local, ST._state_tree(s), compute,
                                              is_leaf=ST._is_pl), s) for s in states]
        ints_equal, float_rel, bf16_ulps = _states_compare(local, one)
        out[mode] = {"v": whole(v),
                     "v_rel": float((v.to_local() - v1).abs().max()) / float(v1.abs().max()),
                     "ints_equal": ints_equal, "float_rel": float_rel, "bf16_ulps": bf16_ulps,
                     "calls": calls, "tp_replicated": fn.stats["tp_replicated"]}
    return out


def families_rank(rank: int, inputs: dict) -> dict:
    """One rank of the world: every case, this rank's results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.sharding import DEFAULT_RULES as R, redistribute
    from repro_torch.distributed.tensor_parallel import ParamGather
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_state_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_flatten, tree_map
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(MESH), mesh_dim_names=("data", "model"))
    row4 = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    whole = lambda x: redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()
    shapes: dict = {}
    groups: list = []             # the step's block groups, in ParamGather's order
    kept_block = ParamGather.block

    def recording_block(self, group, idx):
        got = kept_block(self, group, idx)
        key = next(k for k, (stack, _) in zip(groups, self._stacks) if stack is group)
        shapes[key] = [tuple(t.shape) for t in tree_flatten(got)[0]]
        return got

    ParamGather.block = recording_block
    out = {}
    gc.disable()                  # a step's gather must not outlive it, cycle or not
    for case in CASES:
        cfg = _cfg(case)
        model = get_model(cfg)
        params = _torch(inputs["params"][case])
        fn, _, _, out_pl = ST.build_train_step(cfg, ShapeSpec("t", SEQ, TRAIN_B, "train"), mesh,
                                               R, opt_cfg=AdamWConfig(**OPT),
                                               dtype=torch.float32)
        p = reshard_state(params, model.param_specs(), mesh, R)
        o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh, R)
        b = reshard_state(_torch(inputs["train"][case]), S.train_batch_logical(cfg), mesh, R)
        shapes.clear()
        groups[:] = sorted(k for k in params if k in model.block_groups())
        p, o, m = fn(p, o, b)
        rec = {"metrics": (float(m["loss"].to_local()), float(m["grad_norm"].to_local())),
               "params": tree_map(whole, p), "mu": tree_map(whole, o["mu"]),
               "local_shards": _tp_leaves_local(p, out_pl[0]),
               "block_shards": _block_shards_expected(cfg, shapes, MESH[1]),
               "tp_replicated": {"train": fn.stats["tp_replicated"]}}
        del fn, p, o, b, m
        pre = ST.build_prefill_step(cfg, ShapeSpec("p", PROMPT, SERVE_B, "prefill"), mesh, R,
                                    dtype=torch.float32)[0]
        dec, _, dec_pl, _ = ST.build_decode_step(
            cfg, ShapeSpec("d", MAX_LEN, SERVE_B, "decode"), mesh, R, dtype=torch.float32)
        p = reshard_state(params, model.param_specs(), mesh, R)
        batch = reshard_state(_torch(inputs["serve"][case]), S.prefill_batch_logical(cfg),
                              mesh, R)
        logits = pre(p, batch)
        rec.update(prefill=whole(logits), decode=[], tokens=[])
        rec["tp_replicated"]["prefill"] = pre.stats["tp_replicated"]
        cache = reshard_state(model.init_cache(SERVE_B, MAX_LEN, torch.float32, device="cpu"),
                              model.cache_specs(), mesh, R)
        for pos in range(DECODE_STEPS):
            tok = DTensor.from_local(logits.to_local().argmax(-1).to(torch.int32), mesh,
                                     dec_pl[2], run_check=False)
            rec["tokens"].append(whole(tok))
            logits, cache = dec(p, cache, tok, pos)
            rec["decode"].append(whole(logits))
        rec["tp_replicated"]["decode"] = dec.stats["tp_replicated"]
        rec["cache_laid_out"] = _tp_leaves_local(cache, dec_pl[1])
        out[case] = rec
        del pre, dec, p, cache, logits, batch
    gc.enable()
    ParamGather.block = kept_block
    out["sp"] = {case: sp_decode_rank(mesh, spec, inputs["params"][case], inputs["sp_first"][case])
                 for case, spec in SP_CASES.items()}
    out["packed"] = packed_ssm_rank(row4)
    out["dit"] = dit_rank(mesh, inputs)
    dist.barrier()
    return out


def _inputs_for(case: str, seed: int) -> dict:
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    cfg = _cfg(case)
    params = tree_map(lambda t: t.numpy(), get_model(cfg).init_params(
        torch.Generator().manual_seed(seed), "cpu"))
    if cfg.family == "vlm":                       # open the gates (0 at init)
        params["cross"]["gate"] = np.linspace(0.6, -0.4, params["cross"]["gate"].shape[0],
                                              dtype=np.float32)
    rng = np.random.default_rng(seed + 100)

    def batch(b, labels):
        out = {"tokens": rng.integers(0, cfg.vocab, (b, SEQ)).astype(np.int32)}
        if labels:
            out["labels"] = rng.integers(0, cfg.vocab, (b, SEQ)).astype(np.int32)
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal((b, cfg.encoder_len, cfg.d_model),
                                                dtype=np.float32)
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model),
                                                 dtype=np.float32)
        return out

    return {"params": params, "train": batch(TRAIN_B, True), "serve": batch(SERVE_B, False)}


@pytest.fixture(scope="module")
def inputs():
    per = {case: _inputs_for(case, seed) for seed, case in enumerate(CASES)}
    out = {k: {case: per[case][k] for case in CASES} for k in ("params", "train", "serve")}
    out["sp_first"] = {case: sp_first_tokens(spec, 50 + i)
                       for i, (case, spec) in enumerate(SP_CASES.items())}
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import dit
    from repro_torch.tree import tree_map
    cfg = three_heads(get_smoke("flux-mmdit"))
    out["dit"] = {"params": tree_map(lambda t: t.numpy(), dit.init_params(
        cfg, torch.Generator().manual_seed(70), "cpu")),
        "inputs": _dit_inputs(cfg, DIT_B, DIT_VISION, 71)}
    return out


def _unsharded(case: str, inputs: dict) -> dict:
    """The port's unsharded train step, prefill and greedy decode."""
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_flatten, tree_unflatten
    model = get_model(_cfg(case))
    params = _torch(inputs["params"][case])
    leaves, tdef = tree_flatten(params)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    loss = model.train_loss(tree_unflatten(tdef, leaves), _torch(inputs["train"][case]),
                            dtype=torch.float32)
    grads = tree_unflatten(tdef, torch.autograd.grad(loss, leaves))
    p, o, gnorm = adamw_update(grads, adamw_init(params), params, AdamWConfig(**OPT))
    rec = {"metrics": (float(loss.detach()), float(gnorm)), "params": p, "mu": o["mu"],
           "tokens": [], "decode": []}
    with torch.no_grad():
        logits = model.prefill(params, _torch(inputs["serve"][case]), dtype=torch.float32)
        rec["prefill"] = logits
        cache = model.init_cache(SERVE_B, MAX_LEN, torch.float32, device="cpu")
        for pos in range(DECODE_STEPS):
            tok = logits.argmax(-1).to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok, pos, dtype=torch.float32)
            rec["tokens"].append(tok)
            rec["decode"].append(logits)
    return rec


def _reference(case: str, inputs: dict, tokens: list) -> dict:
    """The reference builders' fns on a (1, 1) CPU mesh on the same config
    and inputs (decode fed the unsharded port's greedy ``tokens``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeSpec as J
    from repro.configs.registry import get_smoke as j_get_smoke
    from repro.distributed.sharding import DEFAULT_RULES as R
    from repro.launch import steps as JST
    from repro.models.registry import get_model as j_get_model
    from repro.optim.optimizer import AdamWConfig, adamw_init
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    jcfg, jp = _cfg(case, j_get_smoke), inputs["params"][case]
    with mesh:
        step, place = _jit(mesh, JST.build_train_step(jcfg, J("t", SEQ, TRAIN_B, "train"), mesh,
                                                      R, opt_cfg=AdamWConfig(**OPT)))
        p, _, m = step(*place(jp, adamw_init(jp), inputs["train"][case]))
        rec = {"metrics": (float(m["loss"]), float(m["grad_norm"])),
               "params": jax.tree.leaves(jax.tree.map(np.asarray, p))}
        pre, place = _jit(mesh, JST.build_prefill_step(jcfg, J("p", PROMPT, SERVE_B, "prefill"),
                                                       mesh, R))
        rec["prefill"] = np.asarray(pre(*place(jp, inputs["serve"][case])))
        dec, place = _jit(mesh, JST.build_decode_step(jcfg, J("d", MAX_LEN, SERVE_B, "decode"),
                                                      mesh, R))
        cache, rec["decode"] = j_get_model(jcfg).init_cache(SERVE_B, MAX_LEN, jnp.float32), []
        for pos, tok in enumerate(tokens):
            logits, cache = dec(*place(jp, cache, tok.numpy(), jnp.int32(pos)))
            rec["decode"].append(np.asarray(logits))
    return rec


def _dit_reference(inputs: dict) -> dict:
    """The reference's ``build_dit_step`` fn (Update, then Dispatch) on a
    (1, 1) CPU mesh, on flux-mmdit smoke with 3 heads."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeSpec as J
    from repro.configs.registry import get_smoke as j_get_smoke
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.core.masks import MaskConfig as JMaskConfig
    from repro.distributed.sharding import DEFAULT_RULES as R
    from repro.launch import steps as JST
    from repro.models import dit as jdit
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    jcfg = three_heads(j_get_smoke("flux-mmdit"))
    jecfg = JEngineConfig(mask=JMaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1,
                                           degrade=0.3, block_q=16, block_kv=16, pool=32,
                                           warmup_steps=2))
    n_tok = DIT_VISION + jcfg.n_text_tokens
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), inputs["dit"]["params"])
    states, out = jdit.init_engine_states(jcfg, jecfg, DIT_B, n_tok), {}
    with mesh:
        for mode in ("update", "dispatch"):
            step, place = _jit(mesh, JST.build_dit_step(jcfg, J("d", n_tok, DIT_B, "serve"),
                                                        mesh, R, mode=mode, ecfg=jecfg))
            v, states = step(*place(params, states, inputs["dit"]["inputs"]))
            out[mode] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(inputs):
    """The world's results, and the unsharded and reference runs computed
    here while the ranks run."""
    box = {}

    def run_world():
        try:
            box["world"] = run_local_mesh(families_rank, *MESH, inputs, timeout=JOIN_S)
        except BaseException as e:                  # re-raised on the test's thread
            box["error"] = e

    thread = threading.Thread(target=run_world)
    thread.start()
    try:
        local = {case: _unsharded(case, inputs) for case in CASES}
        local["sp"] = {case: unsharded_sp_decode(spec, inputs["params"][case],
                                                 inputs["sp_first"][case])
                       for case, spec in SP_CASES.items()}
        with _f32_reference():
            ref = {c: _reference(c, inputs, local[c]["tokens"]) for c in REFERENCE_CASES}
            ref["dit"] = _dit_reference(inputs)
            ref["sp"] = {case: reference_sp_decode(spec, inputs["params"][case],
                                                   local["sp"][case]["tokens"])
                         for case, spec in SP_CASES.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["world"], local, ref


@pytest.mark.parametrize("case", CASES)
def test_split_row_matches_unsharded_and_the_reference(runs, case):
    from repro_torch.tree import tree_flatten
    world, local, ref = runs
    got, want = world[0][case], local[case]
    assert all(r[case]["metrics"] == got["metrics"] for r in world)
    assert all(r[case]["local_shards"] and r[case]["block_shards"] and r[case]["cache_laid_out"]
               for r in world)
    leaves = tree_flatten(got["params"])[0]
    _close(np.array(got["metrics"]), want["metrics"], **TOL)
    for a, b in zip(leaves, tree_flatten(want["params"])[0]):
        _close(a, b, **TOL)
    for a, b in zip(tree_flatten(got["mu"])[0], tree_flatten(want["mu"])[0]):
        _close(a, b, **TOL)              # the clipped gradients, times 1 - b1
    assert all(torch.equal(r[case]["prefill"], got["prefill"]) for r in world)
    _close(got["prefill"], want["prefill"].numpy(), **TOL)
    for pos in range(DECODE_STEPS):
        assert torch.equal(got["tokens"][pos], want["tokens"][pos]), pos
        _close(got["decode"][pos], want["decode"][pos].numpy(), **TOL)
    if case in ref:
        jref = ref[case]
        _close(np.array(got["metrics"]), jref["metrics"], **TOL)
        for a, c in zip(leaves, jref["params"]):
            _close(a, c, **TOL)
        _close(got["prefill"], jref["prefill"], **TOL)
        for pos in range(DECODE_STEPS):
            _close(got["decode"][pos], jref["decode"][pos], **TOL)
    for r in world:
        assert r[case]["tp_replicated"] == dict.fromkeys(("train", "prefill", "decode"), [])


def test_dit_step_splits_three_heads_over_a_row_of_two(runs):
    world, _, ref = runs
    for r in world:
        for mode in ("update", "dispatch"):
            rec = r["dit"][mode]
            assert rec["ints_equal"] and rec["tp_replicated"] == [], mode
            assert rec["v_rel"] <= DIT_SLICE_REL and rec["float_rel"] <= DIT_SLICE_REL, mode
            assert rec["bf16_ulps"] <= DIT_SLICE_BF16_ULPS, mode
            _close(rec["v"], ref["dit"][mode], **DIT_TOL)
        assert r["dit"]["update"]["calls"] == dict.fromkeys(DISPATCH_KERNELS, 0)
        assert r["dit"]["dispatch"]["calls"] == dict.fromkeys(DISPATCH_KERNELS, 3)


@pytest.mark.parametrize("case", SP_CASES)
def test_decode_keeps_the_cache_sequence_shard_and_matches(runs, case):
    world, local, ref = runs
    check_sp_decode(world, case, local["sp"][case], ref["sp"][case])


def test_ssm_packed_split_ending_inside_z_matches_the_whole_block(runs):
    world = runs[0]
    assert world[0]["packed"]["shard_cols"] < world[0]["packed"]["d_inner"]
    for r in world:
        rec = r["packed"]
        pairs = [rec["out"], rec["x_grad"], *rec["leaf_grads"].values(), *rec["decode"]]
        for got, want in pairs:
            assert got.shape == want.shape
            _close(got, want.numpy(), **PACKED_TOL)
