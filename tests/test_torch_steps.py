"""The port's sharded step builders (``repro_torch.launch.steps``) in one
spawned ``gloo`` world of 4 CPU ranks on mesh (2, 2), ``("data", "model")``
under the default rules, shared by every case, so that both the ``fsdp``
(data) and ``tp`` (model) dims of the parameters are really sharded.  The
weights (the port's ``init_params`` from a seed) and the batches are numpy
arrays handed to both packages.

  * **train**: 2 FSDP steps of flux-mmdit, gemma3-1b, llama3-405b and
    mixtral-8x22b (smoke, f32, every batch split over data; all four split
    the ``model`` axis: the DiT's 2 heads and its MLP, the LMs' 1, 2 and 2
    K/V heads, and mixtral's MoE, which routes the global batch),
    gemma3-1b also with ``cfg.remat``, against the unsharded port step
    (``adamw_update`` on the whole tree) and against the reference's
    ``build_train_step`` fn (jitted over a (1, 1) CPU mesh): loss,
    grad_norm and every parameter within 1e-4; ``cast_params_bf16=True``
    against the reference's within 2e-2; the gradients of every leaf
    replicated over ``model`` (norms, router, the DiT's modulations),
    read from AdamW's first moment, equal on the two ranks of each row;
  * **MoE routing over dp**: mixtral smoke's ``moe_mlp`` shape on each
    rank's slice of a batch of 4 under the step's ``dp`` group: each rank's
    per-expert kept counts equal to the reference ``moe_mlp``'s routing of
    the concatenated batch, its aux loss within 1e-6 and its output within
    1e-5 of the reference's, and its expert buffer no longer than its own
    largest kept count;
  * **DiT step**: Update then Dispatch on flux-mmdit smoke (the serving
    launcher's engine config, batch 2 over data, its 2 heads split 1 a
    rank over model): each rank's symbols and every integer plan field
    ``torch.equal`` to the unsharded ``denoise_step`` on its own batch-1
    slice, its ``v`` and the f32 state fields within 1e-5 of their largest
    magnitude there (the row's sum adds in another order) and the bf16
    TaylorSeer stack within one unit in its last place (that f32 sum
    rounded once), the
    gathered ``v`` within 1e-5 of the reference's ``build_dit_step`` fn on
    the XLA backend, each rank's gathered block holding only its ``tp``
    shards of the six split leaves, nothing computed replicated, and the
    kernels' plain versions called once a layer at Dispatch (none at
    Update);
  * **DiT step on the sequence's ``sp`` shard**: the same, at batch 1 under
    ``rules_for``'s DiT rules (``sp`` over data, heads and MLP over model,
    both splits at once), at 128 vision tokens (a rank's share of the
    sequence 2.5 pool rows) and 96 (2 whole rows): the whole ``v`` within
    1e-5 of the reference's ``build_dit_step`` fn under the reference's own
    DiT rules, the symbols and every integer plan field ``torch.equal`` to
    the unsharded port step's, the f32 state fields within 1e-5 and the
    bf16 stack within one unit in its last place of it, each rank's
    TaylorSeer stack its own ``sp`` shard, ``sp_rows`` covering the
    sequence's pool rows once, and the plain kernels called once a layer
    at Dispatch on each rank (none at Update) on the rank's rows alone,
    whose Dispatch layer records no sort, top-k or unpack; and on a data
    column of 4 (mesh (4, 1)) at 64 vision tokens, 3 pool rows over 4
    ranks, with 3 KV buckets: the last rank computes no row and launches
    nothing, the rest run the uniform kernels on the bucket-clamped lists
    and hold as above against the unsharded (bucketed) step;
  * **prefill / decode**: gemma3-1b, llama3-405b, mixtral-8x22b and
    whisper-large-v3 smoke, batch 4 over data: greedy tokens equal to the
    unsharded port's, logits within 1e-4 of the reference builders' fns
    (f32 weights and caches);
  * **decode on the cache's ``sp`` shard**: gemma3-1b (global and ring
    layers) and whisper-large-v3 (the self cache) under ``rules_for``'s
    decode rules (``sp`` the model axis, batch 4 over data), and gemma3-1b
    under its ``long_500k`` rules (batch 1, ``sp`` over both axes, a cache
    of 13 slots laid out 4, 3, 3, 3): greedy decode from position 0 (the
    other shards hold no live slot) across the shards' boundaries (and
    past the cache's end: the ring wraps, the global slot clamps), tokens
    equal to the unsharded port's, logits within 1e-4 of it and of the
    reference's ``build_decode_step`` fn jitted with the same rules, every
    rank's logits the same bits, each rank's cache its own shard and no
    cache byte moved (:data:`SP_CASES`, shared with
    ``test_torch_tp_families``);
  * every step gathers its parameters a block at a time: its
    ``max_gathered_bytes`` is at most one block whole plus the leaves
    outside the blocks, and each rank holds only its own shard of every
    ``tp`` leaf;
  * the vocab-parallel ``softmax_xent`` (with its z-loss) on each row's
    vocab shards against the whole-vocab one, loss and gradient within 1e-6;
  * a rank whose inputs disagree with the step's placements makes every
    rank raise, instead of hanging a collective.

The reference runs in f32: its adapters default to bf16, so the tests wrap
``Model.train_loss``/``prefill``/``decode_step`` and ``dit.denoise_step``
to pass ``dtype=float32``, as the port's builders take ``dtype``.  The
ranks run a module-level function of this file, which imports neither JAX
nor the reference at module level.
"""

import contextlib
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import run_local_mesh

MESH = (2, 2)
JOIN_S = 180
TRAIN_ARCHS = ("flux-mmdit", "gemma3-1b", "llama3-405b", "mixtral-8x22b")
TRAIN_SEQ = {"flux-mmdit": 128, "gemma3-1b": 32, "llama3-405b": 32, "mixtral-8x22b": 32}
# (arch, cast_params_bf16, remat) of each sharded train case.
TRAIN_CASES = ([(a, False, False) for a in TRAIN_ARCHS] + [("gemma3-1b", False, True),
                                                             ("flux-mmdit", True, False)])
TRAIN_B, TRAIN_STEPS = 4, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
DIT_B, DIT_VISION = 2, 96
# Vision tokens of the DiT step on the sequence's sp shard (batch 1, rules_for's
# DiT rules): 128 (+ 32 text) gives a rank 80 tokens of the reference's layout,
# 2.5 pool rows of 32; 96 gives it 64, 2 whole rows.
DIT_SP_VISION = (128, 96)
# The same on a data column of 4 (mesh (4, 1)) at 64 vision tokens: 96
# tokens in 3 pool rows over 4 ranks, so the last rank computes no row; with
# 3 KV buckets, which a sequence shard reads through the uniform kernels.
DIT_SP_EMPTY_VISION, DIT_SP_EMPTY_BUCKETS = 64, 3
SERVE_ARCHS = ("gemma3-1b", "llama3-405b", "mixtral-8x22b", "whisper-large-v3")
SERVE_B, PROMPT, MAX_LEN, DECODE_STEPS = 4, 32, 64, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DIT_TOL = dict(rtol=1e-5, atol=1e-5)
DIT_SLICE_REL = 1e-5             # of the unsharded slice's largest magnitude
DIT_SLICE_BF16_ULPS = 1          # a bf16 state field: its f32 source rounded once
MOE_B, MOE_S, MOE_SEED = 4, 16, 23
MOE_AUX_TOL = dict(rtol=1e-6, atol=1e-6)
MOE_Y_TOL = dict(rtol=1e-5, atol=1e-5)
DISPATCH_KERNELS = ("gemm_q_sparse_kernel", "flashomni_attention_csr", "gemm_o_sparse_kernel")
XENT_TOL = dict(rtol=1e-6, atol=1e-6)
# name: (arch, batch, cache slots, first position, decode steps) of a decode
# on the caches' sp shard under rules_for's rules for that batch: batch 4
# the decode rules (sp over model, 2 ranks), batch 1 long_500k's (sp over
# data and model, 4 ranks).
SP_CASES = {"gemma3-1b": ("gemma3-1b", 4, 6, 0, 7),
            "whisper-large-v3": ("whisper-large-v3", 4, 6, 0, 4),
            "gemma3-1b-long": ("gemma3-1b", 1, 13, 0, 9)}


def gather_bound(params: dict, groups: tuple, dtype=None) -> int:
    """One block of the largest block group, whole, plus every leaf outside
    the groups, whole (in ``dtype`` when given)."""
    from repro_torch.tree import tree_leaves
    size = lambda t: t.numel() * (t.element_size() if dtype is None
                                  else torch.empty((), dtype=dtype).element_size())
    outside = sum(size(t) for k, v in params.items() if k not in groups
                  for t in tree_leaves(v))
    one_block = 0
    for k in groups:
        if k in params:
            leaves = tree_leaves(params[k])
            n = leaves[0].shape[0] * (leaves[0].shape[1] if k in ("locals", "rec", "selfs")
                                      else 1)
            one_block = max(one_block, sum(size(t) for t in leaves) // n)
    return outside + one_block


def _tp_leaves_local(tree, pls) -> bool:
    """Every DTensor's local tensor has the shape of its own shard."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from repro_torch.launch import steps as ST
    from repro_torch.tree import tree_leaves
    for x, pl in zip(tree_leaves(tree), tree_leaves(pls, is_leaf=ST._is_pl)):
        want, _ = compute_local_shape_and_global_offset(x.shape, x.device_mesh, pl)
        if tuple(x.to_local().shape) != tuple(want):
            return False
    return True


def xent_rank(mesh) -> dict:
    """The vocab-parallel softmax_xent against the whole-vocab one: each
    rank's row holds the vocab split over ``model`` (padding columns past
    ``vocab`` on the last shard)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import layers as L
    n, vocab, padded = 24, 500, 512
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((n, padded), generator=g) * 3.0
    labels = torch.randint(0, vocab, (n,), generator=g)
    whole = logits[:, :vocab].clone().requires_grad_(True)
    want = L.softmax_xent(whole, labels)
    (want_g,) = torch.autograd.grad(want, whole)
    r, m = mesh.get_coordinate()[1], mesh.size(1)
    v_loc = padded // m
    mine = logits[:, r * v_loc:(r + 1) * v_loc].clone().requires_grad_(True)
    with tp.model_parallel(mesh, (1,)):
        got = L.softmax_xent(mine, labels, vocab=vocab)
    (got_g,) = torch.autograd.grad(got, mine)
    want_mine = torch.zeros_like(got_g)
    cols = min(vocab, (r + 1) * v_loc) - r * v_loc
    want_mine[:, :cols] = want_g[:, r * v_loc:r * v_loc + cols]
    return {"loss": (float(got), float(want)), "grad": (got_g, want_mine)}


def _sp_rules(case: tuple, j: bool = False):
    """``(cfg, shape, rules)`` of an SP case, in the port's or (``j``) the
    reference's package."""
    arch, b, slots = case[:3]
    if j:
        from repro.configs.base import ShapeSpec as J
        from repro.configs.registry import get_smoke
        from repro.launch.mesh import rules_for
        shape = J("d", slots, b, "decode")
    else:
        from repro_torch.configs.registry import get_smoke
        from repro_torch.launch.mesh import rules_for
        shape = ShapeSpec("d", slots, b, "decode")
    cfg = get_smoke(arch)
    return cfg, shape, rules_for(cfg, shape, multi_pod=False)


def sp_first_tokens(case: tuple, seed: int) -> np.ndarray:
    from repro_torch.configs.registry import get_smoke
    return np.random.default_rng(seed).integers(0, get_smoke(case[0]).vocab,
                                                (case[1],)).astype(np.int32)


def sp_decode_rank(mesh, case: tuple, params: dict, first: np.ndarray) -> dict:
    """Greedy decode of an SP case through ``build_decode_step`` on this
    rank: the gathered tokens and logits, each step's moved cache bytes,
    and whether every cache leaf's local tensor is its own shard."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.sharding import redistribute
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.elastic import reshard_state
    _, b, slots, p0, n = case
    cfg, shape, rules = _sp_rules(case)
    model = get_model(cfg)
    whole = lambda x: redistribute(x, [Replicate()] * mesh.ndim).to_local()
    dec, _, pl, _ = ST.build_decode_step(cfg, shape, mesh, rules, dtype=torch.float32)
    p = reshard_state(_torch(params), model.param_specs(), mesh, rules)
    cache = reshard_state(model.init_cache(b, slots, torch.float32, device="cpu"),
                          model.cache_specs(), mesh, rules)
    tok = reshard_state({"t": torch.from_numpy(first)}, {"t": ("dp",)}, mesh, rules)["t"]
    rec = {"tokens": [], "decode": [], "moved": []}
    for pos in range(p0, p0 + n):
        rec["tokens"].append(whole(tok))
        logits, cache = dec(p, cache, tok, pos)
        rec["decode"].append(whole(logits))
        rec["moved"].append(dec.stats["cache_moved_bytes"])
        tok = ST._dtensor(logits.to_local().argmax(-1).to(torch.int32), mesh, pl[2], (b,))
    rec["local_shards"] = _tp_leaves_local(cache, pl[1])
    return rec


@torch.no_grad()
def unsharded_sp_decode(case: tuple, params: dict, first: np.ndarray) -> dict:
    """The port's greedy decode of an SP case on one device."""
    from repro_torch.models.registry import get_model
    _, b, slots, p0, n = case
    model = get_model(_sp_rules(case)[0])
    params = _torch(params)
    cache = model.init_cache(b, slots, torch.float32, device="cpu")
    tok, rec = torch.from_numpy(first), {"tokens": [], "decode": []}
    for pos in range(p0, p0 + n):
        rec["tokens"].append(tok)
        logits, cache = model.decode_step(params, cache, tok, pos, dtype=torch.float32)
        rec["decode"].append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    return rec


def reference_sp_decode(case: tuple, params: dict, tokens: list) -> list:
    """The reference's ``build_decode_step`` fn of an SP case, jitted with
    the same rules over a (1, 1) CPU mesh, fed ``tokens``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.launch import steps as JST
    from repro.models.registry import get_model as j_get_model
    _, b, slots, p0, _ = case
    jcfg, shape, rules = _sp_rules(case, j=True)
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    out = []
    with mesh:
        dec, place = _jit(mesh, JST.build_decode_step(jcfg, shape, mesh, rules))
        cache = j_get_model(jcfg).init_cache(b, slots, jnp.float32)
        for pos, tok in enumerate(tokens, start=p0):
            logits, cache = dec(*place(params, cache, tok.numpy(), jnp.int32(pos)))
            out.append(np.asarray(logits))
    return out


def check_sp_decode(world: list, case: str, local: dict, ref: list) -> None:
    """An SP case's records (each rank's ``["sp"][case]``) held to the
    unsharded port's and the reference's."""
    got, want = world[0]["sp"][case], local
    for r in world:
        rec = r["sp"][case]
        assert rec["local_shards"] and not any(rec["moved"]), rec["moved"]
        assert all(torch.equal(a, c) for a, c in zip(rec["decode"], got["decode"]))
    for i, (tok, logits) in enumerate(zip(got["tokens"], got["decode"])):
        assert torch.equal(tok, want["tokens"][i]), i
        _close(logits, want["decode"][i].numpy(), **TOL)
        _close(logits, ref[i], **TOL)


def _moe_inputs() -> dict:
    """Mixtral smoke's MoE weights and a batch whose tokens lean on few
    experts (a shared offset), so that the global capacity drops slots."""
    from repro_torch.configs.registry import get_smoke
    cfg = get_smoke("mixtral-8x22b")
    rng = np.random.default_rng(MOE_SEED)
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    n = lambda *shape, std: (rng.standard_normal(shape) * std).astype(np.float32)
    p = {"router": n(d, e, std=d ** -0.5), "wi": n(e, d, f, std=d ** -0.5),
         "wg": n(e, d, f, std=d ** -0.5), "wo": n(e, f, d, std=f ** -0.5)}
    x = n(MOE_B, MOE_S, d, std=1.0) + n(1, 1, d, std=1.0)
    return {"p": p, "x": x, "top_k": cfg.moe.top_k}


def moe_rank(mesh, moe: dict) -> dict:
    """Each rank's slice of the batch through ``moe_mlp`` and
    ``moe_route_global`` under a step's ``dp`` group (data)."""
    import torch.nn.functional as F
    from repro_torch.distributed.sharding import DEFAULT_RULES as R
    from repro_torch.distributed.tensor_parallel import ParamGather
    from repro_torch.models import layers as L
    p = {k: torch.from_numpy(v) for k, v in moe["p"].items()}
    d, n_d = mesh.get_coordinate()[0], mesh.size(0)
    b_l = MOE_B // n_d
    x = torch.from_numpy(moe["x"][d * b_l:(d + 1) * b_l])
    gath = ParamGather(mesh, R, tp=False)
    with gath.active():
        probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ p["router"], dim=-1)
        _, eids, _, keep, c_loc = L.moe_route_global(probs, moe["top_k"], 1.25, gath.dp)
        y, aux = L.moe_mlp(p, x, top_k=moe["top_k"])
    e = p["router"].shape[-1]
    kept = F.one_hot(eids.reshape(-1)[keep], e).sum(dim=0)
    return {"kept": kept.numpy(), "c_loc": c_loc, "aux": float(aux), "y": y.numpy()}


def _train_batch(arch: str, seed: int) -> dict:
    from repro_torch.configs.registry import get_smoke
    cfg = get_smoke(arch)
    rng = np.random.default_rng(seed)
    b, s = TRAIN_B, TRAIN_SEQ[arch]
    if cfg.family == "dit":
        nv, nt = s - cfg.n_text_tokens, cfg.n_text_tokens
        f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
        return {"latents": f(b, nv, cfg.patch_dim), "noise": f(b, nv, cfg.patch_dim),
                "patch_emb": f(b, nv, cfg.d_model), "text_emb": f(b, nt, cfg.d_model),
                "t": rng.uniform(0, 1, (b,)).astype(np.float32)}
    tok = lambda: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": tok(), "labels": tok()}


def _serve_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (SERVE_B, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (SERVE_B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _dit_inputs(cfg, b: int = DIT_B, nv: int = DIT_VISION, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"x_vision": f(b, nv, cfg.d_model),
            "text_emb": f(b, cfg.n_text_tokens, cfg.d_model),
            "t": np.array([0.3, 0.7][:b], np.float32)}


def _torch(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bf16_ulps(p: torch.Tensor, q: torch.Tensor) -> float:
    """The largest difference of bf16 ``p`` from ``q`` in units of ``q``'s
    last place (2^-7 of its binade; the least normal one at zero)."""
    qf = q.float()
    binade = torch.floor(torch.log2(qf.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)))
    return float(((p.float() - qf).abs() / torch.exp2(binade - 7)).max())


def _states_compare(a: list, b: list) -> tuple:
    """``(ints_equal, float_rel, bf16_ulps)``: whether the counters, the
    symbols and every integer plan field of ``a`` are ``torch.equal`` to
    ``b``'s; the largest difference of an f32 field (the row score) over
    that field's largest magnitude in ``b``; and the largest difference of
    a bf16 field (the TaylorSeer stack in the serving cache dtype) in its
    last place (:func:`_bf16_ulps`)."""
    ints, rel, ulps = True, 0.0, 0.0
    for x, y in zip(a, b):
        pairs = [(x.s_c, y.s_c), (x.s_s, y.s_s), (x.taylor.derivs, y.taylor.derivs)]
        pairs += [(getattr(x.plan, f), getattr(y.plan, f)) for f in x.plan._fields]
        if x.k_since != y.k_since or x.taylor.n_updates != y.taylor.n_updates:
            ints = False
        for p, q in pairs:
            if p is None or q is None:
                ints = ints and p is None and q is None
            elif q.dtype == torch.bfloat16:
                ulps = max(ulps, _bf16_ulps(p, q))
            elif p.dtype.is_floating_point:
                scale = max(float(q.float().abs().max()), 1e-30)
                rel = max(rel, float((p.float() - q.float()).abs().max()) / scale)
            else:
                ints = ints and torch.equal(p, q)
    return ints, rel, ulps


def dit_sp_rank(mesh, inputs: dict, nv: int, kv_buckets: int = 1) -> dict:
    """The DiT step at batch 1 under ``rules_for``'s DiT rules on this rank:
    Update then Dispatch, each against the unsharded port step."""
    from torch.distributed.tensor import Replicate
    from repro_torch.analysis.op_walk import index_decode_ops, record_call
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import backend
    from repro_torch.distributed.sharding import redistribute
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import rules_for
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_map
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config(kv_buckets=kv_buckets)
    n_tok = nv + cfg.n_text_tokens
    shape = ShapeSpec("d", n_tok, 1, "serve")
    rules = rules_for(cfg, shape, multi_pod=False)
    whole = lambda x: redistribute(x, [Replicate(), Replicate()]).to_local()
    params = tree_map(lambda t: t.to(torch.bfloat16), _torch(inputs["params"]["flux-mmdit"]))
    x = _torch(inputs["dit_sp_inputs"][nv])
    p = reshard_state(params, dit.param_specs(cfg), mesh, rules)
    spec = dit.engine_state_specs(cfg, ecfg)
    states = ST.place_states(dit.init_engine_states(cfg, ecfg, 1, n_tok, "cpu"), spec, mesh,
                             rules)
    stack_pl = ST._state_placements(spec, mesh, rules).taylor.derivs
    xd = reshard_state(x, S.dit_inputs_logical(cfg), mesh, rules)
    one = dit.init_engine_states(cfg, ecfg, 1, n_tok, "cpu")
    # Each plain kernel's calls and the token rows of its output.
    rows_of = {"gemm_q_sparse_kernel": lambda a: a[0].shape[1],
               "flashomni_attention_csr": lambda a: a[3].shape[1],
               "gemm_o_sparse_kernel": lambda a: a[2].shape[1]}
    kept = {name: getattr(backend, name) for name in DISPATCH_KERNELS}
    kept_dispatch, records = dit.E.dispatch_layer, []

    def recording_dispatch(*a, **kw):
        out, rec = record_call(kept_dispatch, *a, **kw)
        records.append(rec)
        return out

    out = {}
    for mode in ("update", "dispatch"):
        fn = ST.build_dit_step(cfg, shape, mesh, rules, mode=mode, ecfg=ecfg,
                               dtype=torch.float32)[0]
        calls = []
        for name in DISPATCH_KERNELS:
            setattr(backend, name, lambda *a, _n=name, **kw: calls.append(
                (_n, rows_of[_n](a))) or kept[_n](*a, **kw))
        dit.E.dispatch_layer = recording_dispatch
        try:
            v, states = fn(p, states, xd)
        finally:
            dit.E.dispatch_layer = kept_dispatch
            for name in DISPATCH_KERNELS:
                setattr(backend, name, kept[name])
        v1, one = dit.denoise_step(params, cfg, ecfg, one, x["x_vision"], x["text_emb"],
                                   x["t"], mode=mode, dtype=torch.float32)
        wholes = [ST._state_from_tree(tree_map(whole, ST._state_tree(s)), s) for s in states]
        ints_equal, float_rel, bf16_ulps = _states_compare(wholes, one)
        vw = whole(v)
        out[mode] = {"v": vw, "v_rel": float((vw - v1).abs().max()) / float(v1.abs().max()),
                     "ints_equal": ints_equal, "float_rel": float_rel, "bf16_ulps": bf16_ulps,
                     "stack_placements": [list(s.taylor.derivs.placements) for s in states]
                     == [stack_pl] * len(states),
                     "stack_tokens": [s.taylor.derivs.to_local().shape[2] for s in states],
                     "calls": calls, "sp_rows": fn.stats["sp_rows"],
                     "sp_replicated": fn.stats["sp_replicated"],
                     "tp_replicated": fn.stats["tp_replicated"],
                     "dispatch_decode_ops": sum(len(index_decode_ops(r)) for r in records)}
        records.clear()
    return out


def steps_rank(rank: int, inputs: dict) -> dict:
    """One rank of the world: every case, this rank's results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import backend
    from repro_torch.distributed.sharding import DEFAULT_RULES as R, redistribute
    from repro_torch.distributed.tensor_parallel import ParamGather
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serving_engine_config
    from repro_torch.models import dit
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_state_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves, tree_map
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(MESH), mesh_dim_names=("data", "model"))
    whole = lambda x: redistribute(x, [Replicate(), Replicate()]).to_local()
    d = mesh.get_coordinate()[0]
    out = {"train": {}, "serve": {}}

    gc.disable()                  # a step's gather must not outlive it, cycle or not
    for arch, cast, remat in TRAIN_CASES:
        cfg = dataclasses.replace(get_smoke(arch), remat=remat)
        model, rules = get_model(cfg), R
        fn, _, in_pl, out_pl = ST.build_train_step(
            cfg, ShapeSpec("t", TRAIN_SEQ[arch], TRAIN_B, "train"), mesh, rules,
            opt_cfg=AdamWConfig(**OPT), cast_params_bf16=cast, dtype=torch.float32)
        params = _torch(inputs["params"][arch])
        p = reshard_state(params, model.param_specs(), mesh, rules)
        o = reshard_state(adamw_init(params), adamw_state_specs(model.param_specs()), mesh,
                          rules)
        metrics, gathered = [], []
        for i in range(TRAIN_STEPS):
            b = reshard_state(_torch(inputs["train_batches"][arch][i]),
                              S.train_batch_logical(cfg), mesh, rules)
            p, o, m = fn(p, o, b)
            metrics.append((float(m["loss"].to_local()), float(m["grad_norm"].to_local())))
            gathered.append(fn.stats["max_gathered_bytes"])
        laid_out = all(list(x.placements) == pl for x, pl in
                       zip(*(tree_leaves(t, is_leaf=ST._is_pl) for t in (p, out_pl[0]))))
        # AdamW's first moment of the leaves replicated over model: the
        # gradients, which every rank of a row must hold alike.
        replicated = [x.to_local() for x, pl in
                      zip(tree_leaves(o["mu"]), tree_leaves(out_pl[0], is_leaf=ST._is_pl))
                      if pl[1] == Replicate()]
        bound = gather_bound(params, model.block_groups(), torch.bfloat16 if cast else None)
        out["train"][(arch, cast, remat)] = {
            "metrics": metrics, "params": tree_map(whole, p), "laid_out": laid_out,
            "local_shards": _tp_leaves_local(p, out_pl[0]),
            "step": int(o["step"].to_local()), "replicated_mu": replicated,
            "gathered": gathered, "gather_bound": bound,
            "tp_replicated": fn.stats["tp_replicated"]}
        del fn, p, o, b, m
    out["gathers_alive"] = sum(isinstance(x, ParamGather) for x in gc.get_objects())
    gc.enable()
    out["moe"] = moe_rank(mesh, inputs["moe"])

    # The DiT step: Update, then Dispatch on the states it returned.
    cfg, ecfg = get_smoke("flux-mmdit"), serving_engine_config()
    n_tok = DIT_VISION + cfg.n_text_tokens
    shape = ShapeSpec("d", n_tok, DIT_B, "serve")
    params = tree_map(lambda t: t.to(torch.bfloat16), _torch(inputs["params"]["flux-mmdit"]))
    x = _torch(inputs["dit_inputs"])
    p = reshard_state(params, dit.param_specs(cfg), mesh, R)
    spec = dit.engine_state_specs(cfg, ecfg)
    states = ST.place_states(dit.init_engine_states(cfg, ecfg, DIT_B, n_tok, "cpu"), spec,
                             mesh, R)
    xd = reshard_state(x, S.dit_inputs_logical(cfg), mesh, R)
    calls = {name: 0 for name in DISPATCH_KERNELS}
    kept = {name: getattr(backend, name) for name in DISPATCH_KERNELS}

    def counting(name):
        def run(*args, **kw):
            calls[name] += 1
            return kept[name](*args, **kw)
        return run

    compute = ST._compute_placements(ST._state_tree(spec), mesh, R)
    one = dit.init_engine_states(cfg, ecfg, 1, n_tok, "cpu")
    sl = slice(d, d + 1)
    dit_out = {}
    block_shapes = {}
    kept_block = ParamGather.block

    def recording_block(self, group, idx):
        got = kept_block(self, group, idx)
        block_shapes.update({k: tuple(t.shape) for k, t in got.items()})
        return got

    for mode in ("update", "dispatch"):
        fn, _, _, out_pl = ST.build_dit_step(cfg, shape, mesh, R, mode=mode, ecfg=ecfg,
                                             dtype=torch.float32)
        for name in DISPATCH_KERNELS:
            setattr(backend, name, counting(name))
        ParamGather.block = recording_block
        try:
            v, states = fn(p, states, xd)
        finally:
            ParamGather.block = kept_block
            for name in DISPATCH_KERNELS:
                setattr(backend, name, kept[name])
        gathered = (fn.stats["max_gathered_bytes"], gather_bound(params, dit.BLOCK_GROUPS))
        v1, one = dit.denoise_step(params, cfg, ecfg, one, x["x_vision"][sl],
                                   x["text_emb"][sl], x["t"][sl], mode=mode, dtype=torch.float32)
        local = [ST._state_from_tree(tree_map(ST._to_local, ST._state_tree(s), compute,
                                              is_leaf=ST._is_pl), s) for s in states]
        v_rel = float((v.to_local() - v1).abs().max()) / float(v1.abs().max())
        ints_equal, float_rel, bf16_ulps = _states_compare(local, one)
        dit_out[mode] = {"v": whole(v), "v_rel": v_rel, "ints_equal": ints_equal,
                         "float_rel": float_rel, "bf16_ulps": bf16_ulps,
                         "v_placements": list(v.placements) == out_pl[0],
                         "calls": dict(calls), "gathered": gathered,
                         "block_shapes": dict(block_shapes),
                         "tp_replicated": fn.stats["tp_replicated"]}
    out["dit"] = dit_out
    out["dit_sp"] = {nv: dit_sp_rank(mesh, inputs, nv) for nv in DIT_SP_VISION}
    column = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
    out["dit_sp_empty"] = dit_sp_rank(column, inputs, DIT_SP_EMPTY_VISION, DIT_SP_EMPTY_BUCKETS)

    for arch in SERVE_ARCHS:
        cfg = get_smoke(arch)
        model, rules = get_model(cfg), R
        params = _torch(inputs["params"][arch])
        p = reshard_state(params, model.param_specs(), mesh, rules)
        pre, _, _, _ = ST.build_prefill_step(cfg, ShapeSpec("p", PROMPT, SERVE_B, "prefill"),
                                             mesh, rules, dtype=torch.float32)
        dec, _, dec_pl, _ = ST.build_decode_step(
            cfg, ShapeSpec("d", MAX_LEN, SERVE_B, "decode"), mesh, rules, dtype=torch.float32)
        batch = reshard_state(_torch(inputs["serve_batches"][arch]),
                              S.prefill_batch_logical(cfg), mesh, rules)
        logits = pre(p, batch)
        bound = gather_bound(params, model.block_groups())
        rec = {"prefill": whole(logits), "decode": [], "tokens": [],
               "gathered": [(pre.stats["max_gathered_bytes"], bound)]}
        cache = reshard_state(model.init_cache(SERVE_B, MAX_LEN, torch.float32, device="cpu"),
                              model.cache_specs(), mesh, rules)
        tok = logits.to_local().argmax(-1).to(torch.int32)
        for pos in range(DECODE_STEPS):
            tok_d = ST._dtensor(tok, mesh, dec_pl[2], (SERVE_B,))
            rec["tokens"].append(whole(tok_d))
            logits, cache = dec(p, cache, tok_d, pos)
            rec["decode"].append(whole(logits))
            rec["gathered"].append((dec.stats["max_gathered_bytes"], bound))
            tok = logits.to_local().argmax(-1).to(torch.int32)
        out["serve"][arch] = rec
    out["sp"] = {case: sp_decode_rank(mesh, spec, inputs["params"][spec[0]],
                                      inputs["sp_first"][case])
                 for case, spec in SP_CASES.items()}
    out["xent"] = xent_rank(mesh)

    # Rank 1 hands in one parameter laid out otherwise than the step says.
    cfg = get_smoke("gemma3-1b")
    model = get_model(cfg)
    params = _torch(inputs["params"]["gemma3-1b"])
    p = reshard_state(params, model.param_specs(), mesh, R)
    if rank == 1:
        p["final_norm"] = reshard_state({"w": params["final_norm"]}, {"w": ("fsdp",)}, mesh,
                                        R)["w"]
    pre = ST.build_prefill_step(cfg, ShapeSpec("p", PROMPT, SERVE_B, "prefill"), mesh, R,
                                dtype=torch.float32)[0]
    batch = reshard_state(_torch(inputs["serve_batches"]["gemma3-1b"]),
                          S.prefill_batch_logical(cfg), mesh, R)
    try:
        pre(p, batch)
        out["disagree"] = None
    except ValueError as e:
        out["disagree"] = str(e)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inputs():
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    params = {a: tree_map(lambda t: t.numpy(), get_model(get_smoke(a)).init_params(
        torch.Generator().manual_seed(0), "cpu")) for a in (*TRAIN_ARCHS, *SERVE_ARCHS)}
    return {"params": params,
            "train_batches": {a: [_train_batch(a, 100 + i) for i in range(TRAIN_STEPS)]
                              for a in TRAIN_ARCHS},
            "dit_inputs": _dit_inputs(get_smoke("flux-mmdit")), "moe": _moe_inputs(),
            "dit_sp_inputs": {nv: _dit_inputs(get_smoke("flux-mmdit"), 1, nv, 12 + nv)
                              for nv in (*DIT_SP_VISION, DIT_SP_EMPTY_VISION)},
            "serve_batches": {a: _serve_batch(get_smoke(a)) for a in SERVE_ARCHS},
            "sp_first": {case: sp_first_tokens(spec, 40 + i)
                         for i, (case, spec) in enumerate(SP_CASES.items())}}


@pytest.fixture(scope="module")
def runs(inputs):
    """The world's results and the unsharded and reference runs, the latter
    computed here while the ranks run."""
    box = {}

    def run_world():
        try:
            box["world"] = run_local_mesh(steps_rank, *MESH, inputs, timeout=JOIN_S)
        except BaseException as e:                  # re-raised on the test's thread
            box["error"] = e

    thread = threading.Thread(target=run_world)
    thread.start()
    try:
        local = {"train": {a: _unsharded_train(a, inputs) for a in TRAIN_ARCHS},
                 "serve": {a: _unsharded_serve(a, inputs) for a in SERVE_ARCHS},
                 "sp": {case: unsharded_sp_decode(spec, inputs["params"][spec[0]],
                                                  inputs["sp_first"][case])
                        for case, spec in SP_CASES.items()}}
        with _f32_reference():
            ref = _references(inputs, local)
            ref["sp"] = {case: reference_sp_decode(spec, inputs["params"][spec[0]],
                                                   local["sp"][case]["tokens"])
                         for case, spec in SP_CASES.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["world"], local, ref


@contextlib.contextmanager
def _f32_reference():
    """The reference's adapters and ``denoise_step`` with ``dtype=float32``."""
    import jax.numpy as jnp
    from repro.models import dit as jdit
    from repro.models import registry as JR
    kept = {name: getattr(JR.Model, name) for name in ("train_loss", "prefill", "decode_step")}
    kept_dn = jdit.denoise_step
    JR.Model.train_loss = lambda self, p, b, **kw: kept["train_loss"](self, p, b,
                                                                      dtype=jnp.float32)
    JR.Model.prefill = lambda self, p, b, **kw: kept["prefill"](self, p, b, dtype=jnp.float32)
    JR.Model.decode_step = lambda self, p, c, t, pos, **kw: kept["decode_step"](
        self, p, c, t, pos, dtype=jnp.float32)
    jdit.denoise_step = lambda *a, **kw: kept_dn(*a, **{**kw, "dtype": jnp.float32})
    try:
        yield
    finally:
        for name, fn in kept.items():
            setattr(JR.Model, name, fn)
        jdit.denoise_step = kept_dn


def _close(got, want, **tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), **tol)


def _unsharded_train(arch, inputs):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_flatten, tree_unflatten
    model = get_model(get_smoke(arch))
    p = _torch(inputs["params"][arch])
    o, metrics = adamw_init(p), []
    for batch in inputs["train_batches"][arch]:
        leaves, tdef = tree_flatten(p)
        leaves = [t.requires_grad_(True) for t in leaves]
        loss = model.train_loss(tree_unflatten(tdef, leaves), _torch(batch), dtype=torch.float32)
        grads = tree_unflatten(tdef, torch.autograd.grad(loss, leaves))
        p, o, gnorm = adamw_update(grads, o, tree_unflatten(tdef, [t.detach() for t in leaves]),
                                   AdamWConfig(**OPT))
        metrics.append((float(loss.detach()), float(gnorm)))
    return metrics, p


@torch.no_grad()
def _unsharded_serve(arch, inputs) -> dict:
    """The port's greedy prefill and decode on the whole batch."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import get_model
    model = get_model(get_smoke(arch))
    params = _torch(inputs["params"][arch])
    logits = model.prefill(params, _torch(inputs["serve_batches"][arch]), dtype=torch.float32)
    cache = model.init_cache(SERVE_B, MAX_LEN, torch.float32, device="cpu")
    rec = {"prefill": logits, "tokens": [], "decode": []}
    for pos in range(DECODE_STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = model.decode_step(params, cache, tok, pos, dtype=torch.float32)
        rec["tokens"].append(tok)
        rec["decode"].append(logits)
    return rec


def _jit(mesh, built):
    """A reference builder's fn jitted with its own shardings, and a placer
    for its first inputs (so later calls hit the same executable)."""
    import jax
    fn, _, in_sh, out_sh = built
    return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh), \
        lambda *args: jax.device_put(args, in_sh)


def _moe_reference(moe: dict) -> dict:
    """The reference ``moe_mlp`` on the whole batch, and the slots its
    routing keeps (its own lines: top-k, running positions, ``pos < cap``)
    counted per expert on each data rank's share of the slots."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import moe_mlp
    p = {k: jnp.asarray(v) for k, v in moe["p"].items()}
    x, k = jnp.asarray(moe["x"]), moe["top_k"]
    y, aux = jax.jit(lambda p, x: moe_mlp(p, x, top_k=k))(p, x)
    n, e = MOE_B * MOE_S, p["router"].shape[-1]
    probs = jax.nn.softmax((x.reshape(n, -1) @ p["router"]).astype(jnp.float32), axis=-1)
    flat_e = jax.lax.top_k(probs, k)[1].reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = np.asarray(pos < int(1.25 * n * k / e) + 1)
    flat_e = np.asarray(flat_e)
    share = n * k // MESH[0]
    mine = lambda a, r: a[r * share:(r + 1) * share]
    kept = [np.bincount(mine(flat_e, r)[mine(keep, r)], minlength=e) for r in range(MESH[0])]
    return {"y": np.asarray(y), "aux": float(aux), "kept": kept, "dropped": int((~keep).sum())}


def _references(inputs, local) -> dict:
    """The reference builders' fns on a (1, 1) CPU mesh, on the same inputs
    (decode fed the unsharded port's greedy tokens)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeSpec as J
    from repro.configs.registry import get_smoke as j_get_smoke
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.core.masks import MaskConfig as JMaskConfig
    from repro.distributed.sharding import DEFAULT_RULES as R
    from repro.launch import steps as JST
    from repro.launch.mesh import rules_for as j_rules_for
    from repro.models import dit as jdit
    from repro.models.registry import get_model as j_get_model
    from repro.optim.optimizer import AdamWConfig, adamw_init
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    ref = {"train": {}, "serve": {}, "dit": {}}
    with mesh:
        for arch, cast in [(a, False) for a in TRAIN_ARCHS] + [("flux-mmdit", True)]:
            step, place = _jit(mesh, JST.build_train_step(
                j_get_smoke(arch), J("t", TRAIN_SEQ[arch], TRAIN_B, "train"), mesh, R,
                opt_cfg=AdamWConfig(**OPT), cast_params_bf16=cast))
            p = inputs["params"][arch]
            o, metrics = adamw_init(p), []
            for batch in inputs["train_batches"][arch]:
                p, o, m = step(*place(p, o, batch))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            ref["train"][(arch, cast)] = (metrics, jax.tree.map(np.asarray, p))

        jcfg = j_get_smoke("flux-mmdit")
        jecfg = JEngineConfig(mask=JMaskConfig(tau_q=0.5, tau_kv=0.15, interval=4, order=1,
                                               degrade=0.3, block_q=16, block_kv=16, pool=32,
                                               warmup_steps=2))
        n_tok = DIT_VISION + jcfg.n_text_tokens
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                              inputs["params"]["flux-mmdit"])
        states = jdit.init_engine_states(jcfg, jecfg, DIT_B, n_tok)
        for mode in ("update", "dispatch"):
            step, place = _jit(mesh, JST.build_dit_step(jcfg, J("d", n_tok, DIT_B, "serve"),
                                                        mesh, R, mode=mode, ecfg=jecfg))
            v, states = step(*place(params, states, inputs["dit_inputs"]))
            ref["dit"][mode] = np.asarray(v)
        ref["dit_sp"] = {}
        for nv in DIT_SP_VISION:
            n_tok = nv + jcfg.n_text_tokens
            jshape = J("d", n_tok, 1, "serve")
            jrules = j_rules_for(jcfg, jshape, multi_pod=False)
            states = jdit.init_engine_states(jcfg, jecfg, 1, n_tok)
            for mode in ("update", "dispatch"):
                step, place = _jit(mesh, JST.build_dit_step(jcfg, jshape, mesh, jrules,
                                                            mode=mode, ecfg=jecfg))
                v, states = step(*place(params, states, inputs["dit_sp_inputs"][nv]))
                ref["dit_sp"][(nv, mode)] = np.asarray(v)
        ref["moe"] = _moe_reference(inputs["moe"])

        for arch in SERVE_ARCHS:
            jcfg, jp = j_get_smoke(arch), inputs["params"][arch]
            pre, place = _jit(mesh, JST.build_prefill_step(
                jcfg, J("p", PROMPT, SERVE_B, "prefill"), mesh, R))
            rec = {"prefill": np.asarray(pre(*place(jp, inputs["serve_batches"][arch]))),
                   "decode": []}
            dec, place = _jit(mesh, JST.build_decode_step(
                jcfg, J("d", MAX_LEN, SERVE_B, "decode"), mesh, R))
            jcache = j_get_model(jcfg).init_cache(SERVE_B, MAX_LEN, jnp.float32)
            for pos, tok in enumerate(local["serve"][arch]["tokens"]):
                logits, jcache = dec(*place(jp, jcache, tok.numpy(), jnp.int32(pos)))
                rec["decode"].append(np.asarray(logits))
            ref["serve"][arch] = rec
    return ref


@pytest.mark.parametrize("arch, remat", [pytest.param(a, False, id=a) for a in TRAIN_ARCHS]
                         + [pytest.param("gemma3-1b", True, id="gemma3-1b-remat")])
def test_train_step_matches_unsharded_and_the_reference(runs, arch, remat):
    import jax
    from repro_torch.tree import tree_flatten
    world, local, ref = runs
    got = [r["train"][(arch, False, remat)] for r in world]
    assert all(g["laid_out"] and g["local_shards"] and g["step"] == TRAIN_STEPS for g in got)
    assert all(g["metrics"] == got[0]["metrics"] for g in got)
    leaves = [tree_flatten(g["params"])[0] for g in got]
    assert all(torch.equal(a, b) for other in leaves[1:] for a, b in zip(other, leaves[0]))
    un_metrics, un_params = local["train"][arch]
    ref_metrics, ref_params = ref["train"][(arch, False)]
    _close(np.array(got[0]["metrics"]), un_metrics, **TOL)
    _close(np.array(got[0]["metrics"]), ref_metrics, **TOL)
    for a, b, c in zip(leaves[0], tree_flatten(un_params)[0], jax.tree.leaves(ref_params)):
        _close(a, b, **TOL)
        _close(a, c, **TOL)


def test_train_step_with_bf16_params_matches_the_reference(runs):
    import jax
    from repro_torch.tree import tree_flatten
    world, _, ref = runs
    got = world[0]["train"][("flux-mmdit", True, False)]
    ref_metrics, ref_params = ref["train"][("flux-mmdit", True)]
    _close(np.array(got["metrics"]), ref_metrics, **BF16_TOL)
    for a, c in zip(tree_flatten(got["params"])[0], jax.tree.leaves(ref_params)):
        _close(a, c, **BF16_TOL)


def test_dit_step_is_each_ranks_slice_and_matches_the_reference(runs):
    from repro_torch.configs.registry import get_smoke
    cfg = get_smoke("flux-mmdit")
    d, m, f = cfg.d_model, MESH[1], cfg.d_ff
    hd_m = cfg.n_heads * cfg.hd // m
    shards = {"wq": (d, hd_m), "wk": (d, hd_m), "wv": (d, hd_m), "wo": (hd_m, d),
              "mlp_wi": (d, f // m), "mlp_wo": (f // m, d)}
    world, _, ref = runs
    for r in world:
        for mode in ("update", "dispatch"):
            rec = r["dit"][mode]
            assert rec["ints_equal"] and rec["v_placements"], mode
            assert rec["v_rel"] <= DIT_SLICE_REL and rec["float_rel"] <= DIT_SLICE_REL, mode
            assert rec["bf16_ulps"] <= DIT_SLICE_BF16_ULPS, mode
            _close(rec["v"], ref["dit"][mode], **DIT_TOL)
            assert {k: rec["block_shapes"][k] for k in shards} == shards, mode
            assert rec["tp_replicated"] == [], mode
        # The plain versions ran once a layer at Dispatch, never at Update.
        assert r["dit"]["update"]["calls"] == dict.fromkeys(DISPATCH_KERNELS, 0)
        assert r["dit"]["dispatch"]["calls"] == dict.fromkeys(DISPATCH_KERNELS, 3)


@pytest.mark.parametrize("nv", [pytest.param(nv, id=f"vision{nv}") for nv in DIT_SP_VISION])
def test_dit_step_computes_each_ranks_sequence_rows_and_matches_the_reference(runs, nv):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.serve import serving_engine_config
    cfg, pool = get_smoke("flux-mmdit"), serving_engine_config().mask.pool
    n_tok = nv + cfg.n_text_tokens
    n_rows, share = -(-n_tok // pool), -(-n_tok // MESH[0])
    world, _, ref = runs
    rows = []
    for r in world:
        for mode in ("update", "dispatch"):
            rec = r["dit_sp"][nv][mode]
            assert rec["ints_equal"], mode
            assert rec["v_rel"] <= DIT_SLICE_REL and rec["float_rel"] <= DIT_SLICE_REL, mode
            assert rec["bf16_ulps"] <= DIT_SLICE_BF16_ULPS, mode
            _close(rec["v"], ref["dit_sp"][(nv, mode)], **DIT_TOL)
            # The stack stays the rank's sp shard of the reference's layout.
            assert rec["stack_placements"], mode
            assert set(rec["stack_tokens"]) == {share}, mode
            assert rec["sp_replicated"] == [] and rec["tp_replicated"] == [], mode
            assert rec["dispatch_decode_ops"] == 0, mode
        lo, hi = r["dit_sp"][nv]["dispatch"]["sp_rows"]
        rows.append((lo, hi))
        tokens = min(hi * pool, n_tok) - lo * pool
        assert r["dit_sp"][nv]["update"]["calls"] == []
        calls = r["dit_sp"][nv]["dispatch"]["calls"]
        assert sorted({name for name, _ in calls}) == sorted(DISPATCH_KERNELS)
        assert all(sum(n == name for n, _ in calls) == cfg.n_layers for name in DISPATCH_KERNELS)
        # GEMM-Q reads, and B2/B3 write, the rank's rows alone.
        assert {t for _, t in calls} == {tokens}
    # The model row's two ranks compute the same rows; the data column's
    # rows tile the sequence once.
    cols = sorted(set(rows))
    assert len(cols) == MESH[0] and cols[0][0] == 0 and cols[-1][1] == n_rows
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    if nv == DIT_SP_VISION[0]:
        assert share % pool, "the first case must give a rank a partial pool row"
    else:
        assert share % pool == 0


def test_dit_step_leaves_a_rank_with_no_rows_idle(runs):
    from repro_torch.configs.registry import get_smoke
    n_rows = -(-(DIT_SP_EMPTY_VISION + get_smoke("flux-mmdit").n_text_tokens) // 32)
    world = runs[0]
    rows = [tuple(r["dit_sp_empty"]["dispatch"]["sp_rows"]) for r in world]
    assert rows == [(0, 1), (1, 2), (2, 3), (3, 3)] and n_rows == 3
    for r, (lo, hi) in zip(world, rows):
        for mode in ("update", "dispatch"):
            rec = r["dit_sp_empty"][mode]
            assert rec["ints_equal"] and rec["stack_placements"], mode
            assert rec["v_rel"] <= DIT_SLICE_REL and rec["float_rel"] <= DIT_SLICE_REL, mode
            assert rec["bf16_ulps"] <= DIT_SLICE_BF16_ULPS, mode
        calls = r["dit_sp_empty"]["dispatch"]["calls"]
        assert len(calls) == (3 * 3 if hi > lo else 0)


def test_moe_routes_the_global_batch_over_dp(runs):
    """Each rank keeps the slots the reference keeps of its share of the
    concatenated batch, and its expert buffer holds only those."""
    world, _, ref = runs
    want = ref["moe"]
    assert want["dropped"] > 0                   # the capacity binds
    b_l = MOE_B // MESH[0]
    for rank, r in enumerate(world):
        d = rank // MESH[1]
        got = r["moe"]
        np.testing.assert_array_equal(got["kept"], want["kept"][d])
        assert got["c_loc"] == max(int(got["kept"].max()), 1)
        _close(np.float32(got["aux"]), np.float32(want["aux"]), **MOE_AUX_TOL)
        _close(got["y"], want["y"][d * b_l:(d + 1) * b_l], **MOE_Y_TOL)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_unsharded_and_the_reference(runs, arch):
    world, local, ref = runs
    got, want, jref = world[0]["serve"][arch], local["serve"][arch], ref["serve"][arch]
    assert all(torch.equal(r["serve"][arch]["prefill"], got["prefill"]) for r in world)
    for pos in range(DECODE_STEPS):
        assert torch.equal(got["tokens"][pos], want["tokens"][pos]), pos
        _close(got["decode"][pos], jref["decode"][pos], **TOL)
    assert torch.equal(got["decode"][-1].argmax(-1), want["decode"][-1].argmax(-1))
    _close(got["prefill"], jref["prefill"], **TOL)


@pytest.mark.parametrize("case", SP_CASES)
def test_decode_keeps_the_cache_sequence_shard_and_matches(runs, case):
    world, local, ref = runs
    check_sp_decode(world, case, local["sp"][case], ref["sp"][case])


@pytest.mark.parametrize("arch, cast, remat", TRAIN_CASES)
def test_train_step_gathers_a_block_at_a_time_and_rows_agree(runs, arch, cast, remat):
    """At most one block whole plus the non-block leaves gathered at once;
    the gradients of the leaves replicated over model alike on both ranks of
    each row (world ranks 2d and 2d+1 form row d)."""
    world = runs[0]
    for r in world:
        rec = r["train"][(arch, cast, remat)]
        assert all(0 < n <= rec["gather_bound"] for n in rec["gathered"]), rec["gathered"]
        assert rec["tp_replicated"] == []
    for d in range(MESH[0]):
        a, b = (world[2 * d + j]["train"][(arch, cast, remat)]["replicated_mu"]
                for j in range(2))
        assert a and len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_steps_leave_no_gather_behind(runs):
    """With the cyclic gc off, no step's ParamGather (nor the parameter
    shards it holds) outlives the step."""
    assert all(r["gathers_alive"] == 0 for r in runs[0])


def test_serving_steps_gather_a_block_at_a_time(runs):
    for r in runs[0]:
        for mode in ("update", "dispatch"):
            n, bound = r["dit"][mode]["gathered"]
            assert 0 < n <= bound, (mode, n, bound)
        for arch in SERVE_ARCHS:
            assert all(0 < n <= bound for n, bound in r["serve"][arch]["gathered"]), arch


def test_vocab_parallel_xent_matches_the_whole_vocab(runs):
    for r in runs[0]:
        got, want = r["xent"]["loss"]
        _close(np.float32(got), np.float32(want), **XENT_TOL)
        g, w = r["xent"]["grad"]
        _close(g, w.numpy(), **XENT_TOL)


def test_ranks_that_disagree_on_a_placement_all_raise(runs):
    for r in runs[0]:
        assert r["disagree"] is not None
        assert "disagree with the step's placements" in r["disagree"]
        assert "1:" in r["disagree"] and "0:" not in r["disagree"]
