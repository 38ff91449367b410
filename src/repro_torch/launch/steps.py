"""Sharded step builders, port of ``repro.launch.steps``.

Every builder returns the reference's 4-tuple ``(fn, in_shapes,
in_placements, out_placements)``: ``in_shapes`` are trees of ``meta``
tensors (the reference's ``ShapeDtypeStruct``s), and the placement trees,
one DTensor placement list a tensor over a named ``DeviceMesh``
(:func:`~repro_torch.distributed.sharding.named_sharding_tree` of the
models' logical specs under ``rules``, the reference's ``NamedSharding``
trees).  ``fn`` takes DTensors laid out by ``in_placements`` and returns
DTensors laid out by ``out_placements``; it is collective over the world,
every rank calls it with its own shards.

Where the reference hands the whole step to GSPMD, ``fn`` moves the data
itself and runs the model on plain local tensors:

  * the parameters are gathered one block at a time
    (:class:`~repro_torch.distributed.tensor_parallel.ParamGather`): the
    leaves outside the block stacks (embeddings, head, final norms, the
    DiT's ``t_mlp*``/``final_*``) once, up front; each block's slice of the
    stacks when the model takes that block (``layers.block``), freed when the
    model drops it.  ``cast_params_bf16`` casts the shards before they move;
  * every input with a batch dim keeps its ``dp`` sharding and is gathered
    on every other dim, so each rank computes its own slice of the batch;
  * the results are laid out by ``out_placements`` from that layout.  In the
    train step each block's gradient is averaged over the ``dp`` mesh dims
    (an all-reduce, which outruns ``gloo``'s reduce-scatter on one host) and
    cut to the rank's shard as soon as backward produces it; autograd keeps
    handles, not gathered blocks, and backward gathers a block again where
    it needs its weights (under ``cfg.remat`` the checkpoint's recompute
    does).  AdamW runs on each rank's shards with the norm of the whole
    gradient tree.

**The ``model`` axis.**  Every family splits it as the reference's specs
do (Megatron-style, see :mod:`~repro_torch.distributed.tensor_parallel`):
a block keeps its ``tp`` shards after the gather, which gathers the
``fsdp`` dims only, and the decode step computes in the cache's own layout
(the recurrent states of ssm and hybrid stay the rank's heads or channels;
see **the ``sp`` shard** below).  The decoder-only transformers (``dense``,
``moe``; :mod:`repro_torch.models.transformer`) split attention by heads
and the MLP (or each expert) column- then row-parallel; the vlm's self
blocks are theirs, its gated cross layer splits by heads
(:mod:`repro_torch.models.vision`); the hybrid's recurrent blocks split by
channel, its local attention and MLP as the transformer's
(:mod:`repro_torch.models.rglru`); the encdec's three attentions split by
heads, its biased MLP column- then row-parallel
(:mod:`repro_torch.models.encdec`); the ssm splits by SSD heads, its packed
``in_proj``/``conv`` gathered over the row and cut to the rank's columns
(:mod:`repro_torch.models.ssm`).  The DiT's head-parallel engine runs a
rank's heads (B1 on its ``wq`` columns, B2 on its heads, B3 over its head
range, the partials summed over the row; see
:mod:`repro_torch.core.engine`), its MLP column- then row-parallel.  A
head count the row does not divide is split unevenly, as
``torch.tensor_split`` splits it (:func:`~repro_torch.distributed.
tensor_parallel.heads`); a row of more ranks than heads, or a ``d_ff`` or
channel count the row does not divide, is computed replicated and named in
``fn.stats["tp_replicated"]``.

**The ``dp`` group.**  Every builder's :class:`~repro_torch.distributed.
tensor_parallel.ParamGather` carries the group of ranks over which the
batch is split, for what the model computes over the global batch: the
MoE routes each rank's tokens as part of the global batch (capacity, slot
positions and load-balancing loss; :func:`repro_torch.models.layers.
moe_route_global`), as the reference's GSPMD step does.

**The ``sp`` shard.**  The decode step keeps each rank's shard of every
cache whose sequence its spec puts on ``sp`` (over ``model`` in
``rules_for``'s decode rules, over ``data`` and ``model`` in the batch-1
``long_500k`` ones), as the reference's GSPMD step does: the step's
:class:`~repro_torch.distributed.tensor_parallel.ParamGather` carries the
``sp`` group and each such cache's global length, the new token's K/V are
written on the rank that holds its slot (the slot and the live length from
the global length), and each rank attends every query head to its own
slots, the partial outputs merged by their log-sum-exps over the group
(:func:`repro_torch.models.transformer._cache_attention`).  The cross
caches (``dp`` only) and the ssm's states hold no ``sp`` dim.  Nothing of
the cache moves: ``fn.stats["cache_moved_bytes"]`` is 0.

Every move goes through
:func:`~repro_torch.distributed.sharding.redistribute` (on a ``gloo``
world of card tensors, where DTensor's own collectives crash, between the
ranks' tensors on one host or staged through the host), and DTensors are
built from local tensors with
``DTensor.from_local``; no DTensor op that would insert a collective runs.
The models see local tensors, so the ``constrain`` hints that
:func:`~repro_torch.distributed.ctx.activation_rules` installs are the
identity inside them.  Before anything moves, the ranks exchange what they
were given (one small all-gather of objects over the world) and every rank
raises if any rank's inputs are not laid out as ``in_placements`` says, so
a disagreement fails loudly instead of hanging a collective.  There is no
fallback: a rank computes on its tensors' device, the card on a card run.

Each ``fn`` carries ``fn.stats``, the seconds of its last call split into
gathering the non-block leaves and the inputs (``gather_s``), the model
with its per-block gathers (and, in the train step, its backward and the
per-block gradient reduction: ``compute_s``) and laying the results out
(``scatter_s``; for the train step also ``update_s``), the bytes it moved:
staged through the host (``staged_bytes``) and copied from the peers on
one host (``peer_bytes``), the most bytes of gathered parameters alive at
once (``max_gathered_bytes``), the layers a split ``model`` row computed
replicated (``tp_replicated``: a head count or ``d_ff`` the row does not
divide) and, for the decode step, the bytes of cache it gathered or
scattered (``cache_moved_bytes``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.engine import EngineConfig, LayerState
from repro_torch.core.plan import DispatchPlan
from repro_torch.core.taylorseer import TaylorState
from repro_torch.distributed.ctx import activation_rules
from repro_torch.distributed.sharding import (PartitionSpec, ShardingRules, named_sharding_tree,
                                              placements, redistribute)
from repro_torch.distributed.tensor_parallel import ParamGather, _dtensor, _same_layout, mesh_dims
from repro_torch.launch import specs as S
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizer import AdamWConfig, adamw_state_specs, adamw_update
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step", "build_dit_step",
           "eval_shape_tree", "adamw_init_from_shapes", "default_dit_engine_config",
           "place_states"]


def eval_shape_tree(fn, *args):
    """``fn(*args)`` on ``meta`` tensors: the shapes and dtypes of its
    outputs, nothing computed or allocated."""
    bad = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor) and not t.is_meta]
    if bad:
        raise ValueError(f"eval_shape_tree takes meta tensors; got one on {bad[0].device}")
    return fn(*args)


def adamw_init_from_shapes(params_shape: Any, opt_cfg: AdamWConfig = AdamWConfig()) -> Any:
    """AdamW's initial state for ``params_shape`` as ``meta`` tensors."""
    dt = getattr(torch, opt_cfg.moment_dtype)
    zeros = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return {"mu": tree_map(zeros, params_shape), "nu": tree_map(zeros, params_shape),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _bf16(tree: Any) -> Any:
    return tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, tree)


def _bf16_params_shape(model) -> Any:
    return _bf16(model.init_params(None, "meta"))


# ---------------------------------------------------------------------------
# Engine states: a LayerState as a dict tree (the tree helpers keep
# NamedTuples whole); the host-int counters ride beside it.
# ---------------------------------------------------------------------------

def _state_tree(st: LayerState) -> dict:
    return {"s_c": st.s_c, "s_s": st.s_s, "derivs": st.taylor.derivs,
            "plan": {f: getattr(st.plan, f) for f in DispatchPlan._fields}}


def _state_from_tree(tree: dict, like: LayerState) -> LayerState:
    return LayerState(s_c=tree["s_c"], s_s=tree["s_s"],
                      taylor=TaylorState(tree["derivs"], like.taylor.n_updates),
                      k_since=like.k_since, plan=DispatchPlan(**tree["plan"]))


def _state_placements(spec: LayerState, mesh, rules: ShardingRules) -> LayerState:
    pl = named_sharding_tree(_state_tree(spec), mesh, rules)
    scalar = placements(PartitionSpec(), mesh)
    return LayerState(s_c=pl["s_c"], s_s=pl["s_s"], taylor=TaylorState(pl["derivs"], scalar),
                      k_since=scalar, plan=DispatchPlan(**pl["plan"]))


def place_states(states: list, spec: LayerState, mesh, rules: ShardingRules) -> list:
    """Whole per-layer engine states (the same on every rank) as DTensors
    laid out by ``spec`` (``dit.engine_state_specs``), through
    :func:`~repro_torch.runtime.elastic.reshard_state` (each rank keeps its
    own slice; nothing moves)."""
    from repro_torch.runtime.elastic import reshard_state
    spec_tree = _state_tree(spec)
    return [_state_from_tree(reshard_state(_state_tree(s), spec_tree, mesh, rules), s)
            for s in states]


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _is_pl(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(x, list) and bool(x) and all(isinstance(p, Placement) for p in x)


def _compute_spec(spec: tuple, keep: tuple = ("dp",)) -> tuple:
    """The layout a step computes in: the dims named in ``keep`` (the batch
    dim's ``dp``; a split row's ``tp``) keep their axis, every other dim
    whole."""
    return tuple(e if e in keep else None for e in spec)


def _logical(x) -> bool:
    """``x`` is one tensor's logical spec (a leaf of a spec tree)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _compute_placements(spec_tree: Any, mesh, rules: ShardingRules,
                        keep: tuple = ("dp",)) -> Any:
    return named_sharding_tree(tree_map(lambda s: _compute_spec(s, keep), spec_tree,
                                        is_leaf=_logical), mesh, rules)


def _to_local(x, pl) -> torch.Tensor:
    """The local tensor of DTensor ``x`` laid out as ``pl``."""
    if _same_layout(x.placements, pl, x.device_mesh):
        return x.to_local()
    return redistribute(x, pl).to_local()


def _from_local(local: torch.Tensor, mesh, pl_local, pl_out, shape):
    """The DTensor of global ``shape`` whose local tensor, laid out as
    ``pl_local``, is ``local``, laid out as ``pl_out``."""
    if _same_layout(pl_local, pl_out, mesh):
        return _dtensor(local, mesh, pl_out, shape)
    return redistribute(_dtensor(local, mesh, pl_local, shape), pl_out)


def _global_shape(local: torch.Tensor, pl, mesh) -> tuple:
    """The global shape of an evenly sharded ``local`` laid out as ``pl``."""
    from torch.distributed.tensor import Shard
    shape = list(local.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return tuple(shape)


def _dp_dims(mesh, rules: ShardingRules) -> tuple:
    return mesh_dims(mesh, rules, "dp")


def _splits_model(mesh, rules: ShardingRules) -> bool:
    """Whether the step splits the ``model`` axis: the mesh's ``tp`` dims
    hold more than one rank (every family splits it)."""
    return math.prod(mesh.size(i) for i in mesh_dims(mesh, rules, "tp")) > 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_layout(name: str, args: tuple, pls: tuple, mesh) -> None:
    """Raise on every rank unless every rank's ``args`` are DTensors on
    ``mesh`` laid out as ``pls`` (collective over the world)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    faults = []
    for arg, pl_tree in zip(args, pls):
        leaves = tree_leaves(arg)
        want = tree_leaves(pl_tree, is_leaf=_is_pl)
        if len(leaves) != len(want):
            faults.append(f"{len(leaves)} leaves where the layout has {len(want)}")
            continue
        for i, (x, pl) in enumerate(zip(leaves, want)):
            if not isinstance(x, torch.Tensor):
                continue
            if not isinstance(x, DTensor) or x.device_mesh != mesh:
                faults.append(f"leaf {i} is not a DTensor on the step's mesh")
            elif tuple(x.placements) != tuple(pl):
                faults.append(f"leaf {i} is laid out {list(x.placements)}, not {pl}")
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, faults[:3])
    wrong = {r: f for r, f in enumerate(seen) if f}
    if wrong:
        raise ValueError(f"{name}: ranks' inputs disagree with the step's placements: {wrong}")


class _Stats:
    """Seconds by phase and host-staged bytes of one call."""

    def __init__(self, device: torch.device):
        self.device, self.t = device, time.perf_counter()
        self.bytes0 = (redistribute.staged_bytes, redistribute.peer_bytes)
        self.out: dict = {}

    def lap(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now

    def done(self, fn, gath: ParamGather) -> None:
        self.out["staged_bytes"] = redistribute.staged_bytes - self.bytes0[0]
        self.out["peer_bytes"] = redistribute.peer_bytes - self.bytes0[1]
        self.out.update(gath.stats())
        fn.stats = self.out


def _device_of(tree: Any) -> torch.device:
    return next(t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)).device


# ---------------------------------------------------------------------------
# Train step (FSDP)
# ---------------------------------------------------------------------------

def build_train_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules, *,
                     opt_cfg: AdamWConfig = AdamWConfig(), cast_params_bf16: bool = False,
                     dtype: torch.dtype = torch.bfloat16):
    """The FSDP train step ``fn(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm"})``.  ``cast_params_bf16`` casts the f32
    shards to bf16 before the gather (half the gather's bytes), as the
    reference's lever does; the gradients come back in f32.  ``dtype`` is
    the model's compute dtype (``make_step_fn``'s)."""
    from torch.distributed.tensor import Partial, Replicate
    model = get_model(cfg)
    p_specs = model.param_specs()
    o_specs = adamw_state_specs(p_specs)
    b_specs = S.train_batch_logical(cfg)
    p_pl = named_sharding_tree(p_specs, mesh, rules)
    o_pl = named_sharding_tree(o_specs, mesh, rules)
    b_pl = named_sharding_tree(b_specs, mesh, rules)
    b_compute = _compute_placements(b_specs, mesh, rules)
    scalar = placements(PartitionSpec(), mesh)
    m_pl = {"loss": scalar, "grad_norm": scalar}
    dp = _dp_dims(mesh, rules)
    n_dp = math.prod(mesh.size(i) for i in dp)
    split = _splits_model(mesh, rules)
    partial_on = lambda dims: [Partial("sum") if i in dims else Replicate()
                               for i in range(mesh.ndim)]

    def reduced(value: torch.Tensor, dims) -> torch.Tensor:
        """``value`` summed over the mesh dims ``dims``, one dim at a time."""
        for i in dims:
            value = redistribute(_dtensor(value, mesh, partial_on((i,)), value.shape),
                                 scalar).to_local()
        return value

    def train_step(params, opt_state, batch):
        _check_layout("train_step", (params, opt_state, batch), (p_pl, o_pl, b_pl), mesh)
        stats = _Stats(_device_of(params))
        # The gradients (each over n_dp, summed over dp) land in gath.grads
        # as the rank's shards while backward runs, block by block.
        gath = ParamGather(mesh, rules, tp=split, cast_bf16=cast_params_bf16, train=True,
                           n_dp=n_dp)
        tree = gath.prepare(params, model.block_groups())
        local_batch = tree_map(_to_local, batch, b_compute, is_leaf=_is_pl)
        stats.lap("gather_s")
        with activation_rules(rules), gath.active():
            loss = model.train_loss(tree, local_batch, dtype=dtype)
            del tree, local_batch
            torch.autograd.grad(loss, gath.anchor)
        stats.lap("compute_s")
        # The mean over dp of each rank's mean loss (the same on every rank
        # of a model row).
        flat_pl = tree_leaves(p_pl, is_leaf=_is_pl)
        _, tdef = tree_flatten(params)
        shards = gath.take_grads()
        loss = reduced(loss.detach().to(torch.float32) / n_dp, dp)
        # Each shard counts once: on the mesh dims where its parameter is
        # replicated, only the rank at coordinate 0 adds it.
        coord = mesh.get_coordinate()
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for s, pl in zip(shards, flat_pl):
            if all(c == 0 for c, q in zip(coord, pl) if q == Replicate()):
                sq = sq + s.to(torch.float32).square().sum()
        gnorm = torch.sqrt(reduced(sq, range(mesh.ndim)))
        stats.lap("scatter_s")
        local = lambda t: tree_map(lambda x: x.to_local(), t)
        new_p, new_o, gnorm = adamw_update(tree_unflatten(tdef, shards), local(opt_state),
                                           local(params), opt_cfg, gnorm=gnorm)
        del shards
        wrap = lambda new, like, pl: _dtensor(new, mesh, pl, like.shape)
        new_p = tree_map(wrap, new_p, params, p_pl, is_leaf=_is_pl)
        new_o = tree_map(wrap, new_o, opt_state, o_pl, is_leaf=_is_pl)
        metrics = {"loss": _dtensor(loss, mesh, scalar, ()),
                   "grad_norm": _dtensor(gnorm, mesh, scalar, ())}
        stats.lap("update_s")
        stats.done(train_step, gath)
        return new_p, new_o, metrics

    train_step.stats = {}
    params_shape = model.init_params(None, "meta")
    opt_shape = adamw_init_from_shapes(params_shape, opt_cfg)
    batch_shape = S.train_batch(cfg, shape)
    return (train_step, (params_shape, opt_shape, batch_shape), (p_pl, o_pl, b_pl),
            (p_pl, o_pl, m_pl))


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def build_prefill_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules, *,
                       dtype: torch.dtype = torch.bfloat16):
    """``fn(params, batch) -> logits`` (last token, ``(B, vocab)``, batch
    over ``dp``; the vocab dim replicated, as published vocabs do not divide
    the model axis).  Parameters in bf16."""
    model = get_model(cfg)
    p_pl = named_sharding_tree(model.param_specs(), mesh, rules)
    b_specs = S.prefill_batch_logical(cfg)
    b_pl = named_sharding_tree(b_specs, mesh, rules)
    b_compute = _compute_placements(b_specs, mesh, rules)
    out_pl = placements(PartitionSpec(rules.physical("dp"), None), mesh)
    logits_local = _compute_placements(("dp", None), mesh, rules)
    split = _splits_model(mesh, rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        _check_layout("prefill_step", (params, batch), (p_pl, b_pl), mesh)
        stats = _Stats(_device_of(params))
        gath = ParamGather(mesh, rules, tp=split)
        tree = gath.prepare(params, model.block_groups())
        local_batch = tree_map(_to_local, batch, b_compute, is_leaf=_is_pl)
        stats.lap("gather_s")
        with activation_rules(rules), gath.active():
            logits = model.prefill(tree, local_batch, dtype=dtype)
        del tree
        stats.lap("compute_s")
        out = _from_local(logits, mesh, logits_local, out_pl,
                          _global_shape(logits, logits_local, mesh))
        stats.lap("scatter_s")
        stats.done(prefill_step, gath)
        return out

    prefill_step.stats = {}
    in_shapes = (_bf16_params_shape(model), S.prefill_batch(cfg, shape))
    return prefill_step, in_shapes, (p_pl, b_pl), out_pl


def _sp_lengths(cache, c_specs: dict) -> dict:
    """The global slot count of each cache whose spec puts its sequence on
    ``sp``, by its top-level key, read from the cache's DTensors (so an
    ``sp`` group that does not divide a length is laid out as given)."""
    out = {}
    for key, spec in c_specs.items():
        for x, leaf in zip(tree_leaves(cache[key]), tree_leaves(spec, is_leaf=_logical)):
            if "sp" in leaf:
                out[key] = x.shape[leaf.index("sp")]
    return out


def build_decode_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules, *,
                      dtype: torch.dtype = torch.bfloat16):
    """``fn(params, cache, token, pos) -> (logits, cache)``: one token for
    the batch at write position ``pos`` (an int, or a 0-dim tensor), the
    cache laid out by ``cache_specs`` and computed in that layout, so
    nothing of it moves: its ``dp``, ``tp`` and ``sp`` shards stay on their
    ranks (on a split row the ``tp`` dims stay sharded; a cache whose
    sequence is split over ``sp`` keeps each rank's slots, the new token's
    K/V written on the rank that holds its slot and the attention merged
    over the ``sp`` group, :func:`repro_torch.models.transformer.
    _cache_attention`), its K/V written in place.  The logits ``(dp,
    None)``.  Parameters in bf16.  ``fn.stats["cache_moved_bytes"]`` is the
    bytes of cache the call gathered or scattered."""
    model = get_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    c_specs = model.cache_specs()
    p_pl = named_sharding_tree(model.param_specs(), mesh, rules)
    c_pl = named_sharding_tree(c_specs, mesh, rules)
    split = _splits_model(mesh, rules)
    c_compute = _compute_placements(c_specs, mesh, rules, keep=("dp", "tp", "sp"))
    t_pl = placements(PartitionSpec(rules.physical("dp")), mesh)
    t_compute = _compute_placements(("dp",), mesh, rules)
    s_pl = placements(PartitionSpec(), mesh)
    logits_pl = placements(PartitionSpec(rules.physical("dp"), None), mesh)
    logits_local = _compute_placements(("dp", None), mesh, rules)

    @torch.no_grad()
    def decode_step(params, cache, token, pos):
        _check_layout("decode_step", (params, cache, token), (p_pl, c_pl, t_pl), mesh)
        stats = _Stats(_device_of(params))
        gath = ParamGather(mesh, rules, tp=split, sp_lengths=_sp_lengths(cache, c_specs))
        tree = gath.prepare(params, model.block_groups())
        local_cache = tree_map(_to_local, cache, c_compute, is_leaf=_is_pl)
        stats.out["cache_moved_bytes"] = 2 * sum(
            t.numel() * t.element_size()
            for x, t, pl in zip(tree_leaves(cache), tree_leaves(local_cache),
                                tree_leaves(c_compute, is_leaf=_is_pl))
            if not _same_layout(x.placements, pl, mesh))
        tok = _to_local(token, t_compute)
        stats.lap("gather_s")
        with activation_rules(rules), gath.active():
            logits, new_cache = model.decode_step(tree, local_cache, tok, int(pos), dtype=dtype)
        del tree
        stats.lap("compute_s")
        logits = _from_local(logits, mesh, logits_local, logits_pl,
                             _global_shape(logits, logits_local, mesh))
        new_cache = tree_map(lambda x, like, pl_l, pl: _from_local(x, mesh, pl_l, pl, like.shape),
                             new_cache, cache, c_compute, c_pl, is_leaf=_is_pl)
        stats.lap("scatter_s")
        stats.done(decode_step, gath)
        return logits, new_cache

    decode_step.stats = {}
    in_shapes = (_bf16_params_shape(model),
                 model.init_cache(b, s, device="meta"),
                 torch.empty((b,), dtype=torch.int32, device="meta"),
                 torch.empty((), dtype=torch.int32, device="meta"))
    return decode_step, in_shapes, (p_pl, c_pl, t_pl, s_pl), (logits_pl, c_pl)


def default_dit_engine_config() -> EngineConfig:
    """The reference builder's engine config when none is given."""
    from repro_torch.core.masks import MaskConfig
    return EngineConfig(mask=MaskConfig(tau_q=0.5, tau_kv=0.15, interval=5, order=1,
                                        degrade=0.3, block_q=64, block_kv=64, pool=256),
                        cap_q_frac=0.6, cap_kv_frac=0.9)


def build_dit_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules, *,
                   mode: str = "dispatch", ecfg: Optional[EngineConfig] = None,
                   dtype: torch.dtype = torch.bfloat16):
    """One diffusion denoise step, ``fn(params, states, inputs) -> (v,
    new_states)``: ``states`` one :class:`LayerState` a layer, laid out by
    ``dit.engine_state_specs``; ``v`` ``(dp, sp, None)``.  Each rank runs
    ``dit.denoise_step`` on its ``dp`` slice with the bf16 weights gathered
    a block at a time.  On a ``model`` row of more than one rank a block
    keeps its ``tp`` shards and each rank computes its share of the heads
    and of the MLP (:mod:`repro_torch.models.dit`); the symbols and the
    plan are built from every head's masks on every rank, so the states
    stay replicated over ``model``, as ``dit.engine_state_specs`` lays them
    out.  With ``kv_buckets > 1`` a split row runs the uniform B2/B3 on its
    heads (the bucketed layout rows fold the heads; the plan's
    ``kv_row_cnt``/``head_cnt`` carry the bucket clamp, so the result is
    the same).  In ``mode="dispatch"`` that goes through the engine's
    backend, so the kernels (B1-B3) launch on the card.

    **The ``sp`` shard** (``rules_for``'s DiT rules put ``sp`` over
    ``data``): each rank of an ``sp`` group computes only its own whole
    ``pool`` rows of the concatenated sequence ``[text; vision]``
    (:class:`~repro_torch.distributed.tensor_parallel._SeqShare`).  The rule:
    **a pool row belongs to the rank whose share of the reference's
    ``("dp", "sp", None)`` layout of the sequence holds the row's first
    token**, so the text rows sit on the first rank(s), no row is computed on
    two ranks, and a rank's rows differ from its share of the sequence by
    less than a row at each end.  The rank's rows go through the modulation,
    the norms, the MLP, Q/K/V, the attention outputs, GEMM-Q, GEMM-O and
    the TaylorSeer stack; K and V (and, at Update, Q for the strategy) are
    all-gathered over the group, so every rank packs the same symbols and
    builds the same plan, replicated over ``sp`` as the specs say.  Dispatch
    runs B1-B3 on the rank's share of the frozen plan
    (:func:`~repro_torch.distributed.plan_shard.seq_plan`: count and slice,
    no sort), the uniform B2/B3 as on a split row.  ``x_vision`` arrives,
    the TaylorSeer stack arrives and leaves, and ``v`` leaves in the specs'
    layouts (torch's chunking over the group); only the tokens between a
    rank's share and its rows move (one all-to-all), and no rank holds the
    stack whole.  ``fn.stats`` adds ``sp_rows`` (the rank's ``[lo, hi)``
    pool rows), ``sp_replicated`` (rows computed on more than one rank:
    none under this rule) and ``sp_moved_bytes`` (the bytes of inputs, stack
    and ``v`` this rank received in those moves)."""
    from repro_torch.models import dit as ditmod
    ecfg = default_dit_engine_config() if ecfg is None else ecfg
    st_spec = ditmod.engine_state_specs(cfg, ecfg)
    in_specs = S.dit_inputs_logical(cfg)
    keep = ("dp", "sp")
    p_pl = named_sharding_tree(ditmod.param_specs(cfg), mesh, rules)
    st_pl = [_state_placements(st_spec, mesh, rules)] * cfg.n_layers
    st_tree_pl = _state_tree(st_pl[0])
    st_compute = _compute_placements(_state_tree(st_spec), mesh, rules, keep=keep)
    in_pl = named_sharding_tree(in_specs, mesh, rules)
    in_compute = _compute_placements(in_specs, mesh, rules, keep=keep)
    v_pl = placements(PartitionSpec(rules.physical("dp"), rules.physical("sp"), None), mesh)
    v_local = _compute_placements(("dp", "sp", None), mesh, rules, keep=keep)
    split = _splits_model(mesh, rules)
    tok_dim = st_spec.taylor.derivs.index("sp")       # the stack's token dim

    @torch.no_grad()
    def step(params, states, inputs):
        _check_layout("dit_step", (params, [_state_tree(s) for s in states], inputs),
                      (p_pl, [st_tree_pl] * len(states), in_pl), mesh)
        stats = _Stats(_device_of(params))
        b, n_vis = inputs["x_vision"].shape[:2]
        n_text = inputs["text_emb"].shape[1]
        gath = ParamGather(mesh, rules, tp=split, seq=(n_text + n_vis, ecfg.mask.pool))
        share = gath.seq
        tree = gath.prepare(params, ditmod.BLOCK_GROUPS)
        x = {k: _to_local(inputs[k], in_compute[k]) for k in inputs}
        local_states = []
        for s in states:
            st = tree_map(_to_local, _state_tree(s), st_compute, is_leaf=_is_pl)
            if share is not None:
                st["derivs"] = share.exchange(st["derivs"], tok_dim, share.layout, share.tokens)
            local_states.append(_state_from_tree(st, s))
        if share is not None:
            x["x_vision"] = share.exchange(x["x_vision"], 1, share.grp.spans(n_vis),
                                           share.vision(n_text))
        stats.lap("gather_s")
        with activation_rules(rules), gath.active():
            v, new_states = ditmod.denoise_step(tree, cfg, ecfg, local_states, x["x_vision"],
                                                x["text_emb"], x["t"], mode=mode, dtype=dtype)
        del tree
        stats.lap("compute_s")
        if share is not None:
            v = share.exchange(v, 1, share.vision(n_text), share.grp.spans(n_vis))
        v = _from_local(v, mesh, v_local, v_pl, (b, n_vis, v.shape[-1]))
        out_states = []
        for st, like in zip(new_states, states):
            tree = _state_tree(st)
            if share is not None:
                tree["derivs"] = share.exchange(tree["derivs"], tok_dim, share.tokens,
                                                share.layout)
            tree = tree_map(lambda y, l, pl_l, pl: _from_local(y, mesh, pl_l, pl, l.shape),
                            tree, _state_tree(like), st_compute, st_tree_pl, is_leaf=_is_pl)
            out_states.append(_state_from_tree(tree, st))
        stats.lap("scatter_s")
        n_rows = -(-(n_text + n_vis) // ecfg.mask.pool)
        rows = [(0, n_rows)] if share is None else share.rows
        owners = [sum(r0 <= r < r1 for r0, r1 in rows) for r in range(n_rows)]
        stats.out["sp_rows"] = list(rows[0 if share is None else share.rank])
        stats.out["sp_replicated"] = [r for r, c in enumerate(owners) if c > 1]
        stats.out["sp_moved_bytes"] = 0 if share is None else share.moved_bytes
        stats.done(step, gath)
        return v, out_states

    step.stats = {}
    model_shape = _bf16(ditmod.init_params(cfg, None, "meta"))
    states_shape = ditmod.init_engine_states(cfg, ecfg, shape.global_batch, shape.seq_len,
                                             "meta")
    in_shapes = (model_shape, states_shape, S.dit_inputs(cfg, shape))
    return step, in_shapes, (p_pl, st_pl, in_pl), (v_pl, st_pl)
