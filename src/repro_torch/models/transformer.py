"""Decoder-only transformer LM (dense / MoE / local:global patterns), port of
``repro.models.transformer``.

Covers gemma3-1b/12b (5:1 local:global GQA), granite-8b, llama3-405b,
mixtral-8x22b (MoE + SWA) and granite-moe-3b-a800m (MoE top-8).  Mixed
local/global patterns are cycle-grouped as in the reference: ``locals``
stacked ``(n_cyc, n_loc, ...)``, ``globals`` ``(n_cyc, ...)`` and ``tail``
``(n_tail, ...)``; the reference's ``lax.scan`` over them is a Python loop
over the stacked leading dims here, in the same layer order.  Local layers
take the banded :func:`layers.local_attention` when the sequence is longer
than twice the window, and ring-buffer KV caches of length ``window`` at
decode.

``cfg.remat`` recomputes each block in the backward pass, as the
reference's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)`` of
the block body does (:func:`remat`; every LM family wraps the same bodies
the reference wraps).  The policy maps onto PyTorch's selective activation
checkpoint (``torch.utils.checkpoint`` with ``use_reentrant=False`` and
``create_selective_checkpoint_contexts``): a dot with no batch dimension
is a weight product, which reaches autograd as ``aten.mm`` (``x @ W`` on a
flattened ``(B·S, d)`` view) or ``aten.addmm`` (with a bias), and those
outputs are saved; every other op, ``aten.bmm`` of the attention scores
and the MoE's per-expert products included, is recomputed.  Remat changes
memory, not values: the loss and the gradients are the same bits with it
on or off.  It acts only where grad mode is on, so prefill and decode (no
grad) never take it.

``param_specs`` and ``cache_specs`` are the reference's logical sharding
specs, one tuple of axis names a tensor dim, leaf for leaf with
``init_params`` and ``init_cache``; :mod:`repro_torch.launch.steps` lays the
parameters and caches out by them.  The reference's ``constrain(...)``
calls are dropped: the step builders run the model on each rank's local
tensors, where :func:`repro_torch.distributed.ctx.constrain` is the
identity.

**Tensor parallelism.**  Inside a sharded step that splits the ``model``
axis (:class:`~repro_torch.distributed.tensor_parallel.ParamGather` with
``tp``), a block's ``tp`` leaves are the rank's shards and the operators of
:mod:`~repro_torch.distributed.tensor_parallel` act over the row: each
sublayer's input passes *f* (``tp.copy``) before its norm; ``wq`` is
column-parallel by heads and ``wo`` row-parallel, followed by *g*
(``tp.reduce``), the heads split as ``torch.tensor_split`` splits them
(unevenly where the row does not divide them: the weights gathered over
the row and cut to the rank's whole heads); K/V are projected
whole on every rank (their weights gathered; the caches stay whole over
``model``) and each rank's query heads read the K/V heads they group with;
the MLP (and each MoE expert) is column-parallel in ``wi``/``wg`` and
row-parallel in ``wo``, the router replicated; the embedding is a
vocab-parallel lookup, the head keeps the logits as ``(tokens, vocab/tp)``
for :func:`layers.softmax_xent`'s vocab-parallel loss, and prefill and
decode gather the last row whole.  A row of more ranks than heads, or a
``d_ff`` that the row does not divide, is gathered and computed replicated
(``tp.note`` records it).  Outside such a step the row has one rank and
every operator is the identity, so the code computes exactly as before.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

__all__ = ["layer_groups", "init_params", "param_specs", "forward", "train_loss",
           "init_cache", "cache_specs", "decode_step", "prefill", "remat", "remat_policy"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("locals", "globals", "tail")


# ---------------------------------------------------------------------------
# Remat: the counterpart of jax.checkpoint(dots_with_no_batch_dims_saveable)
# ---------------------------------------------------------------------------

_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the weight products (``aten.mm``, ``aten.addmm``), recompute
    everything else."""
    if op in _WEIGHT_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts():
    return create_selective_checkpoint_contexts(remat_policy)


def _resolving(fn):
    """``fn`` with each :class:`~repro_torch.models.layers.BlockRef`
    argument taken through :func:`~repro_torch.models.layers.block` first,
    under the tensor-parallel context of this call (a recompute may run on
    autograd's device thread, which does not see it)."""
    snap = tp.snapshot()

    def run(*args, **kwargs):
        with tp.restored(snap):
            return fn(*(L.block(*a) if isinstance(a, L.BlockRef) else a for a in args),
                      **kwargs)
    return run


def remat(cfg: ArchConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, checkpointed under :func:`remat_policy` when
    ``cfg.remat`` is set and grad mode is on.  A
    :class:`~repro_torch.models.layers.BlockRef` argument is taken inside the
    checkpointed region (and again by its recompute), so the checkpoint
    keeps no block's tensors for backward."""
    if any(isinstance(a, L.BlockRef) for a in args):
        fn = _resolving(fn)
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_contexts, **kwargs)


# ---------------------------------------------------------------------------
# Layer grouping (cycles of local layers + one global layer)
# ---------------------------------------------------------------------------

def layer_groups(cfg: ArchConfig) -> tuple[int, int, int]:
    """Returns (n_cycles, locals_per_cycle, n_tail_local)."""
    if cfg.global_every <= 1:
        if cfg.global_every == 0:      # all-local (pure SWA, e.g. mixtral)
            return 0, 0, cfg.n_layers
        return cfg.n_layers, 0, 0     # all-global
    p = cfg.global_every
    return cfg.n_layers // p, p - 1, cfg.n_layers % p


def _layers(cfg: ArchConfig) -> Iterator[tuple[str, tuple, Optional[int]]]:
    """``(group, index, window)`` of every layer, in the reference's order:
    each cycle's locals then its global, then the tail."""
    n_cyc, n_loc, n_tail = layer_groups(cfg)
    for c in range(n_cyc):
        for j in range(n_loc):
            yield "locals", (c, j), cfg.window
        yield "globals", (c,), None
    for t in range(n_tail):
        yield "tail", (t,), cfg.window


def _block_init(generator, cfg: ArchConfig, stack: tuple, device) -> dict:
    attn = L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            stack=stack, qk_norm=True, device=device)
    if cfg.moe:
        mlp = L.init_moe(generator, cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts,
                         stack=stack, device=device)
    else:
        mlp = L.init_mlp(generator, cfg.d_model, cfg.d_ff, stack=stack, device=device)
    return {"attn": attn, "mlp": mlp,
            "ln1": L.init_rmsnorm(cfg.d_model, stack=stack, device=device),
            "ln2": L.init_rmsnorm(cfg.d_model, stack=stack, device=device)}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], device) -> dict:
    """Random weights with the reference's nesting, stacked shapes and scales
    (transformer.py:88-103): ``embed`` at ``vocab_padded``, ``lm_head``
    unless the embeddings are tied.  ``generator`` lives on ``device``
    (``None`` on ``meta``, which allocates nothing)."""
    n_cyc, n_loc, n_tail = layer_groups(cfg)
    params: dict = {"embed": L._normal(generator, (cfg.vocab_padded, cfg.d_model), 0.02,
                                       device)}
    if n_cyc and n_loc:
        params["locals"] = _block_init(generator, cfg, (n_cyc, n_loc), device)
    if n_cyc:
        params["globals"] = _block_init(generator, cfg, (n_cyc,), device)
    if n_tail:
        params["tail"] = _block_init(generator, cfg, (n_tail,), device)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(generator, cfg.d_model, cfg.vocab_padded,
                                         device=device)
    return params


def _block_specs(cfg: ArchConfig, stack: bool) -> dict:
    base = (None,) if stack else ()
    attn = L.attention_specs(stack, qk_norm=True)
    if cfg.moe:
        mlp = {"router": (*base, "fsdp", None), "wi": (*base, "ep", "fsdp", "tp"),
               "wg": (*base, "ep", "fsdp", "tp"), "wo": (*base, "ep", "tp", "fsdp")}
    else:
        mlp = {"wi": (*base, "fsdp", "tp"), "wg": (*base, "fsdp", "tp"),
               "wo": (*base, "tp", "fsdp")}
    return {"attn": attn, "mlp": mlp, "ln1": (*base, None), "ln2": (*base, None)}


def _prepend_none(specs: dict) -> dict:
    """Every spec of ``specs`` with one more leading stacked dim."""
    return tree_map(lambda s: (None, *s), specs, is_leaf=lambda x: isinstance(x, tuple))


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    n_cyc, n_loc, n_tail = layer_groups(cfg)
    specs: dict = {"embed": ("tp", "fsdp"), "final_norm": (None,)}
    blk = _block_specs(cfg, stack=True)
    if n_cyc and n_loc:
        specs["locals"] = _prepend_none(blk)
    if n_cyc:
        specs["globals"] = blk
    if n_tail:
        specs["tail"] = blk
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "tp")
    return specs


# ---------------------------------------------------------------------------
# Forward (train / prefill shared body)
# ---------------------------------------------------------------------------

def _attn_weights(p, cfg: ArchConfig, *, kv: bool = True) -> tuple:
    """``(wq, wk, wv, wo, split)`` as this rank computes with them: K/V's
    weights whole (``None`` without ``kv``: a decode step that reads its
    K/V from a cache), ``wq``/``wo`` the rank's heads when ``split`` (the
    row's heads split as ``torch.tensor_split`` splits them,
    :func:`~repro_torch.distributed.tensor_parallel.heads`), else whole (a
    row of more ranks than heads)."""
    split = tp.head_share(cfg.n_heads) is not None
    wq = tp.heads(p["wq"], -1, cfg.n_heads, cfg.hd)
    wo = tp.heads(p["wo"], -2, cfg.n_heads, cfg.hd)
    if not kv:
        return wq, None, None, wo, split
    return wq, tp.gather(p["wk"], -1), tp.gather(p["wv"], -1), wo, split


def _kv_for(k, v, cfg: ArchConfig, h: int) -> tuple:
    """The K/V heads (dim 2) that this rank's ``h`` query heads read,
    grouped as GQA groups them (``h // n`` query heads to each of ``n``)."""
    if h == cfg.n_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    first = tp.head_share(cfg.n_heads)[0]
    lo, hi = first // g, (first + h - 1) // g + 1
    if (first % g == 0 and h % g == 0) or (g % h == 0 and hi - lo == 1):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    ids = (first + torch.arange(h, device=k.device)) // g
    return k.index_select(2, ids), v.index_select(2, ids)


def _row_parallel(x, w, dtype):
    """``x @ w`` of a row-parallel weight, summed over the row.  Without
    grad (serving) in a half dtype the partial products are formed in f32
    from the half operands and rounded once after the sum, as one card's
    GEMM accumulates in f32 and rounds once, so the split row gives the
    unsharded step's bits up to f32 reassociation; training keeps the
    compute dtype's products."""
    w = w.to(dtype)
    if dtype in (torch.bfloat16, torch.float16) and not torch.is_grad_enabled():
        return tp.reduce(x.to(torch.float32) @ w.to(torch.float32)).to(dtype)
    return tp.reduce(x @ w)


def _attn_out(o, wo, split: bool, dtype):
    """The output projection (or any row-parallel one: ``o``'s last dim the
    rank's share of ``wo``'s rows): row-parallel and summed over the row, or
    computed whole on every rank."""
    return _row_parallel(o, wo, dtype) if split else tp.replicated(o @ wo.to(dtype))


def _attn_apply(p, x, cfg: ArchConfig, *, window, cos, sin, dtype):
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    wq, wk, wv, wo, split = _attn_weights(p, cfg)
    h = wq.shape[-1] // hd
    q = (x @ wq.to(dtype)).reshape(b, s, h, hd)
    k = (x @ wk.to(dtype)).reshape(b, s, hkv, hd)
    v = (x @ wv.to(dtype)).reshape(b, s, hkv, hd)
    q = L.apply_rope(L.rms_norm(q, p["q_norm"], cfg.norm_eps), cos, sin)
    k = L.apply_rope(L.rms_norm(k, p["k_norm"], cfg.norm_eps), cos, sin)
    k, v = _kv_for(k, v, cfg, h)
    if window is not None and s > 2 * window:
        o = L.local_attention(q, k, v, window=window)
    else:
        o = L.gqa_attention(q, k, v, causal=True, window=window)
    return _attn_out(o.reshape(b, s, h * hd), wo, split, dtype)


def _mlp_apply(p, h, cfg: ArchConfig):
    """``(y, aux)`` of the block's MLP: the MoE in its own dtypes, the dense
    MLP with its weights cast to the activations' dtype (aux ``None``: the
    reference's zero, which adds nothing).  On a model row ``wi``/``wg`` are
    column-parallel and ``wo`` row-parallel, the router replicated."""
    if cfg.moe:
        split = tp.divides(cfg.moe.d_ff, "MoE d_ff")
        if tp.size() > 1 and not split:
            p = dict(p, wi=tp.gather(p["wi"], -1), wg=tp.gather(p["wg"], -1),
                     wo=tp.gather(p["wo"], -2))
        y, aux = L.moe_mlp(p, h, top_k=cfg.moe.top_k,
                           combine=tp.reduce if split else tp.replicated)
        return y, tp.replicated(aux)
    split = tp.divides(cfg.d_ff, "MLP d_ff")
    if tp.size() > 1 and not split:
        p = {"wi": tp.gather(p["wi"], -1), "wg": tp.gather(p["wg"], -1),
             "wo": tp.gather(p["wo"], -2)}
    w = tree_map(lambda t: t.to(h.dtype), p)
    if split:
        return _row_parallel(F.silu(h @ w["wg"]) * (h @ w["wi"]), w["wo"], h.dtype), None
    return tp.replicated(L.mlp(w, h)), None


def _block_apply(p, x, cfg: ArchConfig, *, window, cos, sin):
    x = x + _attn_apply(p["attn"], L.rms_norm(tp.copy(x), p["ln1"], cfg.norm_eps), cfg,
                        window=window, cos=cos, sin=sin, dtype=x.dtype)
    y, aux = _mlp_apply(p["mlp"], L.rms_norm(tp.copy(x), p["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def _embed(params, cfg: ArchConfig, tokens, dtype):
    """The token embedding cast to ``dtype``, then scaled by sqrt(d_model)
    (a vocab-parallel lookup on a model row)."""
    return tp.vocab_lookup(params["embed"], tokens).to(dtype) * (cfg.d_model ** 0.5)


def _head(params, cfg: ArchConfig, x):
    """Final norm and the LM head (``embed.T`` when tied), logits sliced from
    ``vocab_padded`` to ``vocab``; on a model row, this rank's shard of the
    padded vocabulary."""
    x = L.rms_norm(tp.copy(x), params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if tp.size() > 1:
        return logits
    return logits[..., :cfg.vocab] if cfg.vocab_padded != cfg.vocab else logits


def _whole_logits(params, cfg: ArchConfig, x, head=None):
    """``head``'s (by default :func:`_head`'s) logits over the whole
    vocabulary (on a model row the shards gathered, as the reference's
    ``out_sh`` replicates the vocab)."""
    logits = (head or _head)(params, cfg, x)
    if tp.size() > 1:
        logits = tp.gather(logits, -1)[..., :cfg.vocab]
    return logits


def _hidden(params, cfg: ArchConfig, tokens, dtype):
    """The blocks' output (B, S, d) before the final norm, and the summed aux."""
    x = _embed(params, cfg, tokens, dtype)
    cos, sin = L.rope_table(torch.arange(tokens.shape[1], device=tokens.device), cfg.hd,
                            cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, idx, window in _layers(cfg):
        x, a = remat(cfg, _block_apply, L.BlockRef(params[group], idx), x, cfg,
                     window=window, cos=cos, sin=sin)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward -> (logits, aux_loss).  tokens (B, S) int."""
    x, aux = _hidden(params, cfg, tokens, dtype)
    return _head(params, cfg, x), aux


def _xent(logits, cfg: ArchConfig, labels) -> torch.Tensor:
    """:func:`layers.softmax_xent` of a head's logits: vocab-parallel on a
    model row (``logits`` the rank's shard of the padded vocabulary)."""
    return L.softmax_xent(logits, labels, vocab=cfg.vocab if tp.size() > 1 else None)


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    logits, aux = forward(params, cfg, batch["tokens"], dtype=dtype)
    return _xent(logits, cfg, batch["labels"]) + 1e-2 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with ring-buffer local caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               *, device) -> dict:
    """Zero K/V caches ``(*stack, B, length, Hkv, hd)``: local layers hold
    ``min(window, max_len)`` slots (a ring buffer), global ones ``max_len``."""
    n_cyc, n_loc, n_tail = layer_groups(cfg)
    w = min(cfg.window or max_len, max_len)

    def entry(length, stack):
        shape = (*stack, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache: dict = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if n_cyc and n_loc:
        cache["locals"] = entry(w, (n_cyc, n_loc))
    if n_cyc:
        cache["globals"] = entry(max_len, (n_cyc,))
    if n_tail:
        cache["tail"] = entry(w, (n_tail,))
    return cache


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_cache`' tree: batch over ``dp``, the
    sequence over ``sp`` (long-context cells), heads replicated."""
    n_cyc, n_loc, n_tail = layer_groups(cfg)
    kv = lambda extra: {"k": (*extra, "dp", "sp", None, None),
                        "v": (*extra, "dp", "sp", None, None)}
    specs: dict = {"len": ("dp",)}
    if n_cyc and n_loc:
        specs["locals"] = kv((None, None))
    if n_cyc:
        specs["globals"] = kv((None,))
    if n_tail:
        specs["tail"] = kv((None,))
    return specs


def _cache_span(key: str) -> Optional[tuple[int, int]]:
    """``(S, lo)`` of cache ``key`` split over the active decode step's
    ``sp`` group (its global slot count and this rank's first slot), or
    ``None`` where the rank holds the whole cache."""
    grp = tp.sp_group()
    return None if grp is None else grp.span(key)


def _cache_write(kv: dict, slot: int, lo: Optional[int], k, v) -> None:
    """The new token's K/V (B, Hkv, hd) into global slot ``slot`` of a cache
    whose local tensors hold the slots from ``lo`` (``None``: the whole
    cache): only the rank that holds the slot writes it."""
    i = slot - (lo or 0)
    if 0 <= i < kv["k"].shape[1]:
        kv["k"][:, i] = k.to(kv["k"].dtype)
        kv["v"][:, i] = v.to(kv["v"].dtype)


def _cache_attention(q, kv: dict, cfg: ArchConfig, cache_len, lo: Optional[int]):
    """Decode attention of this rank's query heads ``q`` (B, 1, h, hd) over
    a K/V cache: the whole cache (``lo`` None), or this rank's slots from
    ``lo`` of a cache split over the ``sp`` group.  There every rank attends
    every head to its own slots (``q`` gathered over the model row first),
    the ranks' log-sum-exps are gathered over the group for their maximum,
    the ranks' weighted partial outputs summed over it (the group's sum
    gives every rank the same bits, and carries one partial's bytes where a
    gather of the partials would carry the group's), and the rank keeps its
    own heads."""
    h = q.shape[2]
    if lo is None:
        return L.decode_attention(q, *_kv_for(kv["k"], kv["v"], cfg, h), cache_len)
    grp = tp.sp_group()
    q_all = q if h == cfg.n_heads else tp.all_gather(q, 2, tp.head_sizes(cfg.n_heads))
    o, lse = L.decode_attention_partial(q_all, kv["k"], kv["v"], cache_len, lo)
    o = L.merge_decode_partials(o, lse, grp.all_gather(lse[None], 0).amax(dim=0), grp.sum)
    if h != cfg.n_heads:
        h0 = tp.head_share(cfg.n_heads)[0]
        o = o[:, h0:h0 + h]
    return o[:, None].to(q.dtype)


def _decode_block(p, x, kv, cfg: ArchConfig, *, window, pos: int, cos, sin, span=None):
    """One-token decode through one block, writing its K/V into ``kv``
    (``span``: the ``(S, lo)`` of a cache split over the ``sp`` group,
    :func:`_cache_span`)."""
    b, dtype = x.shape[0], x.dtype
    hkv, hd = cfg.n_kv_heads, cfg.hd
    wq, wk, wv, wo, split = _attn_weights(p["attn"], cfg)
    h = wq.shape[-1] // hd
    xa = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (xa @ wq.to(dtype)).reshape(b, 1, h, hd)
    k = (xa @ wk.to(dtype)).reshape(b, 1, hkv, hd)
    v = (xa @ wv.to(dtype)).reshape(b, 1, hkv, hd)
    q = L.apply_rope(L.rms_norm(q, p["attn"]["q_norm"], cfg.norm_eps), cos, sin)
    k = L.apply_rope(L.rms_norm(k, p["attn"]["k_norm"], cfg.norm_eps), cos, sin)
    length, lo = (kv["k"].shape[1], None) if span is None else span
    # Local layers: a ring buffer.  Global layers: past max_len the last
    # slot is overwritten (the reference's behaviour).
    slot = pos % length if window is not None else min(pos, length - 1)
    _cache_write(kv, slot, lo, k[:, 0], v[:, 0])
    cache_len = torch.full((b,), min(pos + 1, length), dtype=torch.int32, device=x.device)
    # Ring-buffer slots are within-window by construction; keys carry their
    # absolute-position RoPE so scores stay relative-correct across wraps.
    o = _cache_attention(q, kv, cfg, cache_len, lo)
    x = x + _attn_out(o.reshape(b, 1, h * hd), wo, split, dtype)
    y, _ = _mlp_apply(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y


def decode_step(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos, *,
                dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One new token for the whole batch at the (uniform) write position
    ``pos`` (an int).  Returns ``(logits (B, vocab), cache)``: the cache's
    K/V tensors are written in place, as a donated buffer would be, and the
    returned dict holds them with ``len`` advanced by one.  Inside a decode
    step that splits the caches' sequence over ``sp``, each rank's caches
    hold its slots (:func:`_cache_attention`)."""
    pos = int(pos)
    x = _embed(params, cfg, token[:, None], dtype)
    cos, sin = L.rope_table(torch.tensor([pos], device=x.device), cfg.hd, cfg.rope_theta)
    spans = {group: _cache_span(group) for group in cache}
    for group, idx, window in _layers(cfg):
        kv = {"k": cache[group]["k"][idx], "v": cache[group]["v"][idx]}
        x = _decode_block(L.block(params[group], idx), x, kv, cfg, window=window, pos=pos,
                          cos=cos, sin=sin, span=spans[group])
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return _whole_logits(params, cfg, x)[:, 0], new_cache


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Last-token logits (B, vocab) of the full forward.  The reference
    forms every row's logits and keeps the last; only the last row goes
    through the head here (the same function; a GEMM of another row count
    rounds differently on the card, so it agrees to the float tolerance)."""
    x, _ = _hidden(params, cfg, tokens, dtype)
    return _whole_logits(params, cfg, x[:, -1])
