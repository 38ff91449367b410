"""Shared model layers, port of ``repro.models.layers``: RMSNorm (the DiT's),
and the decoder-only LM's RoPE, attention, MLP, MoE and loss.

Every ``init_*`` takes an explicit ``torch.Generator`` and device, like
``dit.init_params``, and returns the parameter tensors alone.  The
reference's logical sharding specs, its second return value, are plain
spec functions here, beside each family's ``init_params``
(:func:`attention_specs`, ``param_specs``, ``cache_specs``), read by
:mod:`repro_torch.launch.steps`.  A stack of
layers is one tensor with leading dims ``stack`` (the reference's single
``L`` dim, or two for ``(cycles, locals)``), built at its stacked shape, so
``device="meta"`` with ``generator=None`` counts parameters without
allocating them.  ``maybe_scan`` becomes the caller's Python loop over the
stacked leading dims.  The numbers differ from ``jax.random``'s: tests move
the reference's weights across with :func:`repro_torch.convert.params_from_jax`.

Float32 where the reference computes in float32 (norms, RoPE, softmax and
the scores after the product); ``_NEG_INF`` is the reference's finite mask
value, so a row with no live key averages its values as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.tree import tree_map

__all__ = [
    "block", "BlockRef", "init_dense", "init_rmsnorm", "rms_norm", "rope_table", "apply_rope",
    "gqa_attention", "local_attention", "decode_attention", "init_attention",
    "attention_specs", "init_mlp", "mlp", "init_moe", "moe_route", "moe_route_global", "moe_mlp",
    "softmax_xent", "causal_conv",
]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# One block of a stacked group
# ---------------------------------------------------------------------------

def block(group: dict, idx) -> dict:
    """One block's parameters: every leaf of the stacked ``group`` at ``idx``
    (an int, or a tuple for two stacked dims).  Every family takes its
    blocks through here.  Outside a sharded step this is the slice itself;
    inside one (an active
    :class:`~repro_torch.distributed.tensor_parallel.ParamGather`) ``group``
    holds the rank's shards and this block's slice of them is gathered."""
    src = tp.block_source()
    if src is None:
        return tree_map(lambda a: a[idx], group)
    return src.block(group, idx)


class BlockRef(NamedTuple):
    """A block not yet taken: :func:`repro_torch.models.transformer.remat`
    resolves it with :func:`block` inside the checkpointed region, so a
    recompute takes (and, in a sharded step, gathers) the block again."""

    group: dict
    idx: object


def _promote(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands in their common dtype (jnp's implicit promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ---------------------------------------------------------------------------
# Param init helpers
# ---------------------------------------------------------------------------

def _normal(generator, shape, std, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def init_dense(generator, d_in: int, d_out: int, *, stack: tuple = (), device) -> torch.Tensor:
    return _normal(generator, (*stack, d_in, d_out), d_in ** -0.5, device)


def init_rmsnorm(d: int, *, stack: tuple = (), device) -> torch.Tensor:
    return torch.ones((*stack, d), device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   *, stack: tuple = (), qk_norm: bool = False, device) -> dict:
    p = {"wq": init_dense(generator, d_model, n_heads * head_dim, stack=stack, device=device),
         "wk": init_dense(generator, d_model, n_kv_heads * head_dim, stack=stack, device=device),
         "wv": init_dense(generator, d_model, n_kv_heads * head_dim, stack=stack, device=device),
         "wo": init_dense(generator, n_heads * head_dim, d_model, stack=stack, device=device)}
    if qk_norm:
        p["q_norm"] = init_rmsnorm(head_dim, stack=stack, device=device)
        p["k_norm"] = init_rmsnorm(head_dim, stack=stack, device=device)
    return p


def attention_specs(stack: bool, qk_norm: bool = False) -> dict:
    """The logical specs of :func:`init_attention`'s tree (one leading
    ``None`` when stacked)."""
    base = (None,) if stack else ()
    s = {"wq": (*base, "fsdp", "tp"), "wk": (*base, "fsdp", "tp"),
         "wv": (*base, "fsdp", "tp"), "wo": (*base, "tp", "fsdp")}
    if qk_norm:
        s["q_norm"] = (*base, None)
        s["k_norm"] = (*base, None)
    return s


def init_mlp(generator, d_model: int, d_ff: int, *, stack: tuple = (), device) -> dict:
    return {"wi": init_dense(generator, d_model, d_ff, stack=stack, device=device),
            "wg": init_dense(generator, d_model, d_ff, stack=stack, device=device),
            "wo": init_dense(generator, d_ff, d_model, stack=stack, device=device)}


def init_moe(generator, d_model: int, d_ff: int, num_experts: int, *, stack: tuple = (),
             device) -> dict:
    s = d_model ** -0.5
    return {"router": _normal(generator, (*stack, d_model, num_experts), s, device),
            "wi": _normal(generator, (*stack, num_experts, d_model, d_ff), s, device),
            "wg": _normal(generator, (*stack, num_experts, d_model, d_ff), s, device),
            "wo": _normal(generator, (*stack, num_experts, d_ff, d_model), d_ff ** -0.5, device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions (...,) int -> (cos, sin) each (..., dim//2) f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, dh) or (..., S, dh); cos/sin broadcastable (..., S, dh//2).
    Rotates the two halves (not interleaved pairs) in f32."""
    if x.ndim == cos.ndim + 2:                    # (B,S,H,dh) with (B?,S,dh/2)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (training / prefill): chunked causal GQA, optional window
# ---------------------------------------------------------------------------

def gqa_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  window: Optional[int] = None, chunk: int = 512,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Chunked masked attention.  q (B,S,H,dh); k,v (B,Skv,Hkv,dh).

    Scores are O(chunk·S_kv) per head.  The reference pads the last query
    chunk to full length and drops the padding rows; here the last chunk is
    shorter, which gives the same rows."""
    b, s, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = (dh ** -0.5) if scale is None else scale
    qh = q.transpose(1, 2).reshape(b, hkv, g, s, dh) * scale
    kt = k.permute(0, 2, 3, 1)[:, :, None]                # (B,Hkv,1,dh,Skv)
    vh = v.transpose(1, 2)[:, :, None].to(torch.float32)  # (B,Hkv,1,Skv,dh)
    kv_pos = torch.arange(skv, device=q.device)
    out = []
    for c0 in range(0, s, chunk):
        qc = qh[:, :, :, c0:c0 + chunk]
        sc = torch.matmul(*_promote(qc, kt)).to(torch.float32)
        q_pos = c0 + torch.arange(qc.shape[3], device=q.device) + q_offset
        mask = torch.ones((qc.shape[3], skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        p = torch.softmax(torch.where(mask, sc, _NEG_INF), dim=-1)
        out.append(torch.matmul(p, vh).to(q.dtype))
    out = torch.cat(out, dim=3).reshape(b, h, s, dh).transpose(1, 2)
    return out.to(q.dtype)


def local_attention(q, k, v, *, window: int, chunk: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Sub-quadratic sliding-window attention: each q chunk attends to a
    banded KV slice of length chunk+window.  Cost O(S·(chunk+window))."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    chunk = window if chunk is None else chunk
    scale = (dh ** -0.5) if scale is None else scale
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    band = window + chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    # Pad KV on the left so every band slice is in range.
    kp = F.pad(k, (0, 0, 0, 0, band - chunk, pad))
    vp = F.pad(v, (0, 0, 0, 0, band - chunk, pad))
    out = []
    for ci in range(n_chunks):
        start = ci * chunk                      # band begins at start in padded kv
        kb = kp[:, start:start + band].permute(0, 2, 3, 1)[:, :, None]      # (B,Hkv,1,dh,band)
        vb = vp[:, start:start + band].transpose(1, 2)[:, :, None].to(torch.float32)
        qg = q[:, start:start + chunk].reshape(b, chunk, hkv, g, dh).permute(0, 2, 3, 1, 4)
        sc = torch.matmul(*_promote(qg * scale, kb)).to(torch.float32)    # (B,Hkv,G,C,band)
        q_pos = start + torch.arange(chunk, device=q.device)
        kv_pos = start + torch.arange(band, device=q.device) - (band - chunk)
        mask = ((q_pos[:, None] >= kv_pos[None, :])
                & (q_pos[:, None] - kv_pos[None, :] < window) & (kv_pos[None, :] >= 0))
        p = torch.softmax(torch.where(mask, sc, _NEG_INF), dim=-1)
        out.append(torch.matmul(p, vb).permute(0, 3, 1, 2, 4).reshape(b, chunk, h, dh))
    return torch.cat(out, dim=1)[:, :s].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B,1,H,dh) vs caches (B,S,Hkv,dh); ``cache_len``
    (B,) int: slots ``[0, cache_len)`` are live."""
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = (dh ** -0.5) if scale is None else scale
    qh = q.reshape(b, hkv, g, dh) * scale
    sc = torch.matmul(*_promote(qh, k_cache.permute(0, 2, 3, 1))).to(torch.float32)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < cache_len[:, None]                  # (B,S)
    if window is not None:
        mask &= pos[None, :] >= cache_len[:, None] - window
    p = torch.softmax(torch.where(mask[:, None, None, :], sc, _NEG_INF), dim=-1)
    out = torch.matmul(p, v_cache.transpose(1, 2).to(torch.float32))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (K,C); the ssm and hybrid
    families' ``_causal_conv``."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))


# ---------------------------------------------------------------------------
# MLP (gated SiLU) & MoE
# ---------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def moe_route(probs: torch.Tensor, top_k: int, cap: int):
    """``(gates, eids, flat_pos, keep)`` of the reference's capacity routing
    (layers.py:300-308).  ``probs`` (N, E) f32.  The top-k keeps the lower
    expert on a tie, as ``lax.top_k`` does (``torch.topk`` promises no
    order), by a stable sort.  A slot's position in its expert's buffer is
    the running count over the flattened (token, k) order; slots at or past
    ``cap`` are dropped (``keep`` False)."""
    e = probs.shape[-1]
    eids = torch.argsort(-probs, dim=-1, stable=True)[:, :top_k]     # (N,k)
    gates = probs.gather(-1, eids)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    flat_e = eids.reshape(-1)                                        # (N*k,)
    pos = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1              # position in expert
    flat_pos = pos.gather(1, flat_e[:, None])[:, 0]
    return gates, eids, flat_pos, flat_pos < cap


def moe_mlp(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            combine=None):
    """Capacity-based top-k MoE (gather-dispatch; FLOPs ≈ k·tokens·expert).
    Every expert's buffer of ``cap`` slots runs, live or not.  A dropped slot
    adds zeros at ``(E-1, cap-1)`` and its combine reads ``min(pos, cap-1)``
    with a zero gate, as in the reference.  ``combine``, when given, is
    applied to the combined f32 output before its cast (the sum over the
    model row when the experts' ``d_ff`` is split across it).  Returns
    ``(y, aux)``.

    Inside a sharded step whose batch is split over ``dp``
    (:func:`~repro_torch.distributed.tensor_parallel.dp_group`), the tokens
    are routed as the reference's global ``moe_mlp`` routes the whole batch
    (:func:`_moe_mlp_global`)."""
    grp = tp.dp_group()
    if grp is not None:
        return _moe_mlp_global(p, x, grp, top_k=top_k, capacity_factor=capacity_factor,
                               combine=combine)
    b, s, d = x.shape
    e = p["router"].shape[-1]
    n = b * s
    xf = x.reshape(n, d)
    probs = torch.softmax(torch.matmul(*_promote(xf, p["router"])).to(torch.float32), dim=-1)
    cap = int(capacity_factor * n * top_k / e) + 1
    gates, eids, flat_pos, keep = moe_route(probs, top_k, cap)
    flat_e = eids.reshape(-1)
    y = _experts(p, xf, gates, flat_e, flat_pos, keep, e, cap, top_k, combine)
    aux = _load_balance_loss(probs, eids, e)
    return y.reshape(b, s, d).to(x.dtype), aux


def _experts(p: dict, xf, gates, flat_e, slot, keep, e: int, cap: int, top_k: int, combine):
    """Dispatch the kept ``(token, k)`` slots into ``(E, cap, d)`` buffers at
    ``slot``, run every expert over its buffer and combine the gated
    outputs: ``(N, d)`` f32."""
    n, d = xf.shape
    ei = torch.where(keep, flat_e, e - 1)
    pi = torch.where(keep, slot, cap - 1)
    vals = torch.where(keep[:, None], xf.repeat_interleave(top_k, dim=0), 0)
    buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((ei, pi), vals, accumulate=True)
    bw, wg = _promote(buf, p["wg"])
    h = F.silu(torch.bmm(bw, wg)) * torch.bmm(bw, p["wi"].to(bw.dtype))
    yb = torch.bmm(h, p["wo"].to(h.dtype))                           # (E,C,d)

    # Combine: gather back and weight by gate.
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None]
    contrib = yb[flat_e, slot.clamp(max=cap - 1)] * w
    y = contrib.to(torch.float32).reshape(n, top_k, d).sum(dim=1)
    return y if combine is None else combine(y)


def moe_route_global(probs: torch.Tensor, top_k: int, capacity_factor: float, grp):
    """:func:`moe_route` of this rank's ``probs`` (N, E) as part of the
    global batch, whose order is batch-major: the ranks of ``grp`` (the
    ``dp`` group) hold its slices in rank order.  Returns ``(gates, eids,
    local_pos, keep, c_loc)``.

    The capacity comes from the global token count.  A slot's position in
    its expert's buffer is its local running count ``local_pos`` plus the
    slots that the group's earlier ranks sent to that expert (one all-gather
    of ``(E,)`` counts), and it is kept below the capacity, so the kept
    slots are the reference's.  The rank's buffer holds only its own kept
    slots, at ``local_pos``: expert ``e`` keeps at most ``min(count_e,
    cap - offset_e)`` of them, and ``c_loc`` is the largest of those (at
    least 1).  On ``meta`` tensors (the dry run) ``c_loc`` is the capacity
    over the group's size, the balanced share."""
    e = probs.shape[-1]
    cap = int(capacity_factor * probs.shape[0] * grp.size * top_k / e) + 1
    gates, eids, local_pos, _ = moe_route(probs, top_k, cap)
    flat_e = eids.reshape(-1)
    count = F.one_hot(flat_e, e).sum(dim=0)                          # (E,) int64
    offset = grp.all_gather(count[None], 0)[:grp.rank].sum(dim=0)
    keep = offset[flat_e] + local_pos < cap
    if count.is_meta:
        return gates, eids, local_pos, keep, -(-cap // grp.size)
    c_loc = max(int(torch.minimum(count, (cap - offset).clamp(min=0)).max()), 1)
    return gates, eids, local_pos, keep, c_loc


def _moe_mlp_global(p: dict, x: torch.Tensor, grp, *, top_k: int, capacity_factor: float,
                    combine):
    """:func:`moe_mlp` of this rank's tokens routed as part of the global
    batch (:func:`moe_route_global`); a dropped slot is treated as before,
    at ``(E-1, c_loc-1)``.  The load-balancing loss takes its two means
    over the global batch: the local sums of the top-1 one-hot and of
    ``probs``, summed over the group in one collective (its gradient reaches
    the local ``probs`` as :func:`~repro_torch.distributed.tensor_parallel.
    dp_sum` says)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    n = b * s
    xf = x.reshape(n, d)
    probs = torch.softmax(torch.matmul(*_promote(xf, p["router"])).to(torch.float32), dim=-1)
    gates, eids, local_pos, keep, c_loc = moe_route_global(probs, top_k, capacity_factor, grp)
    y = _experts(p, xf, gates, eids.reshape(-1), local_pos, keep, e, c_loc, top_k, combine)
    sums = torch.cat([F.one_hot(eids[:, 0], e).to(torch.float32).sum(dim=0), probs.sum(dim=0)])
    sums = tp.dp_sum(sums) / (n * grp.size)
    aux = e * (sums[:e] * sums[e:]).sum()
    return y.reshape(b, s, d).to(x.dtype), aux


def _load_balance_loss(probs: torch.Tensor, eids: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    frac_tokens = F.one_hot(eids[:, 0], e).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return e * (frac_tokens * frac_probs).sum()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4, *,
                 vocab: Optional[int] = None):
    """Cross entropy with z-loss; logits (..., V), labels (...) int.

    With ``vocab`` given the softmax is vocab-parallel: ``logits`` is this
    rank's shard of the padded vocabulary over the model row (columns
    ``rank · V`` on; the whole padded vocabulary on a row of one), columns
    at or past ``vocab`` are left out, and the max, the sum of exps and the
    target's logit are each reduced over the row
    (:mod:`~repro_torch.distributed.tensor_parallel`), so every rank of the
    row holds the same loss."""
    logits = logits.to(torch.float32)
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
        return (lse - ll + z_loss * lse.square()).mean()
    v_loc = logits.shape[-1]
    first = tp.rank() * v_loc
    cols = first + torch.arange(v_loc, device=logits.device)
    logits = torch.where(cols < vocab, logits, float("-inf"))
    top = tp.row_max(logits.detach().amax(dim=-1))     # a constant of the gradient
    lse = top + torch.log(tp.reduce(torch.exp(logits - top[..., None]).sum(dim=-1)))
    local = labels.to(torch.int64) - first
    inside = (local >= 0) & (local < v_loc)
    hit = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    ll = tp.reduce(torch.where(inside, hit, torch.zeros((), device=logits.device)))
    return (lse - ll + z_loss * lse.square()).mean()
