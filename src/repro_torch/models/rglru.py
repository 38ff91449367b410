"""RecurrentGemma / Griffin (arXiv:2402.19427), port of ``repro.models.rglru``:
RG-LRU recurrent blocks and local attention, pattern [recurrent, recurrent,
local attention] (period 3), and a tail of recurrent blocks.

The RG-LRU gate:  r_t = σ(W_a x + b_a),  i_t = σ(W_x x + b_x)
                  log a_t = -c · softplus(Λ) · r_t          (c = 8)
                  h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

A sequence runs the reference's ``jax.lax.associative_scan`` as a
Hillis–Steele scan with the same ``combine``: log2(S) rounds of whole-tensor
ops, never a loop over the sequence.  Embeddings are scaled by √d_model
and the head is the tied ``embed.T``.  The attention layers take the banded
:func:`layers.local_attention` when the sequence is longer than twice the
window; decode keeps a ring of ``min(window, max_len)`` K/V slots.

The reference's ``lax.scan`` over cycles and blocks is a Python loop here.
``cfg.remat`` checkpoints each recurrent block and each attention block,
as the reference's ``jax.checkpoint`` does (``models/transformer.remat``,
whose docstring maps the policy).  ``param_specs`` and
``cache_specs`` are the reference's logical sharding specs, leaf for leaf
with ``init_params`` and ``init_cache`` (read by
:mod:`repro_torch.launch.steps`).

**Tensor parallelism** (a sharded step that splits the ``model`` row; see
:mod:`repro_torch.models.transformer`).  The RG-LRU is diagonal per
channel, so a recurrent block splits by channel: ``w_in_x``, ``w_in_y``,
``w_gate_x`` and ``w_gate_a`` are column-parallel, ``conv`` and ``lam`` the
rank's channels, ``w_out`` row-parallel and summed over the row; the decode
state ``rec_h``/``rec_conv`` (and ``tail_*``) stays the rank's channels, as
``cache_specs`` lays it out.  The local-attention layer and its MLP go
through the transformer's helpers (``_attn_weights``, ``_kv_for``,
``_attn_out``, ``_mlp_apply``): ``wq``/``wo`` by heads, K/V whole, the MLP
column- then row-parallel; the ring cache stays whole.  Each sublayer's
input passes *f* (``tp.copy``) before its norm; the embedding, the tied
head and the loss are vocab-parallel.  A head count the row does not
divide is split unevenly (the transformer's ``_attn_weights``); a row of
more ranks than heads, or a ``d_ff`` or channel count the row does not
divide, is gathered and computed replicated (``tp.note``):
recurrentgemma-2b's 10 heads on a row of 16.  Outside such a
step the code computes as before, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "param_specs", "forward", "train_loss", "init_cache",
           "cache_specs", "prefill", "decode_step", "rg_lru", "rg_lru_step", "n_cycles"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("rec", "attn", "tail")

_C = 8.0
CONV_K = 4


def _gates(x, gate_x, gate_a, lam):
    """``(a, b)`` of the recurrence ``h_t = a_t h_{t-1} + b_t``, in f32."""
    r = torch.sigmoid(gate_a.to(torch.float32))
    i = torch.sigmoid(gate_x.to(torch.float32))
    log_a = -_C * F.softplus(lam) * r
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return torch.exp(log_a), mult * (i * x.to(torch.float32))


def rg_lru(x, gate_x, gate_a, lam) -> torch.Tensor:
    """x, gates (B,S,D); lam (D,).  An inclusive scan of ``a_t h + b_t`` over
    the sequence: each round ``d`` combines element ``t`` with ``t - d``
    (``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``), the identity ``(1, 0)``
    standing in before the start."""
    a, b = _gates(x, gate_x, gate_a, lam)
    s, d = a.shape[1], 1
    while d < s:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))
        a, b = a_prev * a, b_prev * a + b
        d *= 2
    return b.to(x.dtype)


def rg_lru_step(state, x, gate_x, gate_a, lam):
    """One step from ``state`` (f32); returns ``(h in x's dtype, h f32)``."""
    a, b = _gates(x, gate_x, gate_a, lam)
    h = a * state + b
    return h.to(x.dtype), h


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_rec_block(cfg: ArchConfig, generator, stack: tuple, device) -> dict:
    d = cfg.d_model
    s = d ** -0.5
    w = lambda: L._normal(generator, (*stack, d, d), s, device)
    return {
        "ln": L.init_rmsnorm(d, stack=stack, device=device),
        "w_in_x": w(),                                      # recurrent branch
        "w_in_y": w(),                                      # gelu gate branch
        "conv": L._normal(generator, (*stack, CONV_K, d), 0.2, device),
        "w_gate_x": w(),
        "w_gate_a": w(),
        "lam": torch.full((*stack, d), 0.65, device=device),
        "w_out": w(),
    }


def _init_attn_block(cfg: ArchConfig, generator, stack: tuple, device) -> dict:
    return {"attn": L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, stack=stack, qk_norm=False, device=device),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, stack=stack, device=device),
            "ln1": L.init_rmsnorm(cfg.d_model, stack=stack, device=device),
            "ln2": L.init_rmsnorm(cfg.d_model, stack=stack, device=device)}


def n_cycles(cfg: ArchConfig) -> int:
    # Pattern period 3: [recurrent, recurrent, local-attn]
    assert cfg.n_layers % 3 == 2 or cfg.n_layers % 3 == 0, cfg.n_layers
    return cfg.n_layers // 3


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], device) -> dict:
    """Random weights with the reference's nesting and scales
    (rglru.py:121-138): ``rec`` stacked ``(n_cycles, 2, ...)``, ``attn``
    ``(n_cycles, ...)`` and, for ``n_layers % 3 == 2``, ``tail`` ``(2, ...)``.
    ``generator`` lives on ``device`` (``None`` on ``meta``)."""
    nc = n_cycles(cfg)
    params = {
        "embed": L._normal(generator, (cfg.vocab_padded, cfg.d_model), 0.02, device),
        "rec": _init_rec_block(cfg, generator, (nc, 2), device),
        "attn": _init_attn_block(cfg, generator, (nc,), device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=device),
    }
    tail = cfg.n_layers - nc * 3
    if tail:
        params["tail"] = _init_rec_block(cfg, generator, (tail,), device)
    return params


def _rec_specs(stack: bool) -> dict:
    b = (None,) if stack else ()
    return {"ln": (*b, None), "w_in_x": (*b, "fsdp", "tp"), "w_in_y": (*b, "fsdp", "tp"),
            "conv": (*b, None, "tp"), "w_gate_x": (*b, "fsdp", "tp"),
            "w_gate_a": (*b, "fsdp", "tp"), "lam": (*b, "tp"),
            "w_out": (*b, "tp", "fsdp")}


def _attn_specs(stack: bool) -> dict:
    b = (None,) if stack else ()
    return {"attn": L.attention_specs(stack), "ln1": (*b, None), "ln2": (*b, None),
            "mlp": {"wi": (*b, "fsdp", "tp"), "wg": (*b, "fsdp", "tp"),
                    "wo": (*b, "tp", "fsdp")}}


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    specs = {"embed": ("tp", "fsdp"), "rec": T._prepend_none(_rec_specs(True)),
             "attn": _attn_specs(True), "final_norm": (None,)}
    if cfg.n_layers - n_cycles(cfg) * 3:
        specs["tail"] = _rec_specs(True)
    return specs


_COLUMNS = ("w_in_x", "w_in_y", "w_gate_x", "w_gate_a", "conv", "lam")


def _rec_weights(cfg: ArchConfig, p) -> tuple:
    """``(p, split)``: the recurrent block's leaves as this rank computes
    with them, its channels when ``split``; on a model row that does not
    divide the channels, every channel-split leaf gathered whole."""
    split = tp.divides(cfg.d_model, "RG-LRU channels")
    if tp.size() > 1 and not split:
        p = dict(p, w_out=tp.gather(p["w_out"], -2),
                 **{k: tp.gather(p[k], -1) for k in _COLUMNS})
    return p, split


def _rec_apply(cfg: ArchConfig, p, x):
    dtype = x.dtype
    p, split = _rec_weights(cfg, p)
    xn = L.rms_norm(tp.copy(x), p["ln"], cfg.norm_eps)
    y = F.gelu(xn @ p["w_in_y"].to(dtype), approximate="tanh")
    xr = L.causal_conv(xn @ p["w_in_x"].to(dtype), p["conv"].to(dtype))
    h = rg_lru(xr, xn @ p["w_gate_x"].to(dtype), xn @ p["w_gate_a"].to(dtype), p["lam"])
    return x + T._attn_out(h * y, p["w_out"], split, dtype)


def _qkv(cfg: ArchConfig, p, xa, cos, sin):
    """``(q, k, v, wo, split)``: the queries of this rank's heads, K/V
    whole, rotated."""
    b, s, _ = xa.shape
    dtype = xa.dtype
    wq, wk, wv, wo, split = T._attn_weights(p, cfg)
    q = (xa @ wq.to(dtype)).reshape(b, s, -1, cfg.hd)
    k = (xa @ wk.to(dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (xa @ wv.to(dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v, wo, split


def _mlp_out(cfg: ArchConfig, p, x):
    y, _ = T._mlp_apply(p["mlp"], L.rms_norm(tp.copy(x), p["ln2"], cfg.norm_eps), cfg)
    return x + y


def _attn_apply_blk(cfg: ArchConfig, p, x, cos, sin):
    b, s, _ = x.shape
    q, k, v, wo, split = _qkv(cfg, p["attn"], L.rms_norm(tp.copy(x), p["ln1"], cfg.norm_eps),
                              cos, sin)
    k, v = T._kv_for(k, v, cfg, q.shape[2])
    if cfg.window and s > 2 * cfg.window:
        o = L.local_attention(q, k, v, window=cfg.window)
    else:
        o = L.gqa_attention(q, k, v, causal=True, window=cfg.window)
    x = x + T._attn_out(o.reshape(b, s, -1), wo, split, x.dtype)
    return _mlp_out(cfg, p, x)


def _hidden(params, cfg: ArchConfig, tokens, dtype):
    x = T._embed(params, cfg, tokens, dtype)
    cos, sin = L.rope_table(torch.arange(tokens.shape[1], device=tokens.device), cfg.hd,
                            cfg.rope_theta)
    for c in range(n_cycles(cfg)):
        for j in range(2):
            x = T.remat(cfg, _rec_apply, cfg, L.BlockRef(params["rec"], (c, j)), x)
        x = T.remat(cfg, _attn_apply_blk, cfg, L.BlockRef(params["attn"], c), x, cos, sin)
    for t in range(params["tail"]["ln"].shape[0] if "tail" in params else 0):
        x = T.remat(cfg, _rec_apply, cfg, L.BlockRef(params["tail"], t), x)
    return x


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16):
    """Full causal forward -> (logits, aux 0).  tokens (B, S) int."""
    x = _hidden(params, cfg, tokens, dtype)
    return T._head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"], dtype=dtype)
    return T._xent(logits, cfg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: recurrent state and a ring of local K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               *, device) -> dict:
    """Zero decode state: each recurrent block's ``h`` (f32) and last
    ``CONV_K - 1`` conv inputs, and each attention layer's ring of
    ``min(window, max_len)`` K/V slots."""
    nc = n_cycles(cfg)
    d = cfg.d_model
    w = min(cfg.window or max_len, max_len)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    cache = {
        "rec_h": zeros(nc, 2, batch, d, dt=torch.float32),
        "rec_conv": zeros(nc, 2, batch, CONV_K - 1, d),
        "attn": {"k": zeros(nc, batch, w, cfg.n_kv_heads, cfg.hd),
                 "v": zeros(nc, batch, w, cfg.n_kv_heads, cfg.hd)},
        "len": zeros(batch, dt=torch.int32),
    }
    tail = cfg.n_layers - nc * 3
    if tail:
        cache["tail_h"] = zeros(tail, batch, d, dt=torch.float32)
        cache["tail_conv"] = zeros(tail, batch, CONV_K - 1, d)
    return cache


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_cache`' tree."""
    specs = {"rec_h": (None, None, "dp", "tp"), "rec_conv": (None, None, "dp", None, "tp"),
             "attn": {"k": (None, "dp", "sp", None, None),
                      "v": (None, "dp", "sp", None, None)},
             "len": ("dp",)}
    if cfg.n_layers - n_cycles(cfg) * 3:
        specs["tail_h"] = (None, "dp", "tp")
        specs["tail_conv"] = (None, "dp", None, "tp")
    return specs


def _rec_step(cfg: ArchConfig, p, x, h_state, conv_state):
    """One token through a recurrent block; returns (x, new h, new conv
    window), the states the rank's channels (gathered whole and cut back
    on a row that computes the block replicated)."""
    dtype = x.dtype
    p, split = _rec_weights(cfg, p)
    if tp.size() > 1 and not split:
        h_state, conv_state = tp.all_gather(h_state, -1), tp.all_gather(conv_state, -1)
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    y = F.gelu(xn @ p["w_in_y"].to(dtype), approximate="tanh")
    hist = torch.cat([conv_state, xn @ p["w_in_x"].to(dtype)], dim=1)      # (B,K,D)
    xr = (hist * p["conv"].to(dtype)).sum(dim=1)[:, None]
    h, new_h = rg_lru_step(h_state[:, None], xr, xn @ p["w_gate_x"].to(dtype),
                           xn @ p["w_gate_a"].to(dtype), p["lam"])
    new_h, hist = new_h[:, 0], hist[:, 1:]
    if tp.size() > 1 and not split:
        new_h, hist = tp.shard(new_h, -1), tp.shard(hist, -1)
    return x + T._attn_out(h * y, p["w_out"], split, dtype), new_h, hist


def _attn_step(cfg: ArchConfig, p, x, kv, pos: int, cos, sin, span=None):
    """One token through an attention layer, writing its K/V (whole) into
    ring slot ``pos % w``; the live slots are ``min(pos + 1, w)``
    (``span``: the ``(w, lo)`` of a ring split over the ``sp`` group)."""
    b = x.shape[0]
    q, k, v, wo, split = _qkv(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cos, sin)
    w, lo = (kv["k"].shape[1], None) if span is None else span
    T._cache_write(kv, pos % w, lo, k[:, 0], v[:, 0])
    cache_len = torch.full((b,), min(pos + 1, w), dtype=torch.int32, device=x.device)
    o = T._cache_attention(q, kv, cfg, cache_len, lo)
    x = x + T._attn_out(o.reshape(b, 1, -1), wo, split, x.dtype)
    return _mlp_out(cfg, p, x)


def decode_step(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos, *,
                dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One new token for the whole batch at position ``pos`` (an int).
    Returns ``(logits (B, vocab), cache)``: the cache's tensors are written
    in place, as a donated buffer would be, and the returned dict holds them
    with ``len`` advanced by one."""
    pos = int(pos)
    x = T._embed(params, cfg, token[:, None], dtype)
    cos, sin = L.rope_table(torch.tensor([pos], device=x.device), cfg.hd, cfg.rope_theta)
    span = T._cache_span("attn")
    for c in range(n_cycles(cfg)):
        for j in range(2):
            x, cache["rec_h"][c, j], cache["rec_conv"][c, j] = _rec_step(
                cfg, L.block(params["rec"], (c, j)), x, cache["rec_h"][c, j],
                cache["rec_conv"][c, j])
        kv = {"k": cache["attn"]["k"][c], "v": cache["attn"]["v"][c]}
        x = _attn_step(cfg, L.block(params["attn"], c), x, kv, pos, cos, sin, span)
    for t in range(cache["tail_h"].shape[0] if "tail_h" in cache else 0):
        x, cache["tail_h"][t], cache["tail_conv"][t] = _rec_step(
            cfg, L.block(params["tail"], t), x, cache["tail_h"][t], cache["tail_conv"][t])
    return T._whole_logits(params, cfg, x)[:, 0], dict(cache, len=cache["len"] + 1)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Last-token logits (B, vocab) of the full forward (only the last row
    goes through the head)."""
    return T._whole_logits(params, cfg, _hidden(params, cfg, tokens, dtype)[:, -1])
