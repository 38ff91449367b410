"""Llama-3.2-Vision-11B backbone, port of ``repro.models.vision``: a llama
decoder with gated cross-attention image layers every ``cross_attn_every``
layers.

The vision encoder is a stub, as in the reference: the batch carries
precomputed patch embeddings ``patches`` (B, num_image_tokens, d_model).
Each of the ``n_layers / cross_attn_every`` cycles is one gated
cross-attention layer (``qk_norm``, output scaled by ``tanh(gate)``, the
gate zero at init) and ``cross_attn_every - 1`` self-attention blocks of
``models/transformer`` (``_block_init``, ``_block_apply``,
``_decode_block``), stacked ``(n_cycles, n_self)``.

``decode_step`` attends to the image K/V in the cache, which nothing in the
reference (or here) writes: served decoding attends to zeros, and agrees
with ``forward`` only because the gate is zero at init (ROADMAP C.11).

The reference's ``lax.scan`` over cycles and blocks is a Python loop here.
``cfg.remat`` checkpoints each cross-attention layer and each self block,
as the reference's ``jax.checkpoint`` does (``models/transformer.remat``,
whose docstring maps the policy).  ``param_specs`` and
``cache_specs`` are the reference's logical sharding specs, leaf for leaf
with ``init_params`` and ``init_cache`` (read by
:mod:`repro_torch.launch.steps`).

**Tensor parallelism** (a sharded step that splits the ``model`` row; see
:mod:`repro_torch.models.transformer`, whose helpers every layer here goes
through).  The self blocks, the vocab-parallel embedding, the head and the
loss split as the decoder-only transformer's.  The gated cross layer: its
input passes *f* (``tp.copy``) before ``lnx``; ``wq`` is column-parallel by
heads (``q_norm``/``k_norm`` act per head dim and stay whole); the image K/V
are projected with ``wk``/``wv`` whole and each rank's query heads read the
K/V heads they group with; ``wo`` is row-parallel and summed over the row,
and ``tanh(gate)`` scales that sum once (``gate`` takes its gradient over
the row's size, as everything computed whole on every rank does).  Decode
reads the cross K/V cache whole (heads replicated over ``model``) the same
way.  A head count the row does not divide is split unevenly (the
transformer's ``_attn_weights``), and a row of more ranks than heads
computes them replicated (``tp.note``).  Outside such a step the code computes as before,
bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "param_specs", "forward", "train_loss", "init_cache",
           "cache_specs", "prefill", "decode_step"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("cross", "selfs")


def _groups(cfg: ArchConfig) -> tuple[int, int]:
    p = cfg.cross_attn_every
    assert p > 1 and cfg.n_layers % p == 0
    return cfg.n_layers // p, p - 1      # (cycles, self layers per cycle)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], device) -> dict:
    """Random weights with the reference's nesting and scales
    (vision.py:34-53).  ``generator`` lives on ``device`` (``None`` on
    ``meta``)."""
    n_cyc, n_self = _groups(cfg)
    return {
        "embed": L._normal(generator, (cfg.vocab_padded, cfg.d_model), 0.02, device),
        "selfs": T._block_init(generator, cfg, (n_cyc, n_self), device),
        "cross": {"xattn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.hd, stack=(n_cyc,),
                                            qk_norm=True, device=device),
                  "lnx": L.init_rmsnorm(cfg.d_model, stack=(n_cyc,), device=device),
                  "gate": torch.zeros((n_cyc,), device=device)},
        "final_norm": L.init_rmsnorm(cfg.d_model, device=device),
        "lm_head": L.init_dense(generator, cfg.d_model, cfg.vocab_padded, device=device),
    }


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    return {"embed": ("tp", "fsdp"),
            "selfs": T._prepend_none(T._block_specs(cfg, stack=True)),
            "cross": {"xattn": L.attention_specs(True, qk_norm=True), "lnx": (None, None),
                      "gate": (None,)},
            "final_norm": (None,), "lm_head": ("fsdp", "tp")}


def _gated(p, x, o, wo, split: bool):
    """``x + tanh(gate) · (o @ wo)``: the cross layer's residual (``o @ wo``
    summed over the row first when ``split``)."""
    dtype = x.dtype
    return x + (torch.tanh(tp.replicated(p["gate"])).to(dtype)
                * T._attn_out(o, wo, split, dtype))


def _cross_q(p, x, cfg: ArchConfig, wq):
    """The normed queries of this rank's heads (``wq``'s columns)."""
    b, s, _ = x.shape
    xa = L.rms_norm(tp.copy(x), p["lnx"], cfg.norm_eps)
    q = (xa @ wq.to(x.dtype)).reshape(b, s, -1, cfg.hd)
    return L.rms_norm(q, p["xattn"]["q_norm"], cfg.norm_eps)


def _cross_apply(p, x, img, cfg: ArchConfig):
    b, s, _ = x.shape
    dtype = x.dtype
    hkv, hd = cfg.n_kv_heads, cfg.hd
    wq, wk, wv, wo, split = T._attn_weights(p["xattn"], cfg)
    q = _cross_q(p, x, cfg, wq)
    k = (img @ wk.to(dtype)).reshape(b, img.shape[1], hkv, hd)
    v = (img @ wv.to(dtype)).reshape(b, img.shape[1], hkv, hd)
    k = L.rms_norm(k, p["xattn"]["k_norm"], cfg.norm_eps)
    o = L.gqa_attention(q, *T._kv_for(k, v, cfg, q.shape[2]), causal=False)
    return _gated(p, x, o.reshape(b, s, -1), wo, split)


def _hidden(params, cfg: ArchConfig, batch, dtype):
    tokens = batch["tokens"]
    img = batch["patches"].to(dtype)
    x = tp.vocab_lookup(params["embed"], tokens).to(dtype)
    cos, sin = L.rope_table(torch.arange(tokens.shape[1], device=tokens.device), cfg.hd,
                            cfg.rope_theta)
    n_cyc, n_self = _groups(cfg)
    for c in range(n_cyc):
        x = T.remat(cfg, _cross_apply, L.BlockRef(params["cross"], c), x, img, cfg)
        for j in range(n_self):
            x, _ = T.remat(cfg, T._block_apply, L.BlockRef(params["selfs"], (c, j)), x, cfg,
                           window=None, cos=cos, sin=sin)
    return x


def forward(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16):
    """``batch`` holds ``tokens`` and ``patches`` -> (logits, aux 0)."""
    x = _hidden(params, cfg, batch, dtype)
    return T._head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch, dtype=dtype)
    return T._xent(logits, cfg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               *, device) -> dict:
    """Zero caches: the self blocks' K/V ``(n_cyc, n_self, B, max_len, Hkv,
    hd)`` and the image K/V ``(n_cyc, B, num_image_tokens, Hkv, hd)`` (left
    zero: ROADMAP C.11)."""
    n_cyc, n_self = _groups(cfg)
    kv = lambda *shape: {k: torch.zeros((*shape, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                                        device=device) for k in ("k", "v")}
    return {"selfs": kv(n_cyc, n_self, batch, max_len),
            "cross": kv(n_cyc, batch, cfg.num_image_tokens),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_cache`' tree."""
    kv2 = {"k": (None, None, "dp", "sp", None, None), "v": (None, None, "dp", "sp", None, None)}
    kv1 = {"k": (None, "dp", None, None, None), "v": (None, "dp", None, None, None)}
    return {"selfs": kv2, "cross": kv1, "len": ("dp",)}


def decode_step(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos, *,
                dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One new token for the whole batch at position ``pos`` (an int): each
    cycle's gated cross-attention against the cached image K/V, then its
    self blocks, whose K/V are written in place.  Returns ``(logits (B,
    vocab), cache)`` with ``len`` advanced by one."""
    pos = int(pos)
    b = token.shape[0]
    x = tp.vocab_lookup(params["embed"], token[:, None]).to(dtype)
    cos, sin = L.rope_table(torch.tensor([pos], device=x.device), cfg.hd, cfg.rope_theta)
    img_len = torch.full((b,), cache["cross"]["k"].shape[2], dtype=torch.int32,
                         device=x.device)
    n_cyc, n_self = _groups(cfg)
    span = T._cache_span("selfs")
    for c in range(n_cyc):
        p = L.block(params["cross"], c)
        wq, _, _, wo, split = T._attn_weights(p["xattn"], cfg, kv=False)
        q = _cross_q(p, x, cfg, wq)
        kv = T._kv_for(cache["cross"]["k"][c], cache["cross"]["v"][c], cfg, q.shape[2])
        x = _gated(p, x, L.decode_attention(q, *kv, img_len).reshape(b, 1, -1), wo, split)
        del p, wq, wo                # one block's parameters alive at a time
        for j in range(n_self):
            kv = {"k": cache["selfs"]["k"][c, j], "v": cache["selfs"]["v"][c, j]}
            x = T._decode_block(L.block(params["selfs"], (c, j)), x, kv, cfg, window=None,
                                pos=pos, cos=cos, sin=sin, span=span)
    return T._whole_logits(params, cfg, x)[:, 0], dict(cache, len=cache["len"] + 1)


def prefill(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Last-token logits (B, vocab) of the full forward (only the last row
    goes through the head)."""
    return T._whole_logits(params, cfg, _hidden(params, cfg, batch, dtype)[:, -1])
