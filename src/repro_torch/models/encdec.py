"""Whisper-large-v3 backbone (arXiv:2212.04356), port of
``repro.models.encdec``: an encoder-decoder transformer.

The conv audio frontend is a stub, as in the reference: the batch carries
precomputed mel-frame embeddings ``frames`` (B, encoder_len, d_model).
Both stacks are pre-LN transformers (LayerNorm in f32, eps 1e-5, and a
GELU MLP with biases in its tanh form, ``jax.nn.gelu``'s default); the
decoder adds cross-attention to the encoder's output.

``decode_step`` reads the cross-attention K/V from the cache, and nothing
in the reference (or here) writes them: ``init_cache`` leaves them zero,
so served decoding attends to zeros (ROADMAP C.11).  The port reproduces
this; it does not fix it.

The reference's ``lax.scan`` over layers is a Python loop here.
``cfg.remat`` checkpoints each encoder and each decoder block, as the
reference's ``jax.checkpoint`` of its scan bodies does
(``models/transformer.remat``, whose docstring maps the policy).
``param_specs`` and ``cache_specs`` are the reference's logical sharding
specs, leaf for leaf with ``init_params`` and ``init_cache`` (read by
:mod:`repro_torch.launch.steps`).

**Tensor parallelism** (a sharded step that splits the ``model`` row; see
:mod:`repro_torch.models.transformer`, whose helpers the attention goes
through).  The encoder's and the decoder's self-attention and the decoder's
cross attention (:func:`_mha`) split ``wq``/``wo`` by heads, ``wo``
row-parallel and summed over the row; K/V are projected on the rank's own
K/V heads where they divide the row (their ``wk``/``wv`` shards), else
whole.  Decode projects the self K/V whole, as the cache holds every head,
and reads the rank's heads of both caches.  The MLP's ``wi``/``bi`` are
column-parallel and ``wo`` row-parallel; ``bo`` is added once, after the
sum.  The LayerNorms are whole, each sublayer's input (and the encoder's
output norm's) passing *f* (``tp.copy``) first; the tied ``tok_embed`` is a
vocab-parallel lookup and head, with the vocab-parallel loss; the position
tables and ``bo``, added whole on every rank, take their gradients over the
row's size.  A head count the row does not divide is split unevenly, as
``torch.tensor_split`` splits it (whisper-large-v3's 20 heads on a row of
16: 2 on 4 ranks, 1 on 12), K/V whole; a row of more ranks than heads, or
a ``d_ff`` the row does not divide, is gathered and computed replicated
(``tp.note``).  Outside such a step the code computes as before, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["layer_norm", "init_params", "param_specs", "forward", "train_loss", "encode",
           "decode_train", "init_cache", "cache_specs", "prefill", "decode_step"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("enc", "dec")

POS_DEC_ROWS = 32768


def layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def _init_ln(d: int, stack: tuple = (), *, device) -> dict:
    return {"scale": torch.ones((*stack, d), device=device),
            "bias": torch.zeros((*stack, d), device=device)}


def _init_vanilla_mlp(generator, d: int, ff: int, stack: tuple = (), *, device) -> dict:
    return {"wi": L.init_dense(generator, d, ff, stack=stack, device=device),
            "bi": torch.zeros((*stack, ff), device=device),
            "wo": L.init_dense(generator, ff, d, stack=stack, device=device),
            "bo": torch.zeros((*stack, d), device=device)}


def _vanilla_mlp(p, x, cfg: ArchConfig):
    dtype = x.dtype
    split = tp.divides(cfg.d_ff, "MLP d_ff")
    if tp.size() > 1 and not split:
        p = dict(p, wi=tp.gather(p["wi"], -1), bi=tp.gather(p["bi"], -1),
                 wo=tp.gather(p["wo"], -2))
    h = F.gelu(x @ p["wi"].to(dtype) + p["bi"].to(dtype), approximate="tanh")
    return T._attn_out(h, p["wo"], split, dtype) + tp.replicated(p["bo"]).to(dtype)


def _init_block(cfg: ArchConfig, generator, stack: tuple, cross: bool, device) -> dict:
    attn = lambda: L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, stack=stack, device=device)
    p = {"attn": attn(), "ln1": _init_ln(cfg.d_model, stack, device=device),
         "mlp": _init_vanilla_mlp(generator, cfg.d_model, cfg.d_ff, stack, device=device),
         "ln2": _init_ln(cfg.d_model, stack, device=device)}
    if cross:
        p["xattn"] = attn()
        p["lnx"] = _init_ln(cfg.d_model, stack, device=device)
    return p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], device) -> dict:
    """Random weights with the reference's nesting and scales
    (encdec.py:84-98): ``n_layers`` encoder and ``n_layers`` decoder blocks,
    each stack ``(n_layers, ...)``; ``pos_dec`` has 32 768 rows.
    ``generator`` lives on ``device`` (``None`` on ``meta``)."""
    n = (cfg.n_layers,)
    emb = lambda rows: L._normal(generator, (rows, cfg.d_model), 0.02, device)
    return {
        "tok_embed": emb(cfg.vocab_padded),
        "pos_enc": emb(cfg.encoder_len),
        "pos_dec": emb(POS_DEC_ROWS),
        "enc": _init_block(cfg, generator, n, False, device),
        "dec": _init_block(cfg, generator, n, True, device),
        "ln_enc": _init_ln(cfg.d_model, device=device),
        "ln_dec": _init_ln(cfg.d_model, device=device),
    }


def _block_specs(cross: bool) -> dict:
    ln = {"scale": (None, None), "bias": (None, None)}
    mlp = {"wi": (None, "fsdp", "tp"), "bi": (None, "tp"),
           "wo": (None, "tp", "fsdp"), "bo": (None, None)}
    s = {"attn": L.attention_specs(True), "ln1": ln, "mlp": mlp, "ln2": ln}
    if cross:
        s["xattn"] = L.attention_specs(True)
        s["lnx"] = ln
    return s


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    ln0 = {"scale": (None,), "bias": (None,)}
    return {"tok_embed": ("tp", "fsdp"), "pos_enc": (None, "fsdp"), "pos_dec": (None, "fsdp"),
            "enc": _block_specs(cross=False), "dec": _block_specs(cross=True),
            "ln_enc": ln0, "ln_dec": ln0}


def _mha_weights(p, cfg: ArchConfig) -> tuple:
    """``(wq, wk, wv, wo, split)``: on a model row that divides the K/V
    heads, the rank's shards of all four (its K/V heads are the ones its
    query heads read), else the transformer's (K/V whole, the query heads
    split unevenly where the row does not divide them)."""
    m = tp.size()
    if m > 1 and cfg.n_kv_heads % m == 0 and cfg.n_heads % m == 0:
        return p["wq"], p["wk"], p["wv"], p["wo"], True
    return T._attn_weights(p, cfg)


def _mha(p, x, kv_src, cfg: ArchConfig, *, causal: bool):
    b, s, _ = x.shape
    dtype = x.dtype
    hd = cfg.hd
    wq, wk, wv, wo, split = _mha_weights(p, cfg)
    q = (x @ wq.to(dtype)).reshape(b, s, -1, hd)
    k = (kv_src @ wk.to(dtype)).reshape(b, kv_src.shape[1], -1, hd)
    v = (kv_src @ wv.to(dtype)).reshape(b, kv_src.shape[1], -1, hd)
    if k.shape[2] == cfg.n_kv_heads:
        k, v = T._kv_for(k, v, cfg, q.shape[2])
    o = L.gqa_attention(q, k, v, causal=causal)
    return T._attn_out(o.reshape(b, s, -1), wo, split, dtype)


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor, *,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """frames: (B, encoder_len, d_model), the precomputed frontend output."""
    x = frames.to(dtype) + tp.replicated(params["pos_enc"]).to(dtype)
    for i in range(cfg.n_layers):
        x = T.remat(cfg, _enc_block, L.BlockRef(params["enc"], i), x, cfg)
    return _ln(tp.copy(x), params["ln_enc"])


def _enc_block(p, x, cfg: ArchConfig):
    xa = _ln(tp.copy(x), p["ln1"])
    x = x + _mha(p["attn"], xa, xa, cfg, causal=False)
    return x + _vanilla_mlp(p["mlp"], _ln(tp.copy(x), p["ln2"]), cfg)


def _dec_block(p, x, enc_out, cfg: ArchConfig):
    xa = _ln(tp.copy(x), p["ln1"])
    x = x + _mha(p["attn"], xa, xa, cfg, causal=True)
    x = x + _mha(p["xattn"], _ln(tp.copy(x), p["lnx"]), enc_out, cfg, causal=False)
    return x + _vanilla_mlp(p["mlp"], _ln(tp.copy(x), p["ln2"]), cfg)


def _decoder_hidden(params, cfg: ArchConfig, tokens, enc_out, dtype):
    x = (tp.vocab_lookup(params["tok_embed"], tokens).to(dtype)
         + tp.replicated(params["pos_dec"][:tokens.shape[1]]).to(dtype))
    for i in range(cfg.n_layers):
        x = T.remat(cfg, _dec_block, L.BlockRef(params["dec"], i), x, enc_out, cfg)
    return x


def _head(params, cfg: ArchConfig, x):
    """``ln_dec`` and the tied head; on a model row, this rank's shard of
    the padded vocabulary."""
    x = _ln(tp.copy(x), params["ln_dec"])
    logits = x @ params["tok_embed"].T.to(x.dtype)
    if tp.size() > 1:
        return logits
    return logits[..., :cfg.vocab] if cfg.vocab_padded != cfg.vocab else logits


def decode_train(params: dict, cfg: ArchConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
                 *, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The decoder's logits (B, S, vocab) over ``tokens`` against ``enc_out``
    (on a model row, the rank's shard of the padded vocabulary)."""
    return _head(params, cfg, _decoder_hidden(params, cfg, tokens, enc_out, dtype))


def forward(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16):
    """``batch`` holds ``frames`` and ``tokens`` -> (logits, aux 0)."""
    enc_out = encode(params, cfg, batch["frames"], dtype=dtype)
    logits = decode_train(params, cfg, batch["tokens"], enc_out, dtype=dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch, dtype=dtype)
    return T._xent(logits, cfg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               *, device) -> dict:
    """Zero caches ``(n_layers, B, length, Hkv, hd)``: the decoder's
    self-attention K/V of ``max_len`` slots and the cross-attention K/V of
    ``encoder_len`` (left zero: ROADMAP C.11)."""
    kv = lambda length: {
        k: torch.zeros((cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                       device=device) for k in ("k", "v")}
    return {"self": kv(max_len), "cross": kv(cfg.encoder_len),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_cache`' tree; the cross K/V's
    ``encoder_len`` (1500) divides no mesh axis, so it shards on batch
    only."""
    kv = {"k": (None, "dp", "sp", None, None), "v": (None, "dp", "sp", None, None)}
    xkv = {"k": (None, "dp", None, None, None), "v": (None, "dp", None, None, None)}
    return {"self": kv, "cross": xkv, "len": ("dp",)}


def decode_step(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos, *,
                dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One decoder token at position ``pos`` (an int) against the cached
    cross K/V.  The self K/V go to slot ``min(pos, max_len - 1)`` (past
    ``max_len`` the last slot is overwritten, as in the reference) and are
    written in place (inside a decode step that splits the self cache's
    sequence over ``sp``, on the rank that holds the slot); returns
    ``(logits (B, vocab), cache)`` with ``len`` advanced by one."""
    pos = int(pos)
    b = token.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    row = min(pos, params["pos_dec"].shape[0] - 1)         # dynamic_index_in_dim clamps
    x = (tp.vocab_lookup(params["tok_embed"], token[:, None]).to(dtype)
         + params["pos_dec"][row:row + 1].to(dtype))
    span = T._cache_span("self")
    length, lo = (cache["self"]["k"].shape[2], None) if span is None else span
    slot = min(pos, length - 1)
    self_len = torch.full((b,), min(pos + 1, length), dtype=torch.int32, device=x.device)
    cross_len = torch.full((b,), cache["cross"]["k"].shape[2], dtype=torch.int32,
                           device=x.device)
    for i in range(cfg.n_layers):
        p = L.block(params["dec"], i)
        kc, vc = cache["self"]["k"][i], cache["self"]["v"][i]
        xa = _ln(x, p["ln1"])
        wq, wk, wv, wo, split = T._attn_weights(p["attn"], cfg)
        q = (xa @ wq.to(dtype)).reshape(b, 1, -1, hd)
        kv = {"k": kc, "v": vc}
        T._cache_write(kv, slot, lo, (xa @ wk.to(dtype)).reshape(b, hkv, hd),
                       (xa @ wv.to(dtype)).reshape(b, hkv, hd))
        o = T._cache_attention(q, kv, cfg, self_len, lo)
        x = x + T._attn_out(o.reshape(b, 1, -1), wo, split, dtype)
        wq, _, _, wo, split = T._attn_weights(p["xattn"], cfg, kv=False)
        qx = (_ln(x, p["lnx"]) @ wq.to(dtype)).reshape(b, 1, -1, hd)
        kv = T._kv_for(cache["cross"]["k"][i], cache["cross"]["v"][i], cfg, qx.shape[2])
        ox = L.decode_attention(qx, *kv, cross_len)
        x = x + T._attn_out(ox.reshape(b, 1, -1), wo, split, dtype)
        x = x + _vanilla_mlp(p["mlp"], _ln(x, p["ln2"]), cfg)
        del p, wq, wk, wv, wo        # one block's parameters alive at a time
    return T._whole_logits(params, cfg, x, _head)[:, 0], dict(cache, len=cache["len"] + 1)


def prefill(params: dict, cfg: ArchConfig, batch: dict, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Last-token logits (B, vocab) of the full forward (only the last row
    goes through the head)."""
    enc_out = encode(params, cfg, batch["frames"], dtype=dtype)
    x = _decoder_hidden(params, cfg, batch["tokens"], enc_out, dtype)
    return T._whole_logits(params, cfg, x[:, -1], _head)
