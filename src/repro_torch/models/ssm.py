"""Mamba2 (SSD, state-space duality, arXiv:2405.21060), port of
``repro.models.ssm``.

Attention-free: no FlashOmni kernel lies on this path.  Block: in_proj ->
[z | x | B | C | dt]; causal depthwise conv on (x, B, C); chunked SSD;
gated RMSNorm; out_proj.  The chunked SSD follows the paper's block
decomposition: intra-chunk (quadratic in the chunk), chunk states, the
inter-chunk recurrence, the off-diagonal contribution.

Two departures in form, with the reference's values:

  * each of the reference's three-operand einsums is two contractions here
    (a weighting, then a batched matmul), so no ``(B, nc, c, c, H, P)``
    tensor is ever formed (4.3 GB a layer at 4096 tokens);
  * the intra-chunk decay takes ``exp`` of the differences with the masked
    upper triangle set to ``-inf`` (ROADMAP C.10).  The reference takes
    ``exp`` of every difference and then zeroes the upper triangle; past
    ≈ 128 tokens a chunk those ``exp`` overflow in f32 and its gradients
    turn NaN through ``0 · inf``.  The forward values are the same; the
    port's gradients are finite at every length.

The reference's ``lax.scan`` over layers and over chunk states is a Python
loop here.  ``cfg.remat`` checkpoints each block, as the reference's
``jax.checkpoint`` of its scan body does (``models/transformer.remat``,
whose docstring maps the policy).  ``param_specs`` and
``cache_specs`` are the reference's logical sharding specs, leaf for leaf
with ``init_params`` and ``init_cache`` (read by
:mod:`repro_torch.launch.steps`).

**Tensor parallelism** (a sharded step that splits the ``model`` row; see
:mod:`repro_torch.models.transformer`).  A block splits by SSD heads.
``in_proj`` ``(d_model, 2·d_inner + 2n + H)`` and ``conv`` ``(K, d_inner +
2n)`` are *packed*, so a contiguous ``tp`` shard of them does not fall on
heads: both are gathered over the row (``tp.gather``, whose backward sums
the row's partial gradients and cuts them to the shard; 18 MB a block at
mamba2-370m's width) and the rank computes with its columns ``[z_r | x_r |
B | C | dt_r]`` and ``[x_r | B | C]``, B and C whole on every rank (one
group).  ``a_log``, ``dt_bias``, ``d_skip``, ``norm`` and ``out_proj``'s
rows fall on heads as they are sharded; ``out_proj`` is row-parallel and
summed over the row.  The gated RMSNorm normalises over all of
``d_inner``: its mean square is the row's sum of the ranks' sums of
squares (one f32 ``(B, S, 1)`` sum a block, whose gradient sums over the
row too).  Decode splits the SSD state by heads, as ``cache_specs`` lays it
out; the packed conv window in the cache has the ``in_proj`` misalignment,
so it is gathered over the row and the rank's contiguous shard written
back.  The block's input passes *f* (``tp.copy``) before its norm; the
embedding, the head and the loss are vocab-parallel.  A head count the row
does not divide is gathered and computed replicated (``tp.note``).
Outside such a step the code computes as before, bit for bit.
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
           "cache_specs", "prefill", "decode_step", "ssd_chunked", "ssd_recurrent_step"]

# The top-level groups of stacked blocks, taken one block at a time through
# layers.block (every other leaf is read whole).
BLOCK_GROUPS = ("blocks",)

HEAD_DIM = 64
CONV_K = 4


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // HEAD_DIM, cfg.ssm_state


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, a_log, b, c, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD.  x (B,S,H,P); dt (B,S,H); a_log (H,) (A = -exp(a_log));
    b, c (B,S,N) single group.  Returns y (B,S,H,P)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    nc = s // chunk
    assert nc * chunk == s, f"seq {s} not divisible by chunk {chunk}"
    a = -torch.exp(a_log)                                  # (H,)
    xb = (x * dt[..., None]).reshape(bs, nc, chunk, h, p)  # dt-weighted input
    da = (dt * a).reshape(bs, nc, chunk, h)                # per-step log decay
    bb = b.reshape(bs, nc, chunk, n)
    cc = c.reshape(bs, nc, chunk, n)
    xh = xb.permute(0, 1, 3, 2, 4)                         # (B,nc,H,c,P)

    cum = torch.cumsum(da, dim=2)                          # (B,nc,c,H)
    # 1) intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, 0 above.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,c,c,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ldec = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    scores = torch.matmul(cc, bb.transpose(-1, -2))        # (B,nc,c,c)
    w = (scores[..., None] * ldec).permute(0, 1, 4, 2, 3)  # (B,nc,H,i,j)
    y_diag = torch.matmul(w, xh)                           # (B,nc,H,i,P)

    # 2) chunk-final states: sum_j exp(cum_last - cum_j) B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,c,H)
    u = xh * decay_to_end.permute(0, 1, 3, 2)[..., None]   # (B,nc,H,c,P)
    states = torch.matmul(u.transpose(-1, -2), bb[:, :, None])   # (B,nc,H,P,N)

    # 3) inter-chunk recurrence over chunk states, each emitted BEFORE its chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    st = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for k in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, k, :, None, None] + states[:, k].to(torch.float32)
    prev_states = torch.stack(prev, dim=1).to(cc.dtype)   # (B,nc,H,P,N)

    # 4) off-diagonal: y_off_i = C_i · (exp(cum_i) ⊙ prev_state)
    in_decay = torch.exp(cum).permute(0, 1, 3, 2)[..., None]      # (B,nc,H,c,1)
    y_off = torch.matmul(cc[:, :, None], prev_states.transpose(-1, -2)) * in_decay
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bs, s, h, p)
    return y.to(x.dtype)


def ssd_recurrent_step(state, x_t, dt_t, a_log, b_t, c_t):
    """One-token SSD update.  state (B,H,P,N); x_t (B,H,P); dt_t (B,H);
    b_t, c_t (B,N).  Returns (y_t, new_state)."""
    decay = torch.exp(dt_t * (-torch.exp(a_log)))          # (B,H)
    incr = (x_t * dt_t[..., None])[..., None] * b_t[:, None, None, :]
    new_state = state * decay[..., None, None] + incr
    y = torch.matmul(new_state, c_t[:, None, :, None])[..., 0]
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Block / model
# ---------------------------------------------------------------------------

def _init_blocks(cfg: ArchConfig, generator, device) -> dict:
    d_inner, h, n = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * n + h
    sh = lambda *dims: (cfg.n_layers, *dims)
    return {
        "in_proj": L._normal(generator, sh(cfg.d_model, d_in_proj), cfg.d_model ** -0.5,
                             device),
        "conv": L._normal(generator, sh(CONV_K, d_inner + 2 * n), 0.2, device),
        "a_log": torch.zeros(sh(h), device=device),
        "dt_bias": torch.zeros(sh(h), device=device),
        "d_skip": torch.ones(sh(h), device=device),
        "norm": torch.ones(sh(d_inner), device=device),
        "out_proj": L._normal(generator, sh(d_inner, cfg.d_model), d_inner ** -0.5, device),
        "ln": torch.ones(sh(cfg.d_model), device=device),
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], device) -> dict:
    """Random weights with the reference's nesting, stacked ``(n_layers, ...)``
    block shapes and scales (ssm.py:109-117).  ``generator`` lives on
    ``device`` (``None`` on ``meta``, which allocates nothing)."""
    return {
        "embed": L._normal(generator, (cfg.vocab_padded, cfg.d_model), 0.02, device),
        "blocks": _init_blocks(cfg, generator, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=device),
        "lm_head": L.init_dense(generator, cfg.d_model, cfg.vocab_padded, device=device),
    }


def _block_specs(stack: bool) -> dict:
    b = (None,) if stack else ()
    return {"in_proj": (*b, "fsdp", "tp"), "conv": (*b, None, "tp"),
            "a_log": (*b, "tp"), "dt_bias": (*b, "tp"), "d_skip": (*b, "tp"),
            "norm": (*b, "tp"), "out_proj": (*b, "tp", "fsdp"), "ln": (*b, None)}


def param_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_params`' tree."""
    return {"embed": ("tp", "fsdp"), "blocks": _block_specs(True),
            "final_norm": (None,), "lm_head": ("fsdp", "tp")}


_HEAD_LEAVES = ("a_log", "dt_bias", "d_skip", "norm")


def _local(cfg: ArchConfig, p) -> tuple:
    """``(p, di, hl, split)``: the block's leaves as this rank computes with
    them, its ``d_inner`` and heads.  On a model row that divides the heads
    (``split``), ``in_proj`` and ``conv`` gathered over the row and cut to
    the rank's columns ``[z_r | x_r | B | C | dt_r]`` and ``[x_r | B | C]``;
    on one that does not, every ``tp`` leaf gathered whole."""
    d_inner, h, n = _dims(cfg)
    m = tp.size()
    split = tp.divides(h, "SSD heads")
    if m == 1:
        return p, d_inner, h, split
    if not split:
        return dict(p, in_proj=tp.gather(p["in_proj"], -1), conv=tp.gather(p["conv"], -1),
                    out_proj=tp.gather(p["out_proj"], -2),
                    **{k: tp.gather(p[k], -1) for k in _HEAD_LEAVES}), d_inner, h, split
    di, hl, r = d_inner // m, h // m, tp.rank()
    w, c = tp.gather(p["in_proj"], -1), tp.gather(p["conv"], -1)
    z, x = slice(r * di, (r + 1) * di), slice(d_inner + r * di, d_inner + (r + 1) * di)
    bc, dt = slice(2 * d_inner, 2 * d_inner + 2 * n), slice(2 * d_inner + 2 * n + r * hl,
                                                            2 * d_inner + 2 * n + (r + 1) * hl)
    w = torch.cat([w[..., z], w[..., x], w[..., bc], w[..., dt]], dim=-1)
    c = torch.cat([c[..., r * di:(r + 1) * di], c[..., d_inner:]], dim=-1)
    return dict(p, in_proj=w, conv=c), di, hl, split


def _split_proj(proj, di: int, n: int, hl: int):
    """``(z, xBC, dt)`` of ``in_proj``'s output ``[z | x | B | C | dt]``
    (``di`` channels of z and x, ``hl`` heads)."""
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., -hl:]


def _row_rms_norm(x, scale, d: int, eps: float) -> torch.Tensor:
    """:func:`layers.rms_norm` over a ``d``-wide dim of which ``x`` holds
    the rank's share: the mean square from the row's sum of squares, whose
    gradient is summed over the row as well (each rank's share of the
    output depends on every rank's input)."""
    xf = x.to(torch.float32)
    ss = tp.copy(tp.reduce(xf.square().sum(dim=-1, keepdim=True)))
    return (xf * torch.rsqrt(ss / d + eps) * scale).to(x.dtype)


def _mix(cfg: ArchConfig, p, res, xs, z, y, split: bool):
    """The skip term, the gated RMSNorm and out_proj around the SSD's ``y``
    (f32, (B, S, H, P)); returns the block's output in ``res``' dtype."""
    d_inner = _dims(cfg)[0]
    y = y + xs.to(torch.float32) * p["d_skip"][:, None]
    y = y.reshape(*res.shape[:2], -1).to(res.dtype)
    if split:
        y = _row_rms_norm(y * F.silu(z), p["norm"], d_inner, cfg.norm_eps)
    else:
        y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)          # gated norm
    return res + T._attn_out(y, p["out_proj"], split, res.dtype)


def _block_apply(cfg: ArchConfig, p, x, *, chunk: int = 128):
    n = cfg.ssm_state
    dtype = x.dtype
    p, di, hl, split = _local(cfg, p)
    xn = L.rms_norm(tp.copy(x), p["ln"], cfg.norm_eps)
    z, xbc, dt = _split_proj(xn @ p["in_proj"].to(dtype), di, n, hl)
    xbc = F.silu(L.causal_conv(xbc, p["conv"].to(dtype)))
    xs = xbc[..., :di].reshape(*x.shape[:2], hl, HEAD_DIM)
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    y = ssd_chunked(xs.to(torch.float32), dt, p["a_log"], b.to(torch.float32),
                    c.to(torch.float32), chunk=chunk)
    return _mix(cfg, p, x, xs, z, y, split)


def _hidden(params, cfg: ArchConfig, tokens, dtype, chunk):
    x = tp.vocab_lookup(params["embed"], tokens).to(dtype)
    for i in range(cfg.n_layers):
        x = T.remat(cfg, _block_apply, cfg, L.BlockRef(params["blocks"], i), x, chunk=chunk)
    return x


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16, chunk: int = 128):
    """Full forward -> (logits, aux 0).  tokens (B, S) int; S a multiple of
    ``min(chunk, S)``."""
    x = _hidden(params, cfg, tokens, dtype, chunk)
    return T._head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"], dtype=dtype)
    return T._xent(logits, cfg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: constant-size recurrent decode state
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               *, device) -> dict:
    """Zero decode state: the SSD state (L, B, H, P, N) in f32 and the last
    ``CONV_K - 1`` conv inputs (L, B, K-1, C).  ``max_len`` does not size it."""
    d_inner, h, n = _dims(cfg)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, h, HEAD_DIM, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, batch, CONV_K - 1, d_inner + 2 * n), dtype=dtype,
                            device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical specs of :func:`init_cache`' tree."""
    return {"ssm": (None, "dp", "tp", None, None),
            "conv": (None, "dp", None, "tp"), "len": ("dp",)}


def _conv_window(cfg: ArchConfig, conv, di: int, split: bool):
    """The packed conv window ``(B, K-1, ·)`` as the rank computes with it:
    on a model row, the cache's contiguous shard gathered whole and, when
    ``split``, cut to the rank's ``[x_r | B | C]``."""
    if tp.size() == 1:
        return conv
    d_inner = _dims(cfg)[0]
    whole = tp.all_gather(conv, -1)
    if not split:
        return whole
    r = tp.rank()
    return torch.cat([whole[..., r * di:(r + 1) * di], whole[..., d_inner:]], dim=-1)


def _conv_shard(cfg: ArchConfig, window, di: int, split: bool):
    """The rank's contiguous shard of the packed conv window that
    :func:`_conv_window` took (its ``x`` channels gathered over the row when
    ``split``; B and C are every rank's)."""
    if tp.size() == 1:
        return window
    if split:
        window = torch.cat([tp.all_gather(window[..., :di], -1), window[..., di:]], dim=-1)
    return tp.shard(window, -1)


def _decode_block(cfg: ArchConfig, p, x, ssm, conv):
    """One token through one block; returns (x, new ssm state, new conv
    window), the state the rank's heads (gathered whole and cut back on a
    row that computes the block replicated)."""
    n = cfg.ssm_state
    dtype = x.dtype
    p, di, hl, split = _local(cfg, p)
    if tp.size() > 1 and not split:
        ssm = tp.all_gather(ssm, 1)
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt = _split_proj(xn @ p["in_proj"].to(dtype), di, n, hl)
    hist = torch.cat([_conv_window(cfg, conv, di, split), xbc], dim=1)    # (B, K, C)
    xbc = F.silu((hist * p["conv"].to(dtype)).sum(dim=1))
    xs = xbc[:, :di].reshape(-1, hl, HEAD_DIM)
    dtq = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
    y, new_ssm = ssd_recurrent_step(ssm, xs.to(torch.float32), dtq, p["a_log"],
                                    xbc[:, di:di + n].to(torch.float32),
                                    xbc[:, di + n:].to(torch.float32))
    if tp.size() > 1 and not split:
        new_ssm = tp.shard(new_ssm, 1)
    return (_mix(cfg, p, x, xs[:, None], z, y[:, None], split), new_ssm,
            _conv_shard(cfg, hist[:, 1:], di, split))


def decode_step(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos, *,
                dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One new token for the whole batch.  Returns ``(logits (B, vocab),
    cache)``: the cache's state tensors are written in place, as a donated
    buffer would be, and the returned dict holds them with ``len`` advanced
    by one.  ``pos`` does not enter the recurrence."""
    x = tp.vocab_lookup(params["embed"], token[:, None]).to(dtype)
    for i in range(cfg.n_layers):
        x, cache["ssm"][i], cache["conv"][i] = _decode_block(
            cfg, L.block(params["blocks"], i), x, cache["ssm"][i], cache["conv"][i])
    return T._whole_logits(params, cfg, x)[:, 0], dict(cache, len=cache["len"] + 1)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Last-token logits (B, vocab) of the full forward (only the last row
    goes through the head)."""
    return T._whole_logits(params, cfg, _hidden(params, cfg, tokens, dtype, 128)[:, -1])
