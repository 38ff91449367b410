"""Long-context LM decode with FlashOmni block-sparse KV selection, port of
``examples/long_context_lm.py``.

The LM-serving adaptation of the paper's ``S_s`` symbol: a decode step
reads only the KV-cache blocks most relevant to the current query, scored
by the query against each block's mean-pooled keys, and stays close to full
attention at a fraction of the cache reads (the mechanism behind the
``long_500k`` cells).  :func:`select_and_attend` is the example's whole
body: ``pool_tokens``, the ``q · pooled-key`` scores, ``clamp_mask_topk``
(on equal scores the lower block index wins), ``active_indices``,
``sparse_decode_attention`` and the dense softmax attention it is held to.
No Pallas kernel lies on this path (the reference runs XLA code here), so
the port runs torch ops and launches none of B1-B7.

Usage:

    python -m repro_torch.long_context_lm [--context S] [--device cpu]

The defaults are the example's size (B=2, H=4, S=8192, head_dim 64, blocks
of 64 tokens, 25 % of them kept).  It runs on the card unless given
``--device cpu`` and raises when asked for the card without one.  As in the
example, no ``cache_len`` is passed: every cache slot is filled.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional

import torch

from repro_torch.core.attention import sparse_decode_attention
from repro_torch.core.masks import pool_tokens
from repro_torch.core.symbols import active_indices, clamp_mask_topk
from repro_torch.launch.serve import resolve_device

__all__ = ["Decode", "make_inputs", "select_and_attend", "main"]

# The example's size: batch, heads, context, head_dim, block, kept share.
DEFAULTS = dict(b=2, h=4, s=8192, dh=64, block=64, keep_frac=0.25)
# The planted structure: this share of blocks is query-aligned.
HOT_FRAC = 0.12


class Decode(NamedTuple):
    kv_ids: torch.Tensor      # (BH, cap) int32, ascending block ids
    kv_cnt: torch.Tensor      # (BH,) int32
    sparse: torch.Tensor      # (BH, 1, dh)
    dense: torch.Tensor       # (BH, 1, dh)
    rel: float                # ‖sparse − dense‖ / ‖dense‖


def make_inputs(b: int, h: int, s: int, dh: int, block: int, *, seed: int = 0,
                device="cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q (BH, 1, dh), k_cache (BH, S, dh), v_cache (BH, S, dh))`` in f32
    from ``seed``, with the example's planted structure: a Bernoulli(0.12)
    draw marks query-aligned blocks, whose keys become ``k·0.3 + q·1.2``;
    every other key is ``k·0.3``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bh = b * h
    k_cache = torch.randn((bh, s, dh), generator=g, device=device)
    v_cache = torch.randn((bh, s, dh), generator=g, device=device)
    q = torch.randn((bh, 1, dh), generator=g, device=device)
    hot = torch.rand((bh, s // block), generator=g, device=device) < HOT_FRAC
    hot_tok = hot.repeat_interleave(block, dim=-1)[..., None]
    k_cache.mul_(0.3).add_(torch.where(hot_tok, q * 1.2, 0.0))
    return q, k_cache, v_cache


def keep_cap(t: int, keep_frac: float) -> int:
    """The example's block budget: ``max(int(t · keep_frac), 1)``."""
    return max(int(t * keep_frac), 1)


def select_blocks(q: torch.Tensor, k_cache: torch.Tensor, *, block: int,
                  keep_frac: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(kv_ids, kv_cnt)``: the top ``keep_cap`` blocks of each row by the
    query's score against the block's mean-pooled keys."""
    kp = pool_tokens(k_cache, block)                              # (BH, T, dh)
    scores = torch.einsum("bnd,btd->bt", q[:, 0:1], kp)           # (BH, T)
    cap = keep_cap(scores.shape[-1], keep_frac)
    keep = clamp_mask_topk(torch.ones_like(scores, dtype=torch.bool), scores, cap)
    return active_indices(keep, cap)


def dense_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Full softmax attention of the new token over the whole cache."""
    s = torch.einsum("bnd,bsd->bns", q, k_cache) * q.shape[-1] ** -0.5
    return torch.einsum("bns,bsd->bnd", torch.softmax(s, dim=-1), v_cache)


def select_and_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                      block: int = DEFAULTS["block"],
                      keep_frac: float = DEFAULTS["keep_frac"]) -> Decode:
    """The example's body on ``q`` (BH, 1, dh) and caches (BH, S, dh):
    block selection, the sparse decode over the kept blocks, the dense
    decode and the relative error between them."""
    kv_ids, kv_cnt = select_blocks(q, k_cache, block=block, keep_frac=keep_frac)
    sparse = sparse_decode_attention(q, k_cache, v_cache, kv_ids, kv_cnt, block)
    dense = dense_decode(q, k_cache, v_cache)
    rel = float(torch.linalg.norm(sparse - dense) / torch.linalg.norm(dense))
    return Decode(kv_ids, kv_cnt, sparse, dense, rel)


def main(argv: Optional[list] = None) -> Decode:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--context", type=int, default=DEFAULTS["s"],
                    help="cache length in tokens (a multiple of the block)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, h, dh, block, keep_frac = (DEFAULTS[k] for k in ("b", "h", "dh", "block", "keep_frac"))
    if args.context % block:
        raise ValueError(f"--context {args.context} is not a multiple of the block {block}")
    q, k_cache, v_cache = make_inputs(b, h, args.context, dh, block, device=device)
    out = select_and_attend(q, k_cache, v_cache, block=block, keep_frac=keep_frac)
    print(f"context {args.context} tokens, reading {keep_frac:.0%} of KV blocks")
    print(f"relative error vs full attention: {out.rel:.4f}")
    print(f"cache reads reduced {1 / keep_frac:.0f}x "
          f"(decode is HBM-bound -> ~{1 / keep_frac:.0f}x step speedup)")
    return out


if __name__ == "__main__":
    main()
