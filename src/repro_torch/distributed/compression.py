"""Gradient compression with error feedback, port of
``repro.distributed.compression``.

Two schemes, both carrying the residual of the compression to the next step
(error feedback, Karimireddy et al. 2019), so that the compressed optimizer
converges to the same point:

  * ``int8``: per-tensor symmetric quantization (4x less all-reduce traffic);
  * ``topk``: magnitude top-k sparsification (k = a fraction of the entries).

Usage inside a train step, where a data-parallel all-reduce would move the
compressed payload:

    comp, err = compress_tree(grads, err, scheme)
    grads = decompress_tree(comp)

Ties: ``lax.top_k`` keeps the lower index among equal magnitudes, and
``torch.topk`` promises no order, so :func:`compress_topk` takes a stable
descending sort.  ``jnp.round`` and ``torch.round`` both round half to even.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["init_error_state", "Int8Grad", "compress_int8", "decompress_int8", "TopKGrad",
           "compress_topk", "decompress_topk", "compress_tree", "decompress_tree"]


def init_error_state(tree: Any) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


class Int8Grad(NamedTuple):
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # () f32


def compress_int8(g: torch.Tensor, err: torch.Tensor) -> tuple[Int8Grad, torch.Tensor]:
    gf = g.to(torch.float32) + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return Int8Grad(q=q, scale=scale), new_err


def decompress_int8(c: Int8Grad) -> torch.Tensor:
    return c.q.to(torch.float32) * c.scale


class TopKGrad(NamedTuple):
    values: torch.Tensor     # (k,) f32
    indices: torch.Tensor    # (k,) int32
    shape: tuple


def compress_topk(g: torch.Tensor, err: torch.Tensor, frac: float = 0.05
                  ) -> tuple[TopKGrad, torch.Tensor]:
    gf = (g.to(torch.float32) + err).reshape(-1)
    k = max(1, int(gf.numel() * frac))
    # Stable ascending sort of -|gf| == descending by |gf|, ties in index order.
    idx = torch.argsort(-gf.abs(), stable=True)[:k]
    picked = gf[idx]
    new_err = gf.index_fill(0, idx, 0.0).reshape(g.shape)
    return TopKGrad(values=picked, indices=idx.to(torch.int32),
                    shape=tuple(g.shape)), new_err


def decompress_topk(c: TopKGrad) -> torch.Tensor:
    n = 1
    for d in c.shape:
        n *= d
    out = torch.zeros((n,), dtype=torch.float32, device=c.values.device)
    out[c.indices.long()] = c.values
    return out.reshape(c.shape)


def compress_tree(grads: Any, err_state: Any, scheme: str = "int8",
                  **kw) -> tuple[Any, Any]:
    """Compress every leaf; returns (compressed_tree, new_error_state)."""
    fn = {"int8": compress_int8,
          "topk": functools.partial(compress_topk, **kw)}[scheme]
    flat_g, tdef = tree_flatten(grads)
    flat_e = tree_flatten(err_state)[0]
    out = [fn(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(tdef, [o[0] for o in out]),
            tree_unflatten(tdef, [o[1] for o in out]))


def decompress_tree(comp: Any) -> Any:
    def dec(c):
        if isinstance(c, Int8Grad):
            return decompress_int8(c)
        if isinstance(c, TopKGrad):
            return decompress_topk(c)
        raise TypeError(type(c))
    return tree_map(dec, comp, is_leaf=lambda x: isinstance(x, (Int8Grad, TopKGrad)))
