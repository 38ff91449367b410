"""Sparse-symbol producers, port of ``repro.core.strategy``.

A strategy maps the Update-step Q/K plus a :class:`StrategyContext` to a
:class:`SymbolSet`: packed ``s_c``/``s_s``, the post-clamp boolean masks and
the ranking scores the static-capacity clamp used.  The registry keeps the
reference's names; only ``flashomni`` (the paper's §3.3 rule) is ported so
far, and the other built-ins raise when they are asked for.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Protocol, Union

import torch

from repro_torch.core import masks as masklib
from repro_torch.core.symbols import clamp_mask_topk, pack_bits

__all__ = [
    "StrategyContext",
    "SymbolSet",
    "SparsityStrategy",
    "finalize_symbols",
    "register_strategy",
    "get_strategy",
    "available_strategies",
    "FlashOmniStrategy",
]


class StrategyContext(NamedTuple):
    """Per-call context handed to ``emit`` (host values in the port)."""

    cfg: Any
    n_text: int
    n_tokens: int
    layer_idx: Optional[int] = None
    step_idx: Optional[int] = None
    num_steps: Optional[int] = None


class SymbolSet(NamedTuple):
    """Packed symbols + post-clamp masks (B, H, T) / (B, H, T, T) + the
    clamp-ranking scores."""

    s_c: torch.Tensor
    s_s: torch.Tensor
    m_c: torch.Tensor
    m_s: torch.Tensor
    q_scores: torch.Tensor
    kv_scores: torch.Tensor


class SparsityStrategy(Protocol):
    """Anything that can produce packed sparse symbols from Update Q/K."""

    name: str

    def emit(self, q: torch.Tensor, k: torch.Tensor,
             ctx: StrategyContext) -> SymbolSet: ...


def finalize_symbols(m_c, m_s, q_scores, kv_scores,
                     ctx: StrategyContext) -> SymbolSet:
    """Shared clamp + packing tail of every strategy (the reference's op order)."""
    cfg = ctx.cfg
    m_c = clamp_mask_topk(m_c, q_scores, cfg.cap_q_cmp(ctx.n_tokens))
    m_s = clamp_mask_topk(m_s, kv_scores, cfg.cap_kv_cmp(ctx.n_tokens))
    return SymbolSet(s_c=pack_bits(m_c),
                     s_s=pack_bits(m_s.reshape(*m_s.shape[:-2], -1)),
                     m_c=m_c, m_s=m_s, q_scores=q_scores, kv_scores=kv_scores)


class FlashOmniStrategy:
    """Paper §3.3 rule: C∧G cumulative-mass caching with S_q degradation
    (``S_c``) plus per-row cumulative-mass skipping (``S_s``), both ranked
    for the capacity clamp by the compressed attention map."""

    name = "flashomni"

    def __init__(self, tau_q: Optional[float] = None,
                 tau_kv: Optional[float] = None):
        self.tau_q = tau_q
        self.tau_kv = tau_kv

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        m = ctx.cfg.mask
        m_c = masklib.make_caching_mask(q, k, m, ctx.n_text, tau_q=self.tau_q)
        m_c = masklib.apply_degradation(m_c, m.degrade)
        p_map = masklib.compressed_attention_map(q, k, m.pool)
        m_s = masklib.make_skip_mask(q, k, m, ctx.n_text, tau_kv=self.tau_kv)
        return finalize_symbols(m_c, m_s, p_map.sum(dim=-2), p_map, ctx)


_REGISTRY: dict[str, Callable[[], SparsityStrategy]] = {}

# Registered in the reference, not ported yet (ROADMAP A.4).
_NOT_PORTED = ("cache-all", "skip-only", "sliding-window", "multi-granularity",
               "step-phased", "hunyuan-1.5x")


def register_strategy(name: str, factory: Callable[[], SparsityStrategy]) -> None:
    """Register a zero-arg factory under ``name`` (``EngineConfig.strategy``)."""
    _REGISTRY[name] = factory


def available_strategies() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_strategy(spec: Union[str, SparsityStrategy]) -> SparsityStrategy:
    """Resolve a registry name (or pass a strategy object through)."""
    if not isinstance(spec, str):
        return spec
    if spec in _NOT_PORTED:
        raise NotImplementedError(f"strategy {spec!r} is not ported yet")
    try:
        return _REGISTRY[spec]()
    except KeyError:
        raise ValueError(f"unknown sparsity strategy {spec!r}; registered: "
                         f"{available_strategies()}") from None


register_strategy("flashomni", FlashOmniStrategy)
