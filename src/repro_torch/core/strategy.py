"""Sparse-symbol producers, port of ``repro.core.strategy``.

A strategy maps the Update-step Q/K plus a :class:`StrategyContext` to a
:class:`SymbolSet`: packed ``s_c``/``s_s``, the post-clamp boolean masks and
the ranking scores the static-capacity clamp used.  The registry keeps the
reference's names and one-line descriptions: ``flashomni`` (the paper's
§3.3 rule), ``cache-all``, ``skip-only``, ``sliding-window``,
``multi-granularity``, ``step-phased`` and the ``hunyuan-1.5x`` preset.
The port's ``emit`` runs eagerly with host-side context values, so
``step-phased`` picks its phase on the host where the reference switches on
a traced step, and :func:`emit_switch` indexes the schedule's strategy set
on the host where the reference runs a ``lax.switch``.  :func:`strategy_key`
keys the built-in strategies by value, so that serving deduplicates
value-equal producers (``schedule.merge_strategies``), and
:func:`step_strategy_key` keys what a strategy emits at one step, so that
the continuous batcher folds Update lanes that sit at different steps.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional, Protocol, Sequence, Union

import numpy as np
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
    "emit_switch",
    "strategy_key",
    "step_strategy_key",
    "available_strategies",
    "strategy_summaries",
    "FlashOmniStrategy",
    "CacheAllStrategy",
    "SkipOnlyStrategy",
    "SlidingWindowStrategy",
    "MultiGranularityStrategy",
    "StepPhasedStrategy",
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


def _full(q: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, T) all-True mask matching q's batch and head dims."""
    return torch.ones((q.shape[0], q.shape[1], t), dtype=torch.bool, device=q.device)


class CacheAllStrategy:
    """FORA / TaylorSeer family: cache and forecast EVERY vision block.

    No block skipping; text rows stay live (Observation 1: text refreshes
    every step).  The forecast order is the engine's ``MaskConfig.order``."""

    name = "cache-all"

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        m = ctx.cfg.mask
        t = m.n_blocks(ctx.n_tokens)
        n_t = -(-ctx.n_text // m.pool) if ctx.n_text else 0
        m_c = _full(q, t) & (torch.arange(t, device=q.device) < n_t)
        m_s = torch.ones((*m_c.shape, t), dtype=torch.bool, device=q.device)
        return finalize_symbols(m_c, m_s, m_c.to(torch.float32),
                                torch.ones(m_s.shape, device=q.device), ctx)


class SkipOnlyStrategy:
    """SpargeAttn-style: no feature caching, cumulative-mass block skipping only."""

    name = "skip-only"

    def __init__(self, tau_kv: Optional[float] = None):
        self.tau_kv = tau_kv

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        m = ctx.cfg.mask
        p_map = masklib.compressed_attention_map(q, k, m.pool)
        m_s = masklib.make_skip_mask(q, k, m, ctx.n_text, tau_kv=self.tau_kv)
        return finalize_symbols(_full(q, m.n_blocks(ctx.n_tokens)), m_s,
                                p_map.sum(dim=-2), p_map, ctx)


class SlidingWindowStrategy:
    """DiTFastAttnV2-style static band: ``S_s`` keeps |i−j| < window blocks,
    with text rows and columns kept on top of the band when the config
    protects text.  The clamp ranks protected pairs first, then the nearest
    diagonals, so a tight ``cap_kv`` narrows the band from its far edge."""

    name = "sliding-window"

    def __init__(self, window: int = 4):
        self.window = int(window)

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        m = ctx.cfg.mask
        t = m.n_blocks(ctx.n_tokens)
        idx = torch.arange(t, device=q.device)
        dist = (idx[:, None] - idx[None, :]).abs()
        band = dist < self.window
        protect = torch.zeros((t, t), dtype=torch.bool, device=q.device)
        if m.protect_text and ctx.n_text:
            is_text = idx < -(-ctx.n_text // m.pool)
            protect = is_text[:, None] | is_text[None, :]
            band = band | protect
        m_c = _full(q, t)
        m_s = m_c[..., None, :] & band
        kv_scores = torch.where(protect, 1e9, -dist.to(torch.float32)).expand(m_s.shape)
        return finalize_symbols(m_c, m_s, torch.ones(m_c.shape, device=q.device),
                                kv_scores, ctx)


class MultiGranularityStrategy:
    """A per-layer / per-head table of child strategies (Sparse VideoGen's
    spatial/temporal head classes, Sparse-vDiT's per-head patterns).

    ``children`` index the tables; each child sees only the Q/K of its own
    heads.  ``head_assign`` is a head template (tiled over H; default:
    heads striped across children); ``layer_assign`` maps a layer to a
    template or a single child.  ``emit`` never reads the layer: the
    schedule expands ``layer_assign`` into per-layer variants
    (:meth:`per_layer`) and points each layer's id at its variant.
    """

    name = "multi-granularity"

    def __init__(self, children: Sequence[Union[str, SparsityStrategy]] = (
                     "flashomni", "sliding-window"),
                 head_assign: Optional[Sequence[int]] = None,
                 layer_assign: Optional[Mapping[int, Any]] = None,
                 name: Optional[str] = None):
        self.children = tuple(get_strategy(c) for c in children)
        self.head_assign = None if head_assign is None else tuple(head_assign)
        self.layer_assign = dict(layer_assign or {})
        if name is not None:
            self.name = name

    def _template(self, layer_idx: Optional[int]) -> Optional[tuple[int, ...]]:
        """The head template of ``layer_idx`` (layer table, then head template)."""
        a: Any = None if layer_idx is None else self.layer_assign.get(layer_idx)
        if a is None:
            a = self.head_assign
        if a is None:
            return None
        return (a,) if isinstance(a, int) else tuple(a)

    def _assignment(self, heads: int) -> list[int]:
        a = self._template(None)
        if a is None:
            return [h % len(self.children) for h in range(heads)]
        return [a[h % len(a)] for h in range(heads)]

    def per_layer(self, n_layers: int) -> list["MultiGranularityStrategy"]:
        """One strategy per layer with that layer's template pinned."""
        return [MultiGranularityStrategy(children=self.children,
                                         head_assign=self._template(i),
                                         name=f"{self.name}[layer {i}]")
                for i in range(n_layers)]

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        heads = q.shape[1]
        groups: dict[int, list[int]] = {}
        for h, a in enumerate(self._assignment(heads)):
            groups.setdefault(a, []).append(h)
        # Each child emits over its own heads, clamped at its own capacity.
        parts = {a: self.children[a].emit(q[:, hs], k[:, hs], ctx)
                 for a, hs in groups.items()}

        def sel(field: str) -> torch.Tensor:
            cols: list = [None] * heads
            for a, hs in groups.items():
                arr = getattr(parts[a], field)
                for j, h in enumerate(hs):
                    cols[h] = arr[:, j]
            return torch.stack(cols, dim=1)

        m_c, m_s = sel("m_c"), sel("m_s")
        return SymbolSet(s_c=pack_bits(m_c),
                         s_s=pack_bits(m_s.reshape(*m_s.shape[:-2], -1)),
                         m_c=m_c, m_s=m_s, q_scores=sel("q_scores"),
                         kv_scores=sel("kv_scores"))


class StepPhasedStrategy:
    """Schedule-varying producer: re-classify at step boundaries (Sparse
    VideoGen's per-step head re-classification, Sparse-vDiT's per-head
    patterns over a step schedule).

    ``phases`` are child strategies, one per phase; ``boundaries`` the
    ascending phase-change steps, ``len(phases) - 1`` of them: ints are step
    indices, floats fractions of ``ctx.num_steps``, resolved as the
    reference does, by rounding the float32 product half to even (0.3·5 is
    1.5000001 in f32 and rounds to 2; in f64 it would round to 1).  Without
    a step (``ctx.step_idx is None``, a direct ``update_layer`` call) phase
    0 emits."""

    name = "step-phased"

    def __init__(self, phases: Sequence[Union[str, SparsityStrategy]] = (
                     "flashomni", "cache-all"),
                 boundaries: Sequence[Union[int, float]] = (0.5,),
                 name: Optional[str] = None):
        self.phases = tuple(get_strategy(p) for p in phases)
        self.boundaries = tuple(boundaries)
        if len(self.phases) != len(self.boundaries) + 1:
            raise ValueError(f"{len(self.phases)} phases need {len(self.phases) - 1} "
                             f"boundaries, got {len(self.boundaries)}")
        if name is not None:
            self.name = name

    def _boundary_steps(self, num_steps: Optional[int]) -> list[int]:
        steps = []
        for b in self.boundaries:
            if isinstance(b, float):
                if num_steps is None:
                    raise ValueError(f"{self.name}: fractional boundary {b} needs "
                                     "StrategyContext.num_steps (run under a "
                                     "SparsitySchedule)")
                b = np.round(np.float32(b) * np.float32(num_steps))
            steps.append(int(b))
        if steps != sorted(steps):
            raise ValueError(f"{self.name}: boundaries must ascend: {steps}")
        return steps

    def phase_at(self, step_idx: Optional[int], num_steps: Optional[int]) -> int:
        """The phase that emits at ``step_idx`` of a ``num_steps``-step run."""
        if step_idx is None or len(self.phases) == 1:
            return 0
        return sum(int(step_idx) >= s for s in self._boundary_steps(num_steps))

    def emit(self, q, k, ctx: StrategyContext) -> SymbolSet:
        return self.phases[self.phase_at(ctx.step_idx, ctx.num_steps)].emit(q, k, ctx)


_REGISTRY: dict[str, Callable[[], SparsityStrategy]] = {}
_SUMMARIES: dict[str, str] = {}


def register_strategy(name: str, factory: Callable[[], SparsityStrategy],
                      summary: str = "") -> None:
    """Register a zero-arg factory under ``name`` (``EngineConfig.strategy``)."""
    _REGISTRY[name] = factory
    _SUMMARIES[name] = summary


def available_strategies() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def strategy_summaries() -> dict[str, str]:
    """name -> one-line description (docs, ``--help``)."""
    return dict(_SUMMARIES)


def get_strategy(spec: Union[str, SparsityStrategy]) -> SparsityStrategy:
    """Resolve a registry name (or pass a strategy object through)."""
    if not isinstance(spec, str):
        return spec
    try:
        return _REGISTRY[spec]()
    except KeyError:
        raise ValueError(f"unknown sparsity strategy {spec!r}; registered: "
                         f"{available_strategies()}") from None


def emit_switch(strategy_id, q: torch.Tensor, k: torch.Tensor, ctx: StrategyContext,
                strategies: Sequence[Union[str, SparsityStrategy]]) -> SymbolSet:
    """Emit the symbols of ``strategies[strategy_id]`` (an entry of a
    schedule's strategy-id table; an int or a 0-d tensor), a host-side
    dispatch on the id.
    Kept for parity with the reference; nothing in the port calls it."""
    return get_strategy(strategies[int(strategy_id)]).emit(q, k, ctx)


def _key_part(v):
    """Hashable value key of one constructor parameter (see strategy_key)."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_key_part(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _key_part(x)) for k, x in v.items()))
    key = strategy_key(v)
    if key[0] == "id":
        raise TypeError(f"no value key for {v!r}")
    return key


def strategy_key(strategy: SparsityStrategy):
    """Value key of a built-in strategy; ``("id", id(strategy))`` otherwise.

    Two instances of a built-in class with the same ``name`` and the same
    constructor parameters (compared recursively through child strategies)
    have the same key, so serving treats them as one producer: their
    ``emit`` is a pure function of those parameters.  Ad-hoc strategies are
    keyed by identity, correct but never merged."""
    cls = type(strategy)
    if cls not in _VALUE_KEYED_CLASSES:
        return ("id", id(strategy))
    try:
        params = tuple(sorted((k, _key_part(v)) for k, v in vars(strategy).items()
                              if k != "name"))
    except TypeError:
        return ("id", id(strategy))
    return (cls.__name__, strategy.name, params)


_VALUE_KEYED_CLASSES = (FlashOmniStrategy, CacheAllStrategy, SkipOnlyStrategy,
                        SlidingWindowStrategy, MultiGranularityStrategy, StepPhasedStrategy)
_STEP_FREE_CLASSES = (FlashOmniStrategy, CacheAllStrategy, SkipOnlyStrategy,
                      SlidingWindowStrategy)


def _reads_step(strategy) -> bool:
    """Whether ``strategy.emit`` may depend on the context's step or step
    count (an ad-hoc strategy may)."""
    cls = type(strategy)
    if cls in _STEP_FREE_CLASSES:
        return False
    if cls is MultiGranularityStrategy:
        return any(_reads_step(c) for c in strategy.children)
    if cls is StepPhasedStrategy:
        return len(strategy.phases) > 1 or _reads_step(strategy.phases[0])
    return True


def step_strategy_key(strategy, step_idx: Optional[int], num_steps: Optional[int]):
    """Value key of what ``strategy.emit`` computes at ``step_idx`` of a
    ``num_steps``-step run: a ``step-phased`` strategy keys as the phase it
    picks there, a strategy that reads no step as its :func:`strategy_key`,
    and any other (ad-hoc, or one holding a step-phased child) as that key
    with the step and the step count.  Layers of equal keys emit the same
    symbols from the same Q/K, so the continuous batcher folds Update lanes
    on these keys whatever their steps."""
    strategy = get_strategy(strategy)
    if type(strategy) is StepPhasedStrategy:
        return step_strategy_key(strategy.phases[strategy.phase_at(step_idx, num_steps)],
                                 step_idx, num_steps)
    if not _reads_step(strategy):
        return strategy_key(strategy)
    return ("step", strategy_key(strategy), step_idx, num_steps)


register_strategy(
    "flashomni", FlashOmniStrategy,
    "paper §3.3: C∧G cummass caching + cummass BSS (seed rule, bit-exact)")
register_strategy(
    "cache-all", CacheAllStrategy,
    "FORA / TaylorSeer: forecast every vision block, no skipping")
register_strategy(
    "skip-only", SkipOnlyStrategy,
    "SpargeAttn: per-row cummass block skipping, no caching")
register_strategy(
    "sliding-window", SlidingWindowStrategy,
    "DiTFastAttnV2: static |i-j|<w band as S_s, text protected")
register_strategy(
    "multi-granularity", MultiGranularityStrategy,
    "per-layer/per-head table of child strategies (SVG / Sparse-vDiT)")
register_strategy(
    "step-phased", StepPhasedStrategy,
    "SVG-style per-step re-classification: switch phase children at "
    "traced step boundaries")
# The paper's HunyuanVideo 1.5x table: skip-only boundary layers (0, 1);
# interior layers run flashomni on 2 of 3 heads and a static band on the third.
register_strategy(
    "hunyuan-1.5x",
    lambda: MultiGranularityStrategy(
        children=("flashomni", "skip-only", "sliding-window"),
        head_assign=(0, 0, 2), layer_assign={0: 1, 1: 1}, name="hunyuan-1.5x"),
    "paper HunyuanVideo 1.5× table: flashomni/sliding-window striped "
    "heads; skip-only boundary layers via the schedule's per-layer "
    "strategy-id table (SparsitySchedule.from_config expansion)")
