"""Per-step sparsity schedule, port of ``repro.core.schedule``.

A :class:`SparsitySchedule` is a per-step mode array (dense / update /
dispatch) plus a (step × layer) table of ids into its strategy tuple.  The
reference traces both as data through one ``lax.scan``; the port's sampler
is a Python loop, so the schedule stays on the host and the DiT looks each
layer's strategy up by id.

A ``multi-granularity`` strategy with a ``layer_assign`` table expands into
per-layer variants, deduplicated by head template, with the id table
pointing each layer at its variant: the deployment table is the schedule.
Named presets, with the reference's one-line descriptions
(:func:`schedule_summaries`): ``hunyuan-1.5x`` (the paper's HunyuanVideo
1.5× table) and ``step-ramp`` (skip-only → flashomni → cache-all over the
steps).  The batched-serving lane tables are here too:
:func:`merge_strategies`, :func:`schedule_lane_rows` (one schedule
remapped onto the shared strategy set and padded to a lane),
:func:`stack_schedules` and :func:`tick_mode_groups` (a tick's active lanes
partitioned by mode).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core.strategy import (MultiGranularityStrategy, SparsityStrategy,
                                       get_strategy, strategy_key)

__all__ = ["MODE_DENSE", "MODE_UPDATE", "MODE_DISPATCH", "MODE_IDLE", "MODE_NAMES",
           "SparsitySchedule", "strategy_table", "merge_strategies", "schedule_lane_rows",
           "stack_schedules", "tick_mode_groups", "register_schedule",
           "get_schedule", "available_schedules", "schedule_summaries"]

MODE_DENSE, MODE_UPDATE, MODE_DISPATCH = 0, 1, 2
# Lane tables pad past a schedule's end with MODE_IDLE: the lane holds no
# work at that step.  A SparsitySchedule never carries it (validate()).
MODE_IDLE = 3
MODE_NAMES = ("dense", "update", "dispatch", "idle")


def _mode_array(cfg, num_steps: int) -> np.ndarray:
    """Per-step Update/Dispatch phases from the config's warmup/interval."""
    from repro_torch.core.engine import is_update_step
    return np.asarray([MODE_UPDATE if is_update_step(i, cfg) else MODE_DISPATCH
                       for i in range(num_steps)], np.int32)


def _expand_layer_table(spec: Union[str, SparsityStrategy], n_layers: int):
    """One strategy spec -> ``(strategies, per-layer ids)``; a
    ``multi-granularity`` strategy with a layer table expands into per-layer
    variants deduplicated by head template."""
    strat = get_strategy(spec)
    if isinstance(strat, MultiGranularityStrategy) and strat.layer_assign:
        uniq: list = []
        ids: list[int] = []
        by_template: dict = {}
        variants = strat.per_layer(n_layers)
        for i in range(n_layers):
            key = strat._template(i)
            if key not in by_template:
                by_template[key] = len(uniq)
                uniq.append(variants[i])
            ids.append(by_template[key])
        return tuple(uniq), ids
    return (strat,), [0] * n_layers


def strategy_table(layer_strategies: Sequence, cfg, n_layers: int):
    """A per-layer spec table -> ``(strategies, id row)``.

    ``None`` entries fall back to ``cfg.strategy``; specs deduplicate by name
    (registry strings) or identity (instances).  A ``multi-granularity``
    entry with a layer table is pinned to its position's template."""
    if len(layer_strategies) != n_layers:
        raise ValueError(f"layer_strategies has {len(layer_strategies)} entries for "
                         f"{n_layers} layers")
    uniq: list = []
    ids: list[int] = []
    by_spec: dict = {}
    for i, s in enumerate(layer_strategies):
        spec = cfg.strategy if s is None else s
        strat = get_strategy(spec)
        key = spec if isinstance(spec, str) else id(spec)
        if isinstance(strat, MultiGranularityStrategy) and strat.layer_assign:
            tmpl = strat._template(i)
            key = (key, tmpl)
            if key not in by_spec:
                by_spec[key] = len(uniq)
                uniq.append(MultiGranularityStrategy(
                    children=strat.children, head_assign=tmpl,
                    name=f"{strat.name}[layer {i}]"))
        elif key not in by_spec:
            by_spec[key] = len(uniq)
            uniq.append(strat)
        ids.append(by_spec[key])
    return tuple(uniq), np.asarray(ids, np.int32)


@dataclasses.dataclass(frozen=True)
class SparsitySchedule:
    """``mode`` (S,) int32, ``strategy_ids`` (S, L) int32 into ``strategies``."""

    mode: np.ndarray
    strategy_ids: np.ndarray
    strategies: tuple = ()

    @property
    def num_steps(self) -> int:
        return self.mode.shape[0]

    @property
    def n_layers(self) -> int:
        return self.strategy_ids.shape[-1]

    def kinds(self) -> list[str]:
        """Per-step phase names (trace/diagnostics)."""
        return [MODE_NAMES[int(m)] for m in self.mode]

    def validate(self) -> "SparsitySchedule":
        if self.mode.ndim != 1 or self.strategy_ids.ndim != 2:
            raise ValueError(f"schedule shapes: mode {self.mode.shape}, strategy_ids "
                             f"{self.strategy_ids.shape}; want (S,) and (S, L)")
        if self.strategy_ids.shape[0] != self.num_steps:
            raise ValueError(f"strategy_ids covers {self.strategy_ids.shape[0]} steps, "
                             f"mode covers {self.num_steps}")
        if not self.strategies:
            raise ValueError("schedule has no strategies")
        ids = self.strategy_ids
        if ids.min() < 0 or ids.max() >= len(self.strategies):
            raise ValueError(f"strategy ids span [{ids.min()}, {ids.max()}] but only "
                             f"{len(self.strategies)} strategies are in the schedule")
        if self.mode.min() < MODE_DENSE or self.mode.max() > MODE_DISPATCH:
            raise ValueError(f"mode values outside {MODE_NAMES}: {self.mode}")
        return self

    @classmethod
    def from_config(cls, cfg, num_steps: int, n_layers: int, *,
                    layer_strategies: Optional[Sequence] = None,
                    force_dense: bool = False) -> "SparsitySchedule":
        """Resolution order: ``force_dense`` (the all-dense baseline) →
        ``layer_strategies`` → ``cfg.schedule`` (a named preset) →
        ``cfg.strategy`` (expanded when it carries a layer table)."""
        if force_dense:
            return cls(mode=np.full((num_steps,), MODE_DENSE, np.int32),
                       strategy_ids=np.zeros((num_steps, n_layers), np.int32),
                       strategies=(get_strategy(cfg.strategy),)).validate()
        if layer_strategies is not None:
            uniq, ids = strategy_table(layer_strategies, cfg, n_layers)
            return cls.from_table(cfg, num_steps, uniq, ids)
        if cfg.schedule is not None:
            return get_schedule(cfg.schedule, cfg, num_steps, n_layers)
        strategies, ids = _expand_layer_table(cfg.strategy, n_layers)
        return cls.from_table(cfg, num_steps, strategies, ids)

    @classmethod
    def from_table(cls, cfg, num_steps: int, strategies: tuple,
                   layer_ids: Sequence[int]) -> "SparsitySchedule":
        """A step-constant per-layer id row with the config's Update/Dispatch
        mode pattern."""
        row = np.asarray(layer_ids, np.int32)
        return cls(mode=_mode_array(cfg, num_steps),
                   strategy_ids=np.broadcast_to(row[None, :],
                                                (num_steps, row.shape[0])).copy(),
                   strategies=tuple(strategies)).validate()


def merge_strategies(schedules: Sequence[SparsitySchedule]) -> tuple:
    """Union of the schedules' strategy sets, deduplicated by
    :func:`~repro_torch.core.strategy.strategy_key` (value-equal built-ins
    merge even as distinct objects; ad-hoc strategies by identity), in first
    appearance order: the one set every lane's id rows index."""
    uniq: list = []
    seen: dict = {}
    for sched in schedules:
        for s in sched.strategies:
            key = strategy_key(s)
            if key not in seen:
                seen[key] = len(uniq)
                uniq.append(s)
    return tuple(uniq)


def schedule_lane_rows(sched: SparsitySchedule, strategies: tuple,
                       num_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """One schedule remapped onto a shared strategy set and padded to a lane.

    Returns ``(mode_row (num_steps,), id_row (num_steps, L))`` int32: the
    schedule's steps keep their mode, with ids remapped into ``strategies``
    (matched by value key); steps past ``sched.num_steps`` pad with
    :data:`MODE_IDLE` and id 0."""
    if sched.num_steps > num_steps:
        raise ValueError(f"schedule has {sched.num_steps} steps; the lane table holds "
                         f"{num_steps} (raise the batcher's max_steps)")
    index: dict = {}
    for i, s in enumerate(strategies):
        index.setdefault(strategy_key(s), i)
    missing = [s.name for s in sched.strategies if strategy_key(s) not in index]
    if missing:
        raise ValueError(f"schedule strategies {missing} are not in the shared lane "
                         f"strategy set {[s.name for s in strategies]}; rebuild the "
                         "batcher universe (merge_strategies) over all queued requests")
    remap = np.asarray([index[strategy_key(s)] for s in sched.strategies], np.int32)
    mode_row = np.full((num_steps,), MODE_IDLE, np.int32)
    mode_row[: sched.num_steps] = sched.mode
    id_row = np.zeros((num_steps, sched.n_layers), np.int32)
    id_row[: sched.num_steps] = remap[sched.strategy_ids]
    return mode_row, id_row


def stack_schedules(schedules: Sequence[SparsitySchedule],
                    num_steps: Optional[int] = None):
    """Pad and stack mixed-length schedules into lane tables.

    Returns ``(mode (lanes, S), strategy_ids (lanes, S, L), strategies,
    lengths)``: int32 host arrays, the merged strategy set they index and
    each schedule's own step count.  ``num_steps`` fixes S (default: the
    longest schedule).
    Kept for parity with the reference; nothing in the port calls it."""
    if not schedules:
        raise ValueError("stack_schedules needs at least one schedule")
    n_layers = {s.n_layers for s in schedules}
    if len(n_layers) != 1:
        raise ValueError(f"mixed n_layers across schedules: {n_layers}")
    lengths = [s.num_steps for s in schedules]
    s_max = max(lengths) if num_steps is None else int(num_steps)
    strategies = merge_strategies(schedules)
    rows = [schedule_lane_rows(s, strategies, s_max) for s in schedules]
    return (np.stack([m for m, _ in rows]), np.stack([i for _, i in rows]),
            strategies, lengths)


def tick_mode_groups(mode_tab: np.ndarray, steps: np.ndarray,
                     active: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """The active lanes of one serving tick, partitioned by their mode at
    their own step: ``[(mode, lane_mask (lanes,) bool), ...]`` sorted by
    mode; inactive lanes belong to no group."""
    mode_tab = np.asarray(mode_tab)
    steps = np.asarray(steps)
    active = np.asarray(active, bool)
    n_lanes, s_max = mode_tab.shape
    cur = mode_tab[np.arange(n_lanes), np.clip(steps, 0, s_max - 1)]
    return [(int(m), active & (cur == m))
            for m in sorted({int(c) for c, a in zip(cur, active) if a})]


ScheduleFactory = Callable[[Any, int, int], SparsitySchedule]

_SCHEDULES: dict[str, ScheduleFactory] = {}
_SUMMARIES: dict[str, str] = {}


def register_schedule(name: str, factory: ScheduleFactory, summary: str = "") -> None:
    """Register ``factory(cfg, num_steps, n_layers) -> SparsitySchedule``."""
    _SCHEDULES[name] = factory
    _SUMMARIES[name] = summary


def available_schedules() -> tuple[str, ...]:
    return tuple(_SCHEDULES)


def schedule_summaries() -> dict[str, str]:
    """name -> one-line description (docs, ``--help``)."""
    return dict(_SUMMARIES)


def get_schedule(spec: Union[str, SparsitySchedule], cfg, num_steps: int,
                 n_layers: int) -> SparsitySchedule:
    """Resolve a named schedule (or pass a prebuilt one through)."""
    if isinstance(spec, SparsitySchedule):
        if spec.num_steps != num_steps or spec.n_layers != n_layers:
            raise ValueError(f"schedule is ({spec.num_steps} steps, {spec.n_layers} "
                             f"layers); the run wants ({num_steps}, {n_layers})")
        return spec.validate()
    try:
        factory = _SCHEDULES[spec]
    except KeyError:
        raise ValueError(f"unknown sparsity schedule {spec!r}; registered: "
                         f"{available_schedules()}") from None
    return factory(cfg, num_steps, n_layers).validate()


def _hunyuan_schedule(cfg, num_steps: int, n_layers: int) -> SparsitySchedule:
    strategies, ids = _expand_layer_table("hunyuan-1.5x", n_layers)
    return SparsitySchedule.from_table(cfg, num_steps, strategies, ids)


def _step_ramp_schedule(cfg, num_steps: int, n_layers: int) -> SparsitySchedule:
    names = ("skip-only", "flashomni", "cache-all")
    phase = np.minimum((np.arange(num_steps) * len(names)) // max(num_steps, 1),
                       len(names) - 1).astype(np.int32)
    return SparsitySchedule(mode=_mode_array(cfg, num_steps),
                            strategy_ids=np.broadcast_to(phase[:, None],
                                                         (num_steps, n_layers)).copy(),
                            strategies=tuple(get_strategy(n) for n in names))


register_schedule(
    "hunyuan-1.5x", _hunyuan_schedule,
    "paper HunyuanVideo 1.5× deployment table expanded per layer "
    "(skip-only boundaries, striped flashomni/sliding-window interior)")
register_schedule(
    "step-ramp", _step_ramp_schedule,
    "denoising-phase ramp: skip-only -> flashomni -> cache-all over the "
    "step axis (uniform across layers)")
