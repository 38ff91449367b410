"""Request-queue serving over mixed SparsitySchedules, port of
``repro.launch.batching``.

  * :class:`Request` / :class:`RequestQueue`: an arrival-ordered FIFO.
  * :func:`run_sequential`: the baseline, one ``pipeline.sample`` per request.
  * :func:`run_stacked`: requests that share a lane shape, a step count and a
    schedule stack on the batch axis, one ``sample`` call per group.
  * :class:`ContinuousBatcher`: a fixed number of lanes, one request each;
    every serving tick advances each active lane by one denoising step, and
    a lane whose request finishes retires and refills from the queue.

Ground truth for every mode is ``sample`` of the same request alone: the
kernels keep batch as a grid axis, so a sample's result does not depend on
its neighbours (the library GEMMs of a folded batch may round in the last
bit, which can move a block across a threshold of the plan).

Tick dispatch in the batcher.  Before a tick the host reads every active
lane's mode at the lane's own step (``schedule.tick_mode_groups``) and splits
each mode's lanes further by step context.  Lanes fold into one batch
(``pipeline.make_grouped_lane_tick``) only when their whole step context is
equal: the mode; every layer's ``k_since`` and ``taylor.n_updates`` (one
Python int per layer in the port, where the reference ``vmap``s per-lane
counters); at Update also every layer's strategy as it emits at the lane's
own step (``pipeline.lane_update_key``: ``denoise_step`` takes one strategy
row, step and step count, and only ``step-phased`` strategies read the
step, so lanes at different steps or step counts fold unless their phases
differ); and the lane shape (each shape partition has its own lanes).  The
time ``t`` and the Euler ``dt`` are per lane.  A tick whose active lanes
form one such group is a *grouped tick*: one ``denoise_step`` for all of
them.  Any other tick is a *scan tick* (the reference's name for its
lane-serial fallback): each group of two or more lanes still folds, and a
lane of a group of its own runs its own single-request step
(``pipeline.make_lane_tick``).  ``grouped=False`` never folds: every lane
runs its own step on every tick.  ``grouped="auto"`` and ``True`` are the
same policy here: the reference's ``"auto"`` chooses by
:func:`_lockstep_capable` to bound the executables it compiles, and the
port compiles none.

Not applicable here, with the reason:

  * ``core/lru.py`` (the LRU memos), ``engine.schedule_cache_stats``,
    ``stats["executables"]`` and the reference's "≤ 4 executables per lane
    shape" budget: the port compiles nothing per configuration, lane shape
    or schedule, and ``resolve_schedule`` keeps no memo.  For the same reason
    ``"auto"`` does not decide on :func:`_lockstep_capable` as the reference
    does (a non-lockstep mix would compile group bodies it rarely uses);
    the port reports it as ``stats["lockstep"]``.
  * Grouping by ``id(schedule)``: without a memo, equal specs resolve to
    distinct objects, so :func:`run_stacked` groups by a value key (lane
    shape, step count, mode table, id table and the strategies'
    ``strategy_key``).
  * ``default_patch_embed``: the reference draws it from a JAX key; the port
    takes ``patch_embed`` as an explicit input, as ``sample`` does.

Times are seconds on the host clock from the serving clock's start; a
request's finish is taken after the device finished its work.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import (EngineConfig, resolve_schedule, set_lane_state,
                                     stack_lane_states)
from repro_torch.core.plan import DispatchPlan
from repro_torch.core.schedule import (MODE_IDLE, MODE_NAMES, MODE_UPDATE, merge_strategies,
                                       schedule_lane_rows, tick_mode_groups)
from repro_torch.core.strategy import strategy_key
from repro_torch.diffusion.pipeline import (SamplerConfig, lane_update_key,
                                            make_grouped_lane_tick, make_lane_tick, sample)
from repro_torch.models import dit

__all__ = ["Request", "RequestQueue", "ContinuousBatcher", "run_sequential", "run_stacked"]


@dataclasses.dataclass
class Request:
    """One text-to-vision serving request.

    ``x0`` (B, N_v, patch_dim) Gaussian latents; ``text_emb`` (B, N_t,
    d_model); ``schedule`` / ``layer_strategies`` feed
    :func:`repro_torch.core.engine.resolve_schedule` against the server's
    shared ``EngineConfig`` (``None``: the config's own mapping);
    ``arrival`` is seconds since the serving clock's start.
    """

    rid: Any
    x0: torch.Tensor
    text_emb: torch.Tensor
    num_steps: int
    schedule: Any = None
    layer_strategies: Any = None
    arrival: float = 0.0

    def resolve(self, ecfg: EngineConfig, n_layers: int):
        return resolve_schedule(ecfg, self.num_steps, n_layers, schedule=self.schedule,
                                layer_strategies=self.layer_strategies)

    def shape_key(self) -> tuple:
        """Lane-shape key: requests in one batch must agree on it."""
        return (tuple(self.x0.shape), str(self.x0.dtype), tuple(self.text_emb.shape),
                str(self.text_emb.dtype))


class RequestQueue:
    """Arrival-ordered FIFO (stable for equal arrival times)."""

    def __init__(self):
        self._items: list[tuple[float, int, Request]] = []
        self._seq = 0

    def submit(self, req: Request) -> None:
        # Kept sorted by (arrival, seq): one bisect insertion per request, and
        # the monotone seq keeps equal arrivals FIFO and never compares two
        # Requests.
        bisect.insort(self._items, (req.arrival, self._seq, req))
        self._seq += 1

    def submit_all(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    def __len__(self) -> int:
        return len(self._items)

    def pending(self) -> list[Request]:
        return [r for _, _, r in self._items]

    def next_arrival(self) -> Optional[float]:
        return self._items[0][0] if self._items else None

    def pop_ready(self, now: float) -> Optional[Request]:
        """Pop the earliest request whose arrival time has passed."""
        if self._items and self._items[0][0] <= now:
            return self._items.pop(0)[2]
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _result(out, trace, arrival: float, finish: float, plans=None) -> dict:
    res = {"out": out, "trace": trace, "finish": finish, "latency": finish - arrival}
    if plans is not None:
        res["plans"] = plans
    return res


def _wait_until(t0: float, at: float) -> None:
    now = time.perf_counter() - t0
    if now < at:
        time.sleep(at - now)


def run_sequential(params: dict, cfg: ArchConfig, ecfg: EngineConfig, requests, *,
                   patch_embed: torch.Tensor, scfg_dtype: torch.dtype = torch.float32,
                   keep_plans: bool = False) -> dict:
    """Serve ``requests`` one at a time in arrival order, in ``scfg_dtype``
    (float32, the reference's serving dtype, or bfloat16).  Returns ``{rid:
    {out, trace, finish, latency}}`` (and ``plans``, each layer's last
    DispatchPlan, with ``keep_plans``)."""
    results: dict = {}
    t0 = time.perf_counter()
    for req in sorted(requests, key=lambda r: r.arrival):
        _wait_until(t0, req.arrival)
        trace: list = []
        plans = [] if keep_plans else None
        out = sample(params, cfg, ecfg, text_emb=req.text_emb, x0=req.x0,
                     patch_embed=patch_embed,
                     scfg=SamplerConfig(num_steps=req.num_steps, dtype=scfg_dtype),
                     trace=trace, schedule=req.schedule,
                     layer_strategies=req.layer_strategies, plans=plans)
        _sync(out.device)
        results[req.rid] = _result(out, trace, req.arrival, time.perf_counter() - t0, plans)
    return results


def _schedule_key(sched) -> tuple:
    """Value key of a resolved schedule: its tables and its strategies."""
    return (sched.mode.tobytes(), sched.strategy_ids.shape, sched.strategy_ids.tobytes(),
            tuple(strategy_key(s) for s in sched.strategies))


def _batch_share(plan: DispatchPlan, start: int, stop: int) -> DispatchPlan:
    return DispatchPlan(*(None if f is None else f[start:stop] for f in plan))


def run_stacked(params: dict, cfg: ArchConfig, ecfg: EngineConfig, requests, *,
                patch_embed: torch.Tensor, scfg_dtype: torch.dtype = torch.float32,
                keep_plans: bool = False) -> dict:
    """Stack requests that share a lane shape, a step count and a schedule
    value on the batch axis: one ``sample`` call per group, its latents
    split back per request.  A group starts once all its members arrived;
    groups run in the order of their first member's arrival.  Per-request
    traces are not recorded (``trace`` is None): a stacked step's metrics
    are the whole batch's."""
    groups: dict[tuple, tuple] = {}
    for req in sorted(requests, key=lambda r: r.arrival):
        sched = req.resolve(ecfg, cfg.n_layers)
        key = (req.shape_key(), req.num_steps, _schedule_key(sched))
        groups.setdefault(key, (sched, []))[1].append(req)
    results: dict = {}
    t0 = time.perf_counter()
    for (_, num_steps, _), (sched, members) in groups.items():
        _wait_until(t0, max(r.arrival for r in members))
        plans = [] if keep_plans else None
        out = sample(params, cfg, ecfg, text_emb=torch.cat([r.text_emb for r in members]),
                     x0=torch.cat([r.x0 for r in members]), patch_embed=patch_embed,
                     scfg=SamplerConfig(num_steps=num_steps, dtype=scfg_dtype),
                     schedule=sched, plans=plans)
        _sync(out.device)
        finish = time.perf_counter() - t0
        off = 0
        for r in members:
            b = r.x0.shape[0]
            share = None if plans is None else [_batch_share(p, off, off + b) for p in plans]
            results[r.rid] = _result(out[off:off + b], None, r.arrival, finish, share)
            off += b
    return results


def _lockstep_capable(schedules) -> bool:
    """True when every schedule shares one mode table and length: lanes
    filled together then stay mode-homogeneous."""
    ref: Optional[np.ndarray] = None
    for sched in schedules:
        if ref is None:
            ref = sched.mode
        elif sched.mode.shape != ref.shape or not np.array_equal(sched.mode, ref):
            return False
    return True


def _fold_groups(mode_tab, steps, active, id_tab, nsteps, states, strategies) -> list:
    """The active lanes of a tick as ``[(mode, lane_mask), ...]``: the mode
    groups of ``tick_mode_groups``, each split by step context (every
    layer's ``(k_since, n_updates)``; at Update also ``lane_update_key``,
    each layer's strategy as it emits at the lane's step)."""
    out = []
    for mode, mask in tick_mode_groups(mode_tab, steps, active):
        by_ctx: dict = {}
        for w in np.flatnonzero(mask):
            key = tuple((st.k_since, st.taylor.n_updates) for st in states[w])
            if mode == MODE_UPDATE:
                key += lane_update_key(strategies, id_tab[w, steps[w]], steps[w], nsteps[w])
            by_ctx.setdefault(key, []).append(w)
        for lanes in by_ctx.values():
            lane_mask = np.zeros(len(active), bool)
            lane_mask[lanes] = True
            out.append((mode, lane_mask))
    return out


class ContinuousBatcher:
    """Fixed-width lane server over mixed SparsitySchedules (see the module
    docstring for the tick dispatch and the folding rule).

    ``lanes`` requests are resident at once.  A lane whose request reaches
    its own ``num_steps`` retires (its latents are kept) and refills from the
    queue once a request's arrival time has passed; a refilled lane starts
    from fresh engine states.  Each lane's mode and strategy-id rows come
    from the stacked schedule tables (``MODE_IDLE``-padded to ``max_steps``,
    default the longest queued schedule, ids remapped onto the merged
    strategy set of all queued requests).  Empty lanes do no work and report
    metrics of exactly zero.

    ``shape_buckets``: canonical vision-token counts; each request's ``N_v``
    rounds up to the smallest bucket that fits, its latents are zero-padded
    into the lane and its output sliced back, so near-miss shapes share
    lanes.  A request larger than every bucket keeps its shape.  Its output
    equals a sequential run of the padded request, sliced; the map used is
    ``stats["shape_buckets"]``.

    ``grouped``: ``"auto"`` or ``True`` fold every group of lanes that share
    their step context, ``False`` nothing.  ``stats["denoise_calls"]``
    counts ``denoise_step`` calls by mode, ``stats["lane_steps"]`` the lane
    steps they advanced.  ``with_metrics=False`` skips the
    per-lane density and pair-sparsity reductions (they read 0).
    ``sync_every_tick=False`` waits for the device only when a lane retires.
    ``keep_plans`` keeps each request's last DispatchPlans in its result.
    ``patch_embed`` is an explicit input, as for ``sample``.
    """

    def __init__(self, params: dict, cfg: ArchConfig, ecfg: EngineConfig, *,
                 patch_embed: torch.Tensor, lanes: int = 4, max_steps: Optional[int] = None,
                 scfg_dtype: torch.dtype = torch.float32, sync_every_tick: bool = True,
                 grouped="auto", with_metrics: bool = True,
                 shape_buckets: Optional[tuple] = None, keep_plans: bool = False):
        if grouped not in ("auto", True, False):
            raise ValueError(f"grouped must be 'auto', True or False, got {grouped!r}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.patch_embed = patch_embed
        self.lanes = int(lanes)
        self.max_steps = max_steps
        self.scfg = SamplerConfig(num_steps=0, dtype=scfg_dtype)
        self.sync_every_tick = sync_every_tick
        self.grouped = grouped
        self.with_metrics = with_metrics
        self.shape_buckets = (tuple(sorted(int(s) for s in shape_buckets))
                              if shape_buckets else ())
        self.keep_plans = keep_plans
        self.queue = RequestQueue()
        self.stats: dict = {}

    def submit(self, req: Request) -> None:
        self.queue.submit(req)

    def submit_all(self, reqs) -> None:
        self.queue.submit_all(reqs)

    def _bucket_nv(self, nv: int) -> int:
        """Smallest canonical vision length that fits ``nv`` (or ``nv``)."""
        return next((b for b in self.shape_buckets if b >= nv), nv)

    def _canon_key(self, req: Request) -> tuple:
        """``shape_key()`` with ``N_v`` rounded up to its shape bucket."""
        b, nv, pd = req.x0.shape
        return ((b, self._bucket_nv(nv), pd), str(req.x0.dtype), tuple(req.text_emb.shape),
                str(req.text_emb.dtype))

    def run(self) -> dict:
        """Drain the queue; returns ``{rid: {out, trace, finish, latency}}``.

        Requests are partitioned by (bucketed) lane shape; the partitions run
        one after another on one serving clock, so a request's latency
        includes time queued behind an earlier partition."""
        reqs = [self.queue.pop_ready(float("inf")) for _ in range(len(self.queue))]
        scheds = {id(r): r.resolve(self.ecfg, self.cfg.n_layers) for r in reqs}
        universe = merge_strategies(list(scheds.values()))
        s_max = self.max_steps or max((r.num_steps for r in reqs), default=1)
        by_shape: dict[tuple, list[Request]] = {}
        bucket_map: dict[tuple, tuple] = {}
        for r in reqs:
            key = self._canon_key(r)
            bucket_map[r.shape_key()] = key
            by_shape.setdefault(key, []).append(r)
        self.stats = {"ticks": 0, "grouped_ticks": 0, "scan_ticks": 0, "lanes": self.lanes,
                      "max_steps": s_max, "strategies": [s.name for s in universe],
                      "lockstep": _lockstep_capable(scheds.values()),
                      "denoise_calls": {name: 0 for name in MODE_NAMES[:3]},
                      "lane_steps": {name: 0 for name in MODE_NAMES[:3]},
                      "shape_buckets": bucket_map, "shape_partitions": len(by_shape)}
        results: dict = {}
        logs = []
        t0 = time.perf_counter()
        for key, shape_reqs in by_shape.items():
            q = RequestQueue()
            q.submit_all(shape_reqs)
            logs.append(self._run_partition(q, scheds, universe, s_max, t0, key[0][1],
                                            results))
        if logs:
            dens, ps, act = (np.concatenate(parts) for parts in zip(*logs))
        else:
            dens = ps = np.zeros((0, self.lanes))
            act = np.zeros((0, self.lanes), bool)
        self.stats.update(lane_density=dens, lane_pair_sparsity=ps, lane_active=act)
        return results

    def _run_partition(self, q: RequestQueue, scheds: dict, universe: tuple, s_max: int,
                       t0: float, nv: int, results: dict):
        cfg, ecfg, W = self.cfg, self.ecfg, self.lanes
        probe = q.pending()[0]
        b, nt, dev = probe.x0.shape[0], probe.text_emb.shape[1], probe.x0.device
        fresh = dit.init_engine_states(cfg, ecfg, b, nv + nt, dev)
        states = stack_lane_states(fresh, W)
        lane_tick = make_lane_tick(cfg, ecfg, self.scfg, universe, self.with_metrics)
        group_ticks = make_grouped_lane_tick(cfg, ecfg, self.scfg, universe,
                                             self.with_metrics)
        x: list = [None] * W
        text: list = [None] * W
        mode_tab = np.full((W, s_max), MODE_IDLE, np.int32)
        id_tab = np.zeros((W, s_max, cfg.n_layers), np.int32)
        nsteps = np.zeros((W,), np.int32)
        steps = np.zeros((W,), np.int32)
        active = np.zeros((W,), bool)
        lane_req: list[Optional[Request]] = [None] * W
        hist, act_log, tick_log = [], [], []
        calls, lane_steps = self.stats["denoise_calls"], self.stats["lane_steps"]

        while len(q) or active.any():
            now = time.perf_counter() - t0
            for w in np.flatnonzero(~active):
                req = q.pop_ready(now)
                if req is None:
                    break
                mode_tab[w], id_tab[w] = schedule_lane_rows(scheds[id(req)], universe, s_max)
                nsteps[w], steps[w], active[w], lane_req[w] = req.num_steps, 0, True, req
                x[w] = F.pad(req.x0, (0, 0, 0, nv - req.x0.shape[1]))   # bucket zero pad
                text[w] = req.text_emb
                states = set_lane_state(states, w, fresh)
            if not active.any():
                # Nothing resident and nothing ready: wait for the next arrival.
                _wait_until(t0, q.next_arrival())
                continue
            groups = _fold_groups(mode_tab, steps, active, id_tab, nsteps, states, universe)
            one = bool(self.grouped) and len(groups) == 1
            self.stats["grouped_ticks" if one else "scan_ticks"] += 1
            alone, dens, ps = active.copy(), 0, 0
            for mode, lane_mask in groups:
                if self.grouped and (one or lane_mask.sum() > 1):
                    x, states, d, p = group_ticks[MODE_NAMES[mode]](
                        self.params, self.patch_embed, x, states, text, steps,
                        id_tab[np.arange(W), np.minimum(steps, s_max - 1)], nsteps, lane_mask)
                    calls[MODE_NAMES[mode]] += 1
                    lane_steps[MODE_NAMES[mode]] += int(lane_mask.sum())
                    dens, ps, alone = dens + d, ps + p, alone & ~lane_mask
            if alone.any():
                for w in np.flatnonzero(alone):
                    calls[MODE_NAMES[mode_tab[w, steps[w]]]] += 1
                    lane_steps[MODE_NAMES[mode_tab[w, steps[w]]]] += 1
                x, states, d, p = lane_tick(self.params, self.patch_embed, x, states, text,
                                            steps, mode_tab, id_tab, nsteps, alone)
                dens, ps = dens + d, ps + p
            self.stats["ticks"] += 1
            hist.append((dens, ps))
            act_log.append(active.copy())
            done = [w for w in np.flatnonzero(active) if steps[w] + 1 >= nsteps[w]]
            if self.sync_every_tick or done:
                _sync(dev)
            now = time.perf_counter() - t0
            log = []
            for w in np.flatnonzero(active):
                req = lane_req[w]
                log.append((w, req.rid, int(steps[w]), MODE_NAMES[mode_tab[w, steps[w]]]))
                steps[w] += 1
                if w in done:         # retire: slice the bucket pad back off
                    plans = [st.plan for st in states[w]] if self.keep_plans else None
                    results[req.rid] = _result(x[w][:, :req.x0.shape[1]], [], req.arrival,
                                               now, plans)
                    active[w], lane_req[w], x[w], text[w], states[w] = False, None, None, \
                        None, None
            tick_log.append(log)

        # One host read of the whole per-lane metric history.
        zeros = np.zeros((0, W), np.float64)
        dens_h = torch.stack([d for d, _ in hist]).cpu().numpy() if hist else zeros
        ps_h = torch.stack([p for _, p in hist]).cpu().numpy() if hist else zeros
        for t_idx, log in enumerate(tick_log):
            for w, rid, step, kind in log:
                results[rid]["trace"].append({"step": step, "kind": kind,
                                              "density": float(dens_h[t_idx, w]),
                                              "pair_sparsity": float(ps_h[t_idx, w])})
        act_h = np.stack(act_log) if act_log else np.zeros((0, W), bool)
        return dens_h, ps_h, act_h
