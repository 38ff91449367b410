"""The meshes over ``torch.distributed``, port of ``repro.launch.mesh``.

* :func:`mesh_shape_for` — the largest power-of-two mesh within a cap (pure).
* :func:`make_production_mesh` — the named ``(data, model)`` or ``(pod,
  data, model)`` ``DeviceMesh`` over the initialised world, at the largest
  power-of-two shape within the production cap that the world holds.
* :func:`rules_for` — the :class:`~repro_torch.distributed.sharding.ShardingRules`
  of an (arch, shape, mesh) cell (pure).
* :func:`make_engine_mesh` — the ``(data, seq)`` mesh of plan-sharded
  dispatch (:mod:`repro_torch.distributed.plan_shard`) over a world the
  caller has already initialised: rank ``r`` sits at
  ``(d, s) = divmod(r, sp)``, the reference's ``reshape(dp, sp)``.
* :func:`run_local_mesh` — spawn ``dp·sp`` ranks on this host and run a
  function on each, the counterpart of the reference's forced host devices
  (tests and ``chip_smoke.py``).

Transport is the world's backend, the caller's choice when it initialises
the world: NCCL where each rank has its own card, ``gloo`` on the CPU or
where ranks share a card.  NCCL refuses two ranks on one card, so
:func:`make_engine_mesh` raises on an NCCL world whose ranks share one,
naming ``transport="gloo"``; nothing switches transport by itself.  Gloo's
all-to-all and all-gather take CUDA tensors as they are (they stage through
the host inside the collective), so the dispatch path passes card tensors
straight to the collective on either transport.
"""

from __future__ import annotations

import math
import os
import socket
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["EngineMesh", "mesh_shape_for", "make_production_mesh", "make_engine_mesh",
           "rules_for", "run_local_mesh"]


def mesh_shape_for(n_devices: int, cap_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Largest power-of-two mesh ≤ ``cap_shape`` that fits ``n_devices``.

    The cap is a bound, not a requirement: with fewer devices the mesh
    shrinks.  Axes fill from the LAST (innermost) axis first and stay powers
    of two."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    total = 1 << (n_devices.bit_length() - 1)                       # floor pow2
    cap_total = 1
    for cap in cap_shape:
        cap_total *= cap
    total = min(total, cap_total)
    shape = []
    for cap in reversed(cap_shape):
        if cap & (cap - 1):
            raise ValueError(f"cap_shape axes must be powers of two: {cap_shape}")
        a = min(cap, total)
        total //= a
        shape.append(a)
    return tuple(reversed(shape))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The named production ``DeviceMesh`` over the initialised world: axes
    ``(data, model)``, or ``(pod, data, model)`` with ``multi_pod``, at
    :func:`mesh_shape_for` of the world size within the cap ``(16, 16)`` or
    ``(2, 16, 16)``; ranks ``0 .. n-1`` in row-major order, the reference's
    ``devices[:n].reshape(shape)``, on ``device_type``: the card by default
    (raising where there is none), the CPU when the caller asks for it (the
    dry run's ``meta`` tensors do, as they live on every host).
    Collective: every rank of the world calls it (the ranks past ``n`` hold
    no place in the mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the production mesh needs an initialised torch.distributed world")
    cap = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = mesh_shape_for(dist.get_world_size(), cap)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh: no CUDA device; pass device_type='cpu' to "
                           "lay the mesh over the CPU")
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def rules_for(cfg, shape, *, multi_pod: bool):
    """Pick sharding rules for an (arch, shape, mesh) cell.

    * decode cells map the KV-cache sequence axis (``sp``) onto the model
      axis (kv heads are replicated there — GQA kv counts don't divide 16);
    * batch=1 long-context cells replicate the batch and spread the cache
      sequence over BOTH mesh axes;
    * ≥100B configs (``zero_over_pod``) extend fsdp over the pod axis.
    """
    from repro_torch.distributed.sharding import ShardingRules

    if getattr(cfg, "family", "") == "dit":
        # Batch=1 video DiT serving: sequence parallel over data (and pod,
        # when present — 33K tokens over 32 ways), heads/ff over model.
        sp = ("pod", "data") if multi_pod else ("data",)
        return ShardingRules(dp=(), fsdp=("data",), tp=("model",), sp=sp, ep=())
    dp = ("pod", "data") if multi_pod else ("data",)
    fsdp = ("pod", "data") if (multi_pod and cfg.zero_over_pod) else ("data",)
    sp: tuple[str, ...] = ()
    if shape.kind == "decode":
        if shape.global_batch == 1:           # long_500k: batch can't shard
            dp = ()
            sp = ("data", "model")
        else:
            sp = ("model",)
    return ShardingRules(dp=dp, fsdp=fsdp, tp=("model",), sp=sp, ep=())


class EngineMesh(NamedTuple):
    """One rank's view of the ``(data, seq)`` mesh."""

    dp: int
    sp: int
    d: int                  # this rank's data coordinate
    s: int                  # this rank's seq coordinate
    world: object           # the group of all dp·sp ranks
    seq: object             # this rank's data row: ranks d·sp .. d·sp + sp − 1


_MESHES: dict = {}


def _check_one_card_per_rank(group) -> None:
    """Raise, on every rank, when two ranks of ``group`` share a card (an
    NCCL world's ranks must not)."""
    mine = (socket.gethostname(), torch.cuda.current_device()
            if torch.cuda.is_available() else -1)
    seen = [None] * dist.get_world_size(group)
    dist.all_gather_object(seen, mine, group=group)
    shared = sorted({s for s in seen if seen.count(s) > 1})
    if shared:
        raise ValueError(
            f"transport='nccl' needs one card per rank, but ranks share {shared} "
            "(host, cuda device); NCCL refuses two ranks on one card: use "
            "transport='gloo'")


def make_engine_mesh(dp: int = 1, sp: int = 1) -> EngineMesh:
    """The ``(data, seq)`` mesh over the initialised ``torch.distributed``
    world, cached per (world, shape); its groups use the world's backend.
    Every rank must call this in the same order (it creates process
    groups)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh ({dp}, {sp}) needs an initialised torch.distributed world of "
            f"{dp * sp} ranks (torchrun, or repro_torch.launch.mesh.run_local_mesh)")
    world = dist.get_world_size()
    if world != dp * sp:
        raise ValueError(f"mesh ({dp}, {sp}) needs {dp * sp} ranks, the world has {world}")
    root = dist.group.WORLD
    held = _MESHES.get((dp, sp))
    if held is not None and held[0] is root:        # held: the world cannot be freed
        return held[1]
    if dist.get_backend() == "nccl":
        _check_one_card_per_rank(dist.new_group(backend="gloo"))
    d, s = divmod(dist.get_rank(), sp)
    rows = [dist.new_group(list(range(i * sp, (i + 1) * sp))) for i in range(dp)]
    mesh = EngineMesh(dp=dp, sp=sp, d=d, s=s, world=root, seq=rows[d])
    _MESHES[(dp, sp)] = (root, mesh)
    return mesh


def _rank_main(rank, world, store, backend, fn, args, out_dir):
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_local_mesh(fn, dp: int, sp: int, *args, backend: str = "gloo",
                   timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` on ``dp·sp`` spawned ranks of one host, in a
    ``torch.distributed`` world initialised through a ``file://`` store in a
    fresh temporary directory (no port is taken); returns the ranks' results
    in rank order.  ``fn`` and its arguments must pickle (a module-level
    function).  Raises if a rank fails or the join takes longer than
    ``timeout`` seconds (the ranks are then terminated)."""
    import torch.multiprocessing as mp
    world = dp * sp
    with tempfile.TemporaryDirectory(prefix="engine_mesh_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(world, os.path.join(tmp, "store"), backend,
                                                   fn, args, tmp),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + timeout
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"mesh ({dp}, {sp}) ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
