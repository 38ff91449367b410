"""Elastic scaling: rebuild the mesh from the surviving ranks and reshard
the training state, port of ``repro.runtime.elastic``.

Policy: the ``data`` axis absorbs capacity changes (it carries batch DP
and the ZeRO shards); the ``model`` axis is fixed by the TP layout of the
weights.  On a shrink from D to D' data rows the per-rank batch grows by
D/D' and the optimizer shards re-gather, both by moving the state onto the
new mesh under the same logical specs (:func:`reshard_state`).  Grow-back
takes the same path.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
the axis names (``(data, model)`` or ``(pod, data, model)``); a sharded
tensor is a DTensor on it.  Building a ``DeviceMesh`` creates process
groups, which is collective over the whole ``torch.distributed`` world:
**every rank of the world calls** :func:`shrink_mesh` (and so
:func:`reshard_state`) in the same order, the ranks left out of the new
mesh included; they then hold no shard of the result.  The surviving rank
list comes from the caller (a coordinator's heartbeats on real hardware; a
test names it).  On a ``gloo`` world of card tensors the gather is staged
through the host (:func:`repro_torch.distributed.sharding.redistribute`).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.distributed.sharding import (PartitionSpec, ShardingRules, placements,
                                              redistribute, tree_logical_to_physical)
from repro_torch.tree import tree_map

__all__ = ["shrink_mesh", "reshard_state"]


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def shrink_mesh(mesh, surviving: Sequence[int] | None = None, *, drop_data_rows: int = 1):
    """A new mesh without the failed data rows.

    The surviving data-row count is rounded DOWN to a power of two, so every
    sharded dim (batch and fsdp shards, all powers of two in this repo)
    still divides evenly.  ``surviving``: the ranks still healthy (the result
    is a 2-D ``(data, model)`` mesh of them, in the old mesh's order);
    without it the LAST ``drop_data_rows`` rows of the data axis go.
    Collective: every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh                     # [data, model] or [pod, data, model]
    names = tuple(mesh.mesh_dim_names)
    n_model = ranks.shape[-1]
    if surviving is not None:
        keep = set(int(r) for r in surviving)
        flat = [int(r) for r in ranks.reshape(-1).tolist() if r in keep]
        n_rows = _pow2_floor(len(flat) // n_model)
        arr = torch.tensor(flat[: n_rows * n_model]).reshape(n_rows, n_model)
        return DeviceMesh(mesh.device_type, arr, mesh_dim_names=names[-2:])
    if ranks.ndim == 2:
        n_rows = _pow2_floor(ranks.shape[0] - drop_data_rows)
        return DeviceMesh(mesh.device_type, ranks[:n_rows], mesh_dim_names=names)
    n_rows = _pow2_floor(ranks.shape[1] - drop_data_rows)
    return DeviceMesh(mesh.device_type, ranks[:, :n_rows], mesh_dim_names=names)


def _move(x: torch.Tensor, mesh, pl: list):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return redistribute(x, pl)
        # The whole tensor on every rank of x's mesh (collective there).
        x = redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()
    # Every rank holds the whole tensor now: each keeps its own slice.
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def reshard_state(state: Any, spec_tree: Any, new_mesh, rules: ShardingRules) -> Any:
    """Move a tree of tensors (plain or DTensors on another mesh) onto
    ``new_mesh`` as DTensors, each laid out by its logical spec under
    ``rules``.  Collective: every rank of the old and the new mesh calls it."""
    specs = tree_logical_to_physical(spec_tree, rules)
    return tree_map(lambda x, spec: _move(x, new_mesh, placements(spec, new_mesh)), state, specs,
                    is_leaf=lambda x: isinstance(x, (torch.Tensor, PartitionSpec)))
