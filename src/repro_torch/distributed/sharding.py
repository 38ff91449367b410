"""Logical-axis sharding rules (MaxText-style), port of
``repro.distributed.sharding``.

Model code names the dims of parameters and activations with LOGICAL axes;
:class:`ShardingRules` maps each onto axes of a named mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`):

  single-pod: (data=16, model=16)          multi-pod: (pod=2, data=16, model=16)

Logical axes:
  * ``dp``    — data parallel (batch dim of activations)
  * ``fsdp``  — weight/optimizer-state sharding (ZeRO-3 over the data axis;
                for ≥100B params the pod axis joins, see configs)
  * ``tp``    — tensor parallel (heads / ff / vocab)
  * ``sp``    — sequence parallel (long-context KV caches, batch=1 cells)
  * ``ep``    — expert parallel (MoE expert dim; only when divisible)

PyTorch's idiom stands in for JAX's: a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the axis
names is the ``Mesh``, and a list of DTensor placements (``Shard``,
``Replicate``), one a mesh dim, is the ``NamedSharding``.
:func:`logical_to_physical` returns the port's own :class:`PartitionSpec`,
a tuple with one entry a tensor dim (``None``, an axis name, or a tuple of
names); :func:`placements` turns one into placements over a mesh.  A
tensor dim sharded over several mesh axes becomes ``Shard(d)`` on each of
those mesh dims, which DTensor splits in mesh-dim order, major first, as
``NamedSharding`` does.

Transport.  :func:`redistribute` moves a DTensor to new placements over its
mesh.  On NCCL, or on the CPU, it is DTensor's own ``redistribute``.  On a
``gloo`` world whose DTensors live on a card, DTensor's collectives crash
(torch 2.11 on the H100: a segmentation fault in the functional
collectives' wait), so the move is made explicitly, in one of two ways:

* every rank of the world on one host (the ranks that share a card): each
  rank maps its peers' local tensors into its own address space (CUDA IPC,
  through ``torch.multiprocessing``'s tensor sharing; the handles travel
  over ``gloo``) and concatenates or sums them, in mesh order, on the
  card; ``redistribute.peer_bytes`` counts the bytes copied from peers;
* otherwise staged through the host: the local shard is copied to the host
  (page-locked), redistributed there over a CPU twin of the mesh (the same
  ranks and names), and the result copied back to the card;
  ``redistribute.staged_bytes`` counts the bytes those copies move (both
  ways).

A move to the placements ``x`` already has returns ``x``, and one that
only narrows (every mesh dim that changes goes from ``Replicate()`` to
``Shard``) keeps each rank's slice where it is: it needs no collective, so
it is DTensor's own on every backend.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from repro_torch.tree import tree_map

__all__ = ["ShardingRules", "PartitionSpec", "logical_to_physical",
           "tree_logical_to_physical", "placements", "named_sharding_tree", "redistribute",
           "DEFAULT_RULES", "MULTIPOD_RULES", "MULTIPOD_ZERO_RULES", "SEQ_RULES",
           "MULTIPOD_SEQ_RULES"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name to a tuple of physical mesh axes."""

    dp: tuple[str, ...] = ("data",)
    fsdp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)
    sp: tuple[str, ...] = ()
    ep: tuple[str, ...] = ()

    def physical(self, logical: Optional[str]) -> Any:
        if logical is None:
            return None
        axes: tuple[str, ...] = ()
        for part in logical.split("+"):          # e.g. "dp+sp"
            axes = axes + tuple(getattr(self, part))
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]


DEFAULT_RULES = ShardingRules()
MULTIPOD_RULES = ShardingRules(dp=("pod", "data"), fsdp=("data",))
# ZeRO across pods too — used by ≥100B configs (llama3-405b):
MULTIPOD_ZERO_RULES = ShardingRules(dp=("pod", "data"), fsdp=("pod", "data"))
SEQ_RULES = dataclasses.replace(DEFAULT_RULES, sp=("data",))
MULTIPOD_SEQ_RULES = dataclasses.replace(MULTIPOD_RULES, sp=("data",), dp=("pod",))


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or a
    tuple of names (sharded over those axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        isinstance(e, (str, type(None))) for e in x)


def logical_to_physical(logical_spec: Sequence[Optional[str]],
                        rules: ShardingRules) -> PartitionSpec:
    """("fsdp", "tp") -> PartitionSpec("data", "model") etc."""
    return PartitionSpec(*(rules.physical(ax) for ax in logical_spec))


def tree_logical_to_physical(spec_tree: Any, rules: ShardingRules) -> Any:
    """Map a tree of logical tuples to a tree of :class:`PartitionSpec`."""
    return tree_map(lambda spec: logical_to_physical(spec, rules), spec_tree,
                    is_leaf=_is_logical)


def placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh``
    with ``mesh_dim_names``): ``Shard(d)`` on every mesh dim that tensor dim
    ``d`` names, ``Replicate()`` on the rest.  Raises on an axis the mesh
    lacks or on a mesh axis two tensor dims claim, as ``NamedSharding``
    does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis not in names:
                raise ValueError(f"{spec} names mesh axis {axis!r}; the mesh has {names}")
            i = names.index(axis)
            if out[i] != Replicate():
                raise ValueError(f"{spec} shards two dims over mesh axis {axis!r}")
            out[i] = Shard(d)
    return out


def named_sharding_tree(spec_tree: Any, mesh, rules: ShardingRules) -> Any:
    """A tree of logical specs -> the tree of their placement lists over
    ``mesh``."""
    return tree_map(lambda p: placements(p, mesh), tree_logical_to_physical(spec_tree, rules),
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


_HOST_MESHES: dict = {}


def _host_mesh(mesh):
    """The CPU twin of ``mesh`` (the same ranks and names), built once per
    mesh layout; building it is collective over the world."""
    from torch.distributed.device_mesh import DeviceMesh
    key = (tuple(mesh.mesh.shape), tuple(mesh.mesh.reshape(-1).tolist()), mesh.mesh_dim_names)
    if key not in _HOST_MESHES:
        _HOST_MESHES[key] = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    return _HOST_MESHES[key]


def _staged(mesh) -> bool:
    """Whether a move over ``mesh`` goes through the host: a card mesh on a
    ``gloo`` world."""
    import torch.distributed as dist
    return mesh.device_type != "cpu" and dist.get_backend() == "gloo"


_ONE_HOST: list = []


def _one_host() -> bool:
    """Whether every rank of the world runs on this host (asked once,
    collectively over the world)."""
    if not _ONE_HOST:
        import socket
        import torch.distributed as dist
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        _ONE_HOST.append(len(set(names)) == 1)
    return _ONE_HOST[0]


def _undo_dim(local, mesh, dim: int, placement):
    """``local`` made whole over mesh dim ``dim`` (``Shard``: the peers'
    shards concatenated; ``Partial``: summed), from the peers' tensors
    mapped into this process.  Collective over the ranks of that dim; on
    return every peer has finished reading this rank's tensor."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from torch.multiprocessing.reductions import reduce_tensor
    group = mesh.get_group(dim)
    coord = mesh.get_coordinate()[dim]
    local = local.contiguous()
    if local.is_cuda:
        torch.cuda.synchronize(local.device)          # written before a peer reads it
    items = [None] * dist.get_world_size(group)
    dist.all_gather_object(items, (coord, reduce_tensor(local)), group=group)
    parts = [None] * len(items)
    for c, (rebuild, args) in items:
        parts[c] = local if c == coord else rebuild(*args)
    if isinstance(placement, Shard):
        out = torch.cat(parts, dim=placement.dim)
    else:
        out = parts[0].clone()
        for part in parts[1:]:
            out += part
        if placement.reduce_op == "avg":
            out /= len(parts)
    redistribute.peer_bytes += sum(p.nbytes for c, p in enumerate(parts) if c != coord)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    del parts, items
    dist.barrier(group)                               # every peer is done reading
    if out.is_cuda:
        torch.cuda.ipc_collect()
    return out


def _redistribute_peers(x, pl: list):
    """:func:`redistribute` between the ranks of one host: every mesh dim
    that is not replicated is made whole from the peers' tensors, innermost
    first (a tensor dim sharded over several mesh dims nests in mesh-dim
    order), then each rank keeps its slice of ``pl``.  A mesh dim of one
    rank is whole already: it moves nothing (sharding a tensor through CUDA
    IPC with no peer to map it would leave its memory held, as the
    producer's, until the process ends)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    src, local = list(x.placements), x.to_local()
    for i in reversed(range(mesh.ndim)):
        if src[i] != Replicate():
            if mesh.size(i) > 1:
                local = _undo_dim(local, mesh, i, src[i])
            src[i] = Replicate()
    whole = DTensor.from_local(local, mesh, src, run_check=False, shape=x.shape,
                               stride=x.stride())
    return whole.redistribute(mesh, pl)


def _narrows(src, dst) -> bool:
    """Every mesh dim that changes goes from ``Replicate()`` to ``Shard``."""
    from torch.distributed.tensor import Replicate, Shard
    return all(a == b or (a == Replicate() and isinstance(b, Shard)) for a, b in zip(src, dst))


def redistribute(x, pl: list):
    """The DTensor ``x`` with placements ``pl`` over its own mesh; on a
    ``gloo`` world whose DTensors live on a card, moved between the ranks'
    tensors directly when the world is on one host, else staged through the
    host.  Collective over the mesh's ranks (and, the first time a layout
    is moved so, over the world)."""
    import torch
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    if tuple(x.placements) == tuple(pl):
        return x
    if not _staged(mesh) or _narrows(x.placements, pl):
        return x.redistribute(mesh, pl)
    if _one_host():
        return _redistribute_peers(x, pl)
    host_mesh = _host_mesh(mesh)
    local = x.to_local()
    # Page-locked staging: the copy down runs at the link's rate (the
    # caching host allocator keeps the buffer for the next move).
    down = torch.empty(local.shape, dtype=local.dtype, pin_memory=local.is_cuda)
    down.copy_(local)
    host = DTensor.from_local(down, host_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())
    host = host.redistribute(host_mesh, pl).to_local()
    redistribute.staged_bytes += local.nbytes + host.nbytes
    return DTensor.from_local(host.to(x.device), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


redistribute.staged_bytes = 0
redistribute.peer_bytes = 0
