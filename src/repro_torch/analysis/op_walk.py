"""The op stream of one call (the analyzer's shared walker), the port's
counterpart of ``repro.analysis.jaxpr_walk``.  The reference's module walks
a traced jaxpr, which the port has none of, so it is not applicable as
such (ROADMAP A.10.3); this recorder of dispatched aten ops stands in for
it.

:func:`record_call` runs a function under a ``TorchDispatchMode`` and
records every aten op that reaches the dispatcher: its name, the shapes,
dtypes and storages of its inputs and outputs, and the path of kernel
regions it runs in.  PyTorch decomposes composite ops before they reach the
mode, so an ``einsum`` arrives as permutes and views around a ``bmm`` and a
stable ``argsort`` as ``aten.sort.stable``.  The recorder reads shapes and
storage identities only, so it never waits for the card.

**Kernel regions.**  The CUDA kernels launch through ``ctypes``, which the
dispatcher never sees.  Each kernel wrapper is a named region
(:mod:`repro_torch.kernels._region`), recorded as one node of kind
``"kernel"`` with the wrapper's bound arguments; the ops it runs (on the
card its output clone, on the CPU its whole plain version) follow it with
the region's name in their path.  So a Dispatch record shows B1–B3 (or
B1/B4/B5) as nodes on either device, and a kernel missing from a record is
visible.

Storages are keyed by their untyped storage (``_cdata``) and held by the
record for its lifetime, so a key cannot be reused by a later allocation;
a view shares its base's key.  A DTensor is recorded as its local tensor,
the shard this rank holds.  Records are for small analysis shapes, or for
``meta`` tensors of any size (the dry run, :mod:`repro_torch.launch.dryrun`).

**Collectives.**  ``torch.distributed``'s ops reach the dispatcher as
``c10d`` ops (in place, into a caller's buffer) or ``_c10d_functional``
ops (DTensor's, returning their result).  :func:`collective_kind` names
each by its collective stem; the recorder keeps the size of the group each
ran over (``OpNode.group_size``), read from the op's arguments while the
group exists.

Entry points: :func:`record_call`, :func:`iter_nodes`,
:func:`primitive_counts`, :func:`find_ops`, :func:`eqn_count`,
:func:`index_decode_ops`, :func:`kernel_regions`,
:func:`collective_kind`, :func:`collective_counts`.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Iterator, NamedTuple, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.kernels._region import listening

__all__ = ["TensorMeta", "OpNode", "OpRecord", "record_call", "iter_nodes",
           "primitive_counts", "find_ops", "eqn_count", "INDEX_DECODE_OPS",
           "index_decode_ops", "kernel_regions", "COLLECTIVE_NAMESPACES",
           "collective_kind", "collective_counts"]

# Index-decode work (mask -> plan extraction): any of these inside a
# Dispatch record means the engine is rebuilding the plan instead of reading
# it.  ``argsort`` lowers to ``aten.sort`` and ``torch.topk`` to
# ``aten.topk``; the uint8 symbol unpack has no op of its own, and is
# matched by its signature in :func:`index_decode_ops`.
INDEX_DECODE_OPS = frozenset({"aten.sort", "aten.argsort", "aten.msort", "aten.topk",
                              "aten.kthvalue"})
_UNPACK_OPS = frozenset({"aten.__rshift__", "aten.bitwise_right_shift", "aten.bitwise_and"})
# Ops through which a tensor keeps the uint8 symbol buffer's provenance
# (the unpack converts the bytes to int32 before it shifts).
_CARRY_U8 = frozenset({"aten._to_copy", "aten.clone", "aten.index_select", "aten.gather",
                       "aten.index", "aten.slice", "aten.select", "aten.view",
                       "aten._unsafe_view", "aten.unsqueeze", "aten.expand",
                       "aten.reshape", "aten.permute", "aten.squeeze", "aten.alias"})
# Cross-device collectives: torch.distributed's ops reach the dispatcher in
# these namespaces (``dist.all_to_all_single`` as ``c10d.alltoall_base_``,
# ``dist.all_gather_single`` as ``c10d._allgather_base_``, DTensor's
# gather as ``_c10d_functional.all_gather_into_tensor``).
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "_c10d_functional_autograd"})
# Op-name stems of the collective kinds (c10d's and the functional ops'
# spellings).  Any other c10d op keeps its op name; any other functional op
# (``wait_tensor``, ``_wrap_tensor_autograd``) is bookkeeping, no collective.
_COLLECTIVE_KINDS = (("alltoall", "all_to_all"), ("all_to_all", "all_to_all"),
                     ("allgather", "all_gather"), ("all_gather", "all_gather"),
                     ("allreduce", "all_reduce"), ("all_reduce", "all_reduce"),
                     ("reduce_scatter", "reduce_scatter"), ("broadcast", "broadcast"))


class TensorMeta(NamedTuple):
    """What the record keeps of a tensor: no data."""

    shape: tuple
    dtype: torch.dtype
    key: int             # its untyped storage
    nbytes: float        # the view's bytes (numel x itemsize)


@dataclasses.dataclass
class OpNode:
    """One recorded op or kernel region."""

    name: str            # "aten.mm" (namespace.op) or the kernel wrapper's name
    kind: str            # "op" | "kernel"
    path: tuple          # enclosing kernel regions, outermost first
    inputs: tuple        # TensorMeta of every tensor argument
    outputs: tuple       # TensorMeta of every tensor result
    args: Any = None     # op: (args, kwargs) with tensors as TensorMeta;
                         # kernel: {parameter: TensorMeta or value}
    overload: str = ""   # the full op name, "aten.sort.stable"
    u8: bool = False     # an input carries the uint8 symbol buffer
    group_size: int = 0  # a collective: the ranks of its group (0: not known)


@dataclasses.dataclass
class OpRecord:
    """The op stream of one call, with the storages it touched."""

    nodes: list = dataclasses.field(default_factory=list)
    inputs: set = dataclasses.field(default_factory=set)     # storages of the call's args
    outputs: set = dataclasses.field(default_factory=set)    # storages of its result
    storage_bytes: dict = dataclasses.field(default_factory=dict)
    _held: dict = dataclasses.field(default_factory=dict, repr=False)
    _u8: set = dataclasses.field(default_factory=set, repr=False)
    _path: list = dataclasses.field(default_factory=list, repr=False)
    _open: list = dataclasses.field(default_factory=list, repr=False)

    def meta(self, t: torch.Tensor) -> TensorMeta:
        if type(t) is not torch.Tensor and _is_dtensor(t):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._held:
            self._held[key] = st
            self.storage_bytes[key] = float(st.nbytes())
            if t.dtype == torch.uint8:
                self._u8.add(key)
        return TensorMeta(tuple(t.shape), t.dtype, key, float(t.numel() * t.element_size()))

    def _metas(self, tree) -> tuple:
        leaves, _ = tree_flatten(tree)
        return tuple(self.meta(x) for x in leaves if isinstance(x, torch.Tensor))

    def _as_meta(self, x):
        return self.meta(x) if isinstance(x, torch.Tensor) else x

    def add_op(self, func, args, kwargs, out) -> None:
        name = f"{func.namespace}.{func.overloadpacket.__name__}"
        ins = self._metas((args, kwargs))
        outs = self._metas(out)
        u8 = any(m.key in self._u8 for m in ins)
        if u8 and name in _CARRY_U8:
            self._u8.update(m.key for m in outs)
        group = _group_size(func, args, kwargs) if collective_kind(name) is not None else 0
        self.nodes.append(OpNode(name, "op", tuple(self._path), ins, outs,
                                 tree_map(self._as_meta, (args, kwargs)), str(func), u8,
                                 group))

    # The kernel-region listener (repro_torch.kernels._region).
    def enter_region(self, name: str, bound: dict) -> None:
        ins = self._metas(list(bound.values()))
        node = OpNode(name, "kernel", tuple(self._path), ins, (),
                      {k: self._as_meta(v) for k, v in bound.items()}, name)
        self.nodes.append(node)
        self._open.append(node)
        self._path.append(name)

    def exit_region(self, name: str, result) -> None:
        self._path.pop()
        node = self._open.pop()
        node.outputs = self._metas(result)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective op runs over: its ``group_size``
    argument, its ``process_group`` (c10d) or the group its ``group_name``
    names (the functional ops), 0 where none is given."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, arg in enumerate(func._schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        if arg.name == "group_size":
            return int(val)
        if arg.name == "process_group":
            return dist.ProcessGroup.unbox(val).size()
        if arg.name == "group_name":
            return _resolve_process_group(val).size()
    return 0


class _Recorder(TorchDispatchMode):
    def __init__(self, record: OpRecord):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record.add_op(func, args, kwargs, out)
        return out


def record_call(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), record)``: the call's result and its op stream."""
    rec = OpRecord()
    rec.inputs = {m.key for m in rec._metas((args, kwargs))}
    with _Recorder(rec), listening(rec):
        out = fn(*args, **kwargs)
    rec.outputs = {m.key for m in rec._metas(out)}
    return out, rec


def iter_nodes(record: OpRecord) -> Iterator[tuple]:
    """Every ``(path, node)`` in program order, the ops inside kernel
    regions included (``path`` names the enclosing regions)."""
    for node in record.nodes:
        yield node.path, node


def primitive_counts(record: OpRecord) -> Counter:
    """Recursive op-name histogram (kernel regions by wrapper name)."""
    return Counter(node.name for _, node in iter_nodes(record))


def find_ops(record: OpRecord, names: Sequence[str]) -> list:
    """All ``(path, node)`` whose name is in ``names``."""
    names = frozenset(names)
    return [(p, n) for p, n in iter_nodes(record) if n.name in names]


def eqn_count(record: OpRecord, *, recursive: bool = False) -> int:
    """Node count: outside kernel regions by default (a region is one
    node), or every recorded op."""
    if recursive:
        return len(record.nodes)
    return sum(1 for n in record.nodes if not n.path)


def _is_uint8_unpack(node: OpNode) -> bool:
    """The signature of ``symbols.unpack_bits``: a shift (or mask) whose
    operand is the uint8 symbol buffer or a conversion of it."""
    return node.name in _UNPACK_OPS and node.u8


def index_decode_ops(record: OpRecord) -> list:
    """All ``(path, node)`` doing index-decode work: the sort/top-k family
    plus the uint8 symbol-unpack signature, inside kernel regions too."""
    return [(p, n) for p, n in iter_nodes(record)
            if n.name in INDEX_DECODE_OPS or _is_uint8_unpack(n)]


def kernel_regions(record: OpRecord) -> list:
    """Names of the outermost kernel regions, in program order."""
    return [n.name for n in record.nodes if n.kind == "kernel" and not n.path]


def collective_kind(name: str):
    """``"all_to_all"``, ``"all_gather"``, ``"all_reduce"``,
    ``"reduce_scatter"`` or ``"broadcast"`` for a collective op name
    (``c10d.alltoall_base_``, ``_c10d_functional.all_gather_into_tensor``),
    the op name itself for another c10d op, None for any other op (the
    functional namespaces' ``wait_tensor`` and ``_wrap_tensor_autograd``
    included)."""
    ns, _, op = name.partition(".")
    if ns not in COLLECTIVE_NAMESPACES:
        return None
    stem = op.strip("_")
    kind = next((kind for key, kind in _COLLECTIVE_KINDS if stem.startswith(key)), None)
    return name if kind is None and ns == "c10d" else kind


def collective_counts(record: OpRecord) -> Counter:
    """Histogram of the collective ops by kind (:func:`collective_kind`)."""
    return Counter(k for _, n in iter_nodes(record)
                   if (k := collective_kind(n.name)) is not None)
