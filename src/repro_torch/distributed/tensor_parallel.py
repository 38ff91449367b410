"""Tensor parallelism over the ``model`` axis, and the sharded step
builders' parameter gather, one block at a time.

**Megatron's operators** (Shoeybi et al., 2019), over the ranks of one
``model`` row (the mesh dims the rules' ``tp`` names):

* :func:`copy` (Megatron's *f*): the identity forward, the sum over the row
  backward.  A sublayer applies it to its input before the norm, so every
  rank's share of the input's gradient meets the others';
* :func:`reduce` (*g*): the sum over the row forward (of the row-parallel
  products' partial sums, in f32), the identity backward;
* :func:`gather`: a tensor's ``tp`` shards concatenated along one dim
  forward, the sum over the row cut to the rank's shard backward (the K/V
  projections, which every rank computes whole, and the layers whose head
  count does not divide the row);
* :func:`replicated`: the identity forward and the gradient over the row's
  size backward, for what every rank of the row computes whole (the MoE's
  load-balancing loss, a sublayer computed replicated): its gradient then
  sums over the row as a partial one does;
* :func:`all_gather`: an activation's shards concatenated, no gradient
  (the DiT's masks of each rank's heads, from which every rank builds the
  same plan).

With these, the gradient of every parameter that a rank computes with whole
(a norm, the router, K/V's weights) is a partial sum over the row, and the
gradient of a ``tp`` shard is the rank's own.  Outside :func:`model_parallel`
(a row of one rank) each operator returns its input, so the models compute
as before.  The moves go through
:func:`~repro_torch.distributed.sharding.redistribute` on DTensors built from
the local tensors (so a ``gloo`` world of card tensors moves them between
the ranks' tensors on one host, or through the host).

**The per-block gather** (:class:`ParamGather`).  A step builder hands the
model its parameters as local tensors: the leaves outside the block stacks
gathered once (over the ``fsdp`` dims, and over ``model`` unless the step
splits it), the block stacks as the rank's own shards.  The model takes a
block through :func:`repro_torch.models.layers.block`, which here gathers
that block's slice of the shards and nothing else; the block's tensors are
freed once the model drops them.  In a train step each gather is an
autograd function whose backward reduces the block's gradient over the
``dp`` dims (and over the row for what the rank computed whole) and adds the
rank's shard of it to a gradient buffer as soon as it exists, and a
saved-tensor hook keeps only a handle to each gathered tensor that autograd
would save, gathering it again in backward.  Under ``cfg.remat`` the block
is taken inside the checkpointed region (:class:`~repro_torch.models.layers.
BlockRef`), so the recompute gathers it again.

**The ``dp`` group** (:func:`dp_group`, :func:`dp_sum`): the ranks over
which a step splits its batch, carried by the active :class:`ParamGather`,
for what the model computes over the global batch (the MoE's routing,
:func:`repro_torch.models.layers.moe_route_global`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import weakref
from typing import Any, Iterator, Optional

import torch

from repro_torch.distributed.sharding import ShardingRules, redistribute
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["size", "rank", "divides", "note", "model_parallel", "copy", "reduce", "gather",
           "replicated", "all_gather", "row_max", "vocab_lookup", "dp_group", "dp_sum",
           "mesh_dims", "ParamGather"]


# ---------------------------------------------------------------------------
# DTensors from local tensors
# ---------------------------------------------------------------------------

def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _dtensor(local: torch.Tensor, mesh, pl, shape):
    """The DTensor of global ``shape`` over ``mesh`` whose local tensor,
    laid out as ``pl``, is ``local`` (nothing is checked or moved)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _same_layout(a, b, mesh) -> bool:
    """Placements ``a`` and ``b`` hold the same local tensor on every rank:
    they agree on every mesh dim wider than one."""
    return all(pa == pb or mesh.size(i) == 1 for i, (pa, pb) in enumerate(zip(a, b)))


def mesh_dims(mesh, rules: ShardingRules, logical: str) -> tuple:
    """The mesh dims (indices) that the rules map ``logical`` onto."""
    axes = rules.physical(logical)
    axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
    return tuple(mesh.mesh_dim_names.index(a) for a in axes)


# ---------------------------------------------------------------------------
# The model row
# ---------------------------------------------------------------------------

class _Row:
    """The ranks of one ``model`` row: the mesh dims it spans, its size and
    this rank's place in it (major first, as DTensor nests shards)."""

    def __init__(self, mesh, dims: tuple):
        self.mesh, self.dims = mesh, tuple(dims)
        self.size = math.prod(mesh.size(i) for i in dims)
        coord, r = mesh.get_coordinate(), 0
        for i in dims:
            r = r * mesh.size(i) + coord[i]
        self.rank = r
        self.notes: set = set()

    def placements(self, on_row) -> list:
        """``on_row`` on the row's mesh dims, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate
        return [on_row if i in self.dims else Replicate() for i in range(self.mesh.ndim)]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the row (in f32 for half types), every rank
        the same bits."""
        from torch.distributed.tensor import Partial, Replicate
        dt = x.dtype
        xs = x.to(torch.float32) if dt in (torch.bfloat16, torch.float16) else x
        xs = xs.contiguous()
        out = redistribute(_dtensor(xs, self.mesh, self.placements(Partial()), xs.shape),
                           self.placements(Replicate())).to_local()
        return out.to(dt)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The row's shards of ``x`` concatenated along ``dim``."""
        from torch.distributed.tensor import Replicate, Shard
        dim = dim % x.ndim
        shape = list(x.shape)
        shape[dim] *= self.size
        return redistribute(_dtensor(x.contiguous(), self.mesh, self.placements(Shard(dim)),
                                     shape), self.placements(Replicate())).to_local()

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of ``x`` along ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n).contiguous()


# The active model row (``None``: a row of one rank) and parameter gather.
# A recompute under ``cfg.remat`` may run on autograd's device thread,
# which sees none of the caller's context variables: ``snapshot`` and
# ``restored`` carry them there (models/transformer.remat).
_CTX: contextvars.ContextVar[tuple] = contextvars.ContextVar("tensor_parallel",
                                                             default=(None, None))


def snapshot() -> tuple:
    """The active row and gather, for :func:`restored`."""
    return _CTX.get()


@contextlib.contextmanager
def restored(snap: tuple) -> Iterator[None]:
    """The row and gather of :func:`snapshot` active within the block."""
    tok = _CTX.set(snap)
    try:
        yield
    finally:
        _CTX.reset(tok)


@contextlib.contextmanager
def model_parallel(mesh, dims: tuple) -> Iterator[None]:
    """The operators of this module act over the ranks of ``mesh``'s dims
    ``dims`` within the block (a row of one rank: they act as the identity)."""
    row = _Row(mesh, dims)
    with restored((row if row.size > 1 else None, _CTX.get()[1])):
        yield


def _row() -> Optional[_Row]:
    return _CTX.get()[0]


def block_source():
    """The active :class:`ParamGather` (``None`` outside a sharded step)."""
    return _CTX.get()[1]


def dp_group() -> Optional[_Row]:
    """The ranks over which the active step splits its batch (the rules'
    ``dp`` mesh dims, this rank's place in them the batch's order), or ``None``
    outside a sharded step or where ``dp`` holds one rank."""
    src = block_source()
    return None if src is None else src.dp


class _DpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return grp.sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grp.sum(g), None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ``dp`` group (:func:`dp_group`; ``x`` itself
    outside one).  Its gradient is the sum over the group of the ranks'
    gradients of the result: each rank's loss holds the same global term,
    so the step's mean over ``dp`` of the parameter gradients gives that
    term's gradient once."""
    grp = dp_group()
    if grp is None:
        return x
    return _DpSum.apply(x, grp) if torch.is_grad_enabled() and x.requires_grad else grp.sum(x)


def size() -> int:
    """The size of the active model row (1 outside :func:`model_parallel`)."""
    row = _row()
    return 1 if row is None else row.size


def rank() -> int:
    """This rank's place in the active model row (0 outside one)."""
    row = _row()
    return 0 if row is None else row.rank


def divides(n: int, what: str) -> bool:
    """Whether ``n`` (heads, or ``d_ff``) splits over the active model row;
    a row of more than one rank that it does not divide computes ``what``
    replicated, which is noted (:func:`note`)."""
    m = size()
    if m == 1:
        return False
    if n % m:
        note(f"{what}: {n} on a model row of {m}")
        return False
    return True


def note(what: str) -> None:
    """Record that a layer computed the row's work replicated
    (:class:`ParamGather` reports it in ``stats["tp_replicated"]``)."""
    row = _row()
    if row is not None:
        row.notes.add(what)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row):
        ctx.row = row
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.row.sum(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row):
        return row.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, row):
        ctx.row, ctx.dim = row, dim
        src = x.grad_fn
        # A block's gathered weight: the per-block gather can fetch it again.
        ctx.source = ((src.ids, src.idx, x.output_nr)
                      if isinstance(src, _BlockGather._backward_cls) and src.idx is not None
                      else None)
        out = row.all_gather(x, dim)
        if block_source() is not None:
            block_source()._count(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return ctx.row.shard(ctx.row.sum(g), ctx.dim), None, None


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``x``; its gradient summed over the row."""
    row = _row()
    if row is None or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, row)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over the row; the gradient passed as it
    is."""
    row = _row()
    return x if row is None else _Reduce.apply(x, row)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The row's shards of ``x`` concatenated along ``dim``; the gradient
    summed over the row and cut to this rank's shard."""
    row = _row()
    return x if row is None else _Gather.apply(x, dim, row)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x``, computed whole on every rank of the row; its gradient over the
    row's size, so that it sums over the row as a partial one does."""
    row = _row()
    if row is None or not torch.is_grad_enabled():
        return x
    return _Scale.apply(x, 1.0 / row.size)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The row's shards of ``x`` concatenated along ``dim``, without a
    gradient and not counted as gathered parameters (an activation the
    rank computed for its share of the row)."""
    row = _row()
    if row is None:
        return x
    with torch.no_grad():
        return row.all_gather(x, dim)


def row_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the row (no gradient)."""
    row = _row()
    if row is None:
        return x.detach()
    with torch.no_grad():
        return row.all_gather(x.detach().unsqueeze(-1), -1).amax(dim=-1)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``ids``, with ``table`` this rank's shard of
    the vocabulary (rows ``rank · V_local`` on): rows outside the shard give
    zeros, then the sum over the row (exact: one rank holds each row)."""
    row = _row()
    if row is None:
        return table[ids]
    v_loc = table.shape[0]
    local = ids.to(torch.int64) - row.rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    return reduce(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                   device=rows.device)))


# ---------------------------------------------------------------------------
# The per-block parameter gather
# ---------------------------------------------------------------------------

def _n_indexed(idx) -> int:
    return 0 if idx is None else len(idx) if isinstance(idx, tuple) else 1


class _Leaf:
    """One parameter: its local shard, layout, global shape, the layout the
    step computes with and the mesh dims its gradient sums over."""

    def __init__(self, x, compute: list, reduce_dims: tuple):
        self.local = x.to_local()
        self.pl, self.shape = list(x.placements), tuple(x.shape)
        self.compute, self.reduce_dims = compute, reduce_dims

    def sliced(self, n: int) -> tuple:
        """``(placements, compute placements, global shape)`` of a slice
        that drops ``n`` leading (stacked, never sharded) dims."""
        from torch.distributed.tensor import Shard

        def shift(p):
            if not isinstance(p, Shard):
                return p
            if p.dim < n:
                raise ValueError(f"a block stack is sharded on its stacked dim {p.dim}")
            return Shard(p.dim - n)

        return [shift(p) for p in self.pl], [shift(p) for p in self.compute], self.shape[n:]


def _unflatten(flat: torch.Tensor, like: list) -> list:
    """``flat`` cut into views shaped as the tensors of ``like``, in order."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _flat_all_gather(mesh, dims: tuple, tensors: list) -> list:
    """Every rank's copy of each of ``tensors`` (one dtype) over the mesh
    dims ``dims``, in one collective: the tensors flattened into one
    buffer, gathered, and each rank's pieces returned, ``[tensor][rank]``
    with the ranks in linear order over ``dims`` (major first, as DTensor
    nests shards)."""
    from torch.distributed.tensor import Replicate, Shard
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n = math.prod(mesh.size(d) for d in dims)
    pl = [Shard(0) if d in dims else Replicate() for d in range(mesh.ndim)]
    whole = redistribute(_dtensor(flat, mesh, pl, (flat.numel() * n,)),
                         [Replicate()] * mesh.ndim).to_local().view(n, -1)
    return [list(parts) for parts in zip(*(_unflatten(whole[r], tensors) for r in range(n)))]


def _flat_sum(mesh, dims: tuple, tensors: list) -> list:
    """Each of ``tensors`` (one dtype) summed over the mesh dims ``dims``,
    in one collective."""
    from torch.distributed.tensor import Partial, Replicate
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pl = [Partial() if d in dims else Replicate() for d in range(mesh.ndim)]
    flat = redistribute(_dtensor(flat, mesh, pl, flat.shape),
                        [Replicate()] * mesh.ndim).to_local()
    return _unflatten(flat, tensors)


def _assemble(pieces: list, sizes: list, tdims: list) -> torch.Tensor:
    """The whole tensor from its shards ``pieces`` (linear order over the
    gathered mesh dims, whose sizes are ``sizes`` and whose tensor dims are
    ``tdims``): the innermost mesh dim concatenated first."""
    for n, d in reversed(list(zip(sizes, tdims))):
        pieces = [torch.cat(pieces[j:j + n], dim=d) for j in range(0, len(pieces), n)]
    return pieces[0]


class _BlockGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, gath, ids, idx):
        ctx.gath, ctx.ids, ctx.idx = gath, ids, idx
        outs, ctx.moved = gath._gather(ids, idx)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.gath._grad(ctx.ids, ctx.idx, grads)
        return (torch.zeros((), dtype=ctx.gath.anchor.dtype, device=grads[0].device),
                None, None, None)


class _Saved:
    """A handle to a gathered tensor that autograd saved: which block leaf,
    and how the saved tensor sits on its gathered form."""

    __slots__ = ("key", "dtype", "size", "stride", "offset", "cast")

    def __init__(self, key, t: torch.Tensor, cast: bool):
        self.key, self.dtype, self.cast = key, t.dtype, cast
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


_VIEWS = {"ViewBackward0", "UnsafeViewBackward0", "TBackward0", "TransposeBackward0",
          "PermuteBackward0", "SelectBackward0", "SliceBackward0", "ExpandBackward0",
          "AliasBackward0", "ReshapeAliasBackward0", "UnsqueezeBackward0",
          "SqueezeBackward0", "SqueezeBackward1", "AsStridedBackward0"}


def _gathered_key(node, nr: int) -> Optional[tuple]:
    """``(leaves, idx, output, dim)`` when output ``nr`` of ``node`` is a
    gathered block tensor that can be fetched again: a block gather's output
    that moved data (``dim`` None), or a row gather of a block's weight
    (``dim`` its dim)."""
    if isinstance(node, _BlockGather._backward_cls):
        if node.idx is None or not node.moved[nr]:
            return None
        return (node.ids, node.idx, nr, None)
    if isinstance(node, _Gather._backward_cls) and node.source is not None:
        return (*node.source, node.dim)
    return None


class ParamGather:
    """A sharded step's parameters, gathered one block at a time.

    ``tp``: split the rules' ``tp`` dims (keep each leaf's ``tp`` shard and
    run the model under :func:`model_parallel` over them); else every leaf
    is gathered whole.  ``cast_bf16``: f32 shards are cast to bf16 before
    they are gathered.  ``train``: the gathers are differentiable, each
    leaf's gradient (over ``n_dp``, summed over the ``dp`` dims, and over
    the row where the leaf is computed whole under ``tp``) lands in
    :attr:`grads` as the rank's shard, in the tree's leaf order
    (:meth:`take_grads`).  :attr:`dp` is the group of ranks over which the
    step splits its batch (:func:`dp_group`; ``None`` for one rank), for
    what the model computes over the global batch (the MoE's routing).
    ``max_gathered_bytes`` is the most bytes of gathered parameters alive at
    once (a gathered tensor lives while its tensor object does)."""

    def __init__(self, mesh, rules: ShardingRules, *, tp: bool, cast_bf16: bool = False,
                 train: bool = False, n_dp: int = 1):
        self.mesh, self.cast_bf16, self.train, self.n_dp = mesh, cast_bf16, train, n_dp
        self.row_dims = mesh_dims(mesh, rules, "tp") if tp else ()
        self.dp_dims = mesh_dims(mesh, rules, "dp")
        self.row = _Row(mesh, self.row_dims) if self.row_dims else None
        if self.row is not None and self.row.size == 1:
            self.row = None
        self.dp = _Row(mesh, self.dp_dims) if self.dp_dims else None
        if self.dp is not None and self.dp.size == 1:
            self.dp = None
        self.leaves: list = []
        self.grads: list = []
        self._stacks: list = []
        self._cache: dict = {}
        self._cache_block = None
        self.anchor = None
        self.alive = self.max_gathered_bytes = 0

    # -- set-up -------------------------------------------------------------

    def _leaf(self, x) -> _Leaf:
        from torch.distributed.tensor import Replicate
        row = self.row_dims if self.row is not None else ()
        compute = [p if i in row else Replicate() for i, p in enumerate(x.placements)]
        reduce_dims = self.dp_dims + tuple(i for i in row if x.placements[i] == Replicate())
        return _Leaf(x, compute, tuple(i for i in reduce_dims if self.mesh.size(i) > 1))

    def prepare(self, params: Any, block_groups: tuple) -> Any:
        """The tree the model runs on: the top-level groups in
        ``block_groups`` as the rank's shards (taken a block at a time by
        :func:`~repro_torch.models.layers.block`), every other leaf gathered
        now.  ``params`` is a tree of DTensors."""
        flat, tdef = tree_flatten(params)
        groups = []
        for key in sorted(params):
            n = len(tree_flatten(params[key])[0])
            groups += [key if key in block_groups else None] * n
        device = flat[0].to_local().device
        if self.train:
            self.anchor = torch.zeros((), device=device, requires_grad=True)
        for x in flat:
            self.leaves.append(self._leaf(x))
            self.grads.append(None)
        out = [leaf.local for leaf in self.leaves]
        outside = [i for i, g in enumerate(groups) if g is None]
        for i, t in zip(outside, self._apply(tuple(outside), None)):
            out[i] = t
        tree = tree_unflatten(tdef, out)
        # Each block stack as the model will pass it to layers.block, with
        # its leaves' places in the tree.
        self._stacks = [(tree[key], tuple(i for i, g in enumerate(groups) if g == key))
                        for key in sorted(params) if key in block_groups]
        return tree

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """Within the block, :func:`~repro_torch.models.layers.block` gathers
        through this object, the row's operators act (``tp``), and, for a
        train step, autograd saves handles to the gathered block tensors."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(restored((self.row, self)))
            if self.train:
                stack.enter_context(torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                                             self._unpack))
            yield
        self._cache.clear()

    def stats(self) -> dict:
        return {"max_gathered_bytes": self.max_gathered_bytes,
                "tp_replicated": sorted(self.row.notes) if self.row is not None else []}

    # -- gathering ----------------------------------------------------------

    def block(self, group: dict, idx) -> dict:
        """One block's parameters: ``group``'s leaves at ``idx``, gathered."""
        ids = next((ids for stack, ids in self._stacks if stack is group), None)
        if ids is None:
            raise ValueError("layers.block was given a group that is not one of the step's "
                             "block stacks")
        return tree_unflatten(tree_flatten(group)[1], self._apply(ids, idx))

    def _apply(self, ids: tuple, idx) -> list:
        if not ids:
            return []
        if self.train and torch.is_grad_enabled():
            out = _BlockGather.apply(self.anchor, self, ids, idx)
            return list(out) if isinstance(out, tuple) else [out]
        return self._gather(ids, idx)[0]

    def _count(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.alive += n
        self.max_gathered_bytes = max(self.max_gathered_bytes, self.alive)
        weakref.finalize(t, self._freed, n)

    def _freed(self, n: int) -> None:
        self.alive -= n

    def _gather(self, ids: tuple, idx) -> tuple:
        """``(tensors, moved)``: leaves ``ids`` (at ``idx``) in their compute
        layout, the leaves that share gathered mesh dims and a dtype moved
        in one collective; ``moved[j]`` when tensor ``j`` is new (gathered
        or cast), not a view of the shard."""
        n = _n_indexed(idx)
        outs, moved, todo = [], [], {}
        for j, i in enumerate(ids):
            leaf = self.leaves[i]
            # A fresh view even of the whole shard: a differentiable gather's
            # output takes a grad_fn, which must not land on the caller's tensor.
            local = leaf.local.view_as(leaf.local) if idx is None else leaf.local[idx]
            pl, compute, _ = leaf.sliced(n)
            cast = self.cast_bf16 and local.dtype == torch.float32
            if cast:
                local = local.to(torch.bfloat16)
            dims = tuple(d for d, (a, b) in enumerate(zip(pl, compute))
                         if a != b and self.mesh.size(d) > 1)
            if dims:
                todo.setdefault((local.dtype, dims), []).append((j, local, pl))
            outs.append(local)
            moved.append(cast or bool(dims))
        for (_, dims), items in todo.items():
            pieces = _flat_all_gather(self.mesh, dims, [t.contiguous() for _, t, _ in items])
            sizes = [self.mesh.size(d) for d in dims]
            for (j, _, pl), parts in zip(items, pieces):
                outs[j] = _assemble(parts, sizes, [pl[d].dim for d in dims])
        for j, t in enumerate(outs):
            if moved[j]:
                self._count(t)
        return outs, moved

    def _grad(self, ids: tuple, idx, grads) -> None:
        """Add this rank's shard of each leaf's reduced gradient to its
        buffer; the gradients that sum over the same mesh dims in one
        collective."""
        from torch.distributed.tensor import Replicate
        n = _n_indexed(idx)
        todo: dict = {}
        for i, g in zip(ids, grads):
            leaf = self.leaves[i]
            g = g.to(leaf.local.dtype)
            g = (g / self.n_dp if self.n_dp > 1 else g).contiguous()
            todo.setdefault((g.dtype, leaf.reduce_dims), []).append((i, g))
        for (_, dims), items in todo.items():
            summed = (_flat_sum(self.mesh, dims, [g for _, g in items]) if dims
                      else [g for _, g in items])
            for (i, _), g in zip(items, summed):
                leaf = self.leaves[i]
                pl, compute, shape = leaf.sliced(n)
                mid = [Replicate() if d in dims else p for d, p in enumerate(compute)]
                g = redistribute(_dtensor(g, self.mesh, mid, shape), pl).to_local()
                if self.grads[i] is None:     # made when backward first reaches the leaf
                    self.grads[i] = torch.zeros_like(leaf.local)
                buf = self.grads[i]
                (buf if idx is None else buf[idx]).add_(g)

    def take_grads(self) -> list:
        """The gradient buffers, in the tree's leaf order (zeros for a leaf
        backward never reached), handed over: this object keeps none."""
        out = [torch.zeros_like(leaf.local) if g is None else g
               for g, leaf in zip(self.grads, self.leaves)]
        self.grads = []
        return out

    # -- saved tensors ------------------------------------------------------

    def _pack(self, t: torch.Tensor):
        node, nr = t.grad_fn, t.output_nr
        key = _gathered_key(node, nr)
        if key is not None:
            return _Saved(key, t, cast=False)
        name = type(node).__name__ if node is not None else ""
        if name == "ToCopyBackward0" and t.is_contiguous():
            key = _gathered_key(*node.next_functions[0])
            return t if key is None else _Saved(key, t, cast=True)
        while name in _VIEWS:
            node, nr = node.next_functions[0]
            key = _gathered_key(node, nr)
            if key is not None:
                return _Saved(key, t, cast=False)
            name = type(node).__name__ if node is not None else ""
        return t

    def _unpack(self, s):
        if not isinstance(s, _Saved):
            return s
        base = self._regather(s.key)
        if s.cast:
            return base.to(s.dtype)
        return base.as_strided(s.size, s.stride, s.offset)

    def _regather(self, key: tuple) -> torch.Tensor:
        """The gathered tensor of ``key`` again (its whole block in one
        collective), kept while backward stays in that block."""
        ids, idx, nr, dim = key
        if (ids, idx) != self._cache_block:
            self._cache.clear()
            self._cache_block = (ids, idx)
        if (nr, None) not in self._cache:
            with torch.no_grad():
                for j, t in enumerate(self._gather(ids, idx)[0]):
                    self._cache[(j, None)] = t
        if (nr, dim) not in self._cache:
            with torch.no_grad():
                t = self.row.all_gather(self._cache[(nr, None)], dim)
            self._count(t)
            self._cache[(nr, dim)] = t
        return self._cache[(nr, dim)]
