"""Logical-axis sharding rules with divisibility fallbacks, on a
``torch.distributed`` ``DeviceMesh`` (the counterpart of
``repro.sharding.rules``).

Model code names tensor dimensions with *logical* axes ('batch', 'ff',
'q_heads', ...). A ``ShardingCtx`` maps them to mesh axes. A spec is a
plain tuple with one entry per tensor dim: None, a mesh-axis name, or a
tuple of names (the reference's ``PartitionSpec``); ``placements`` turns
it into DTensor ``Shard(i)`` / ``Replicate()`` per mesh dim. When a
dimension does not divide the product of its mesh axes, the mapping falls
back to a prefix of them, then to replication, as the reference's does.

Under a mesh, ``shard()`` redistributes a DTensor to the spec (the
reference's ``with_sharding_constraint``); on a plain tensor or with no
mesh it returns its input. ``shard_map`` runs a function on each rank's
local shards, as the reference's ``shard_map`` does, and the collectives
below (``all_gather``, ``psum``, ``pmax``, ``psum_scatter``,
``all_to_all``, ``axis_index``) are the reference's ``jax.lax`` ones over
a mesh axis's process group, each with the reference's transpose as its
backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

# Default logical-axis -> mesh-axis rules for the production meshes
# (data, model) and (pod, data, model).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),          # context parallelism for long activations
    "embed": (),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff": (),
    "layers": (),
    "kv_seq": ("model",),       # decode KV caches: shard the sequence axis
    "state": (),
    "zero": ("pod", "data"),    # optimizer-state (ZeRO-1) extra axis
    "none": (),
}


def mesh_shape(mesh) -> dict[str, int]:
    """Mesh-axis sizes by name, in mesh order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and shape, or any object whose ``shape`` maps names
    to sizes (a mesh shape alone; no process group needed)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_axes(part) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements, one per mesh dim, for a spec: ``Shard(i)`` on
    each mesh dim that tensor dim i is split over, ``Replicate()``
    elsewhere and on a mesh dim of size 1 (one shard is the whole; DTensor
    would refuse to merge such a dim with its neighbours). A dim split
    over several mesh axes names them in mesh order (DTensor splits a
    tensor dim over mesh dims left to right, major first, as
    ``PartitionSpec`` does over its tuple)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: list[Any] = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(part)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} is not in mesh order "
                             f"{tuple(names)}")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def local_shape(mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """One rank's shard shape of a tensor of ``shape`` laid out by
    ``spec`` (the spec's fallback keeps every sharded dim divisible)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, part in enumerate(spec):
        n = math.prod(sizes[a] for a in spec_axes(part))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {part!r}")
        out[i] //= n
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the reference's ``NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any = None
    rules: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    # the reference's analysis mode (unrolled scans); the port's layer
    # loops are Python loops, so only ``scan_unroll()`` reads it
    unroll: bool = False

    def mesh_axes(self, logical: str) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        sizes = mesh_shape(self.mesh)
        return tuple(a for a in self.rules.get(logical, ()) if a in sizes)

    def axes_size(self, logical: str) -> int:
        sizes = mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in self.mesh_axes(logical))

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int] | None) -> tuple:
        """The spec for the given logical axes, with divisibility checks
        when ``shape`` is provided: a dim that does not divide keeps the
        longest prefix of its mesh axes that it does divide."""
        sizes = mesh_shape(self.mesh)
        parts: list[Any] = []
        used: set[str] = set()
        for i, name in enumerate(logical_axes):
            if name is None or name == "none" or self.mesh is None:
                parts.append(None)
                continue
            axes = tuple(a for a in self.mesh_axes(name) if a not in used)
            if not axes:
                parts.append(None)
                continue
            size = math.prod(sizes[a] for a in axes)
            if shape is not None and shape[i] % size != 0:
                while axes and shape[i] % size != 0:
                    size //= sizes[axes[-1]]
                    axes = axes[:-1]
                if not axes:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def sharding(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int] | None = None) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))

    def placements(self, logical_axes: Sequence[str | None],
                   shape: Sequence[int] | None = None) -> tuple:
        return placements(self.mesh, self.spec(logical_axes, shape))


_tls = threading.local()


def set_ctx(ctx: ShardingCtx | None) -> None:
    _tls.ctx = ctx


def current_ctx() -> ShardingCtx:
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else ShardingCtx()


def current_mesh():
    return current_ctx().mesh


@contextlib.contextmanager
def use_ctx(mesh, rules: dict[str, tuple[str, ...]] | None = None,
            unroll: bool = False):
    """Run the model under ``mesh`` (a ``DeviceMesh`` or None) and the
    default rules updated by ``rules``. Under a ``DeviceMesh`` a plain
    tensor meeting a DTensor counts as replicated (DTensor's implicit
    replication): the model builds its RoPE tables, masks and positions
    whole on every rank."""
    prev = getattr(_tls, "ctx", None)
    ctx = ShardingCtx(mesh=mesh, unroll=unroll)
    if rules:
        ctx.rules.update(rules)
    set_ctx(ctx)
    try:
        if is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield ctx
        else:
            yield ctx
    finally:
        set_ctx(prev)


def bind_ctx(fn: Callable) -> Callable:
    """``fn`` run under the context current now, wherever it is called:
    a layer recomputed by ``torch.utils.checkpoint`` runs in autograd's
    device thread, where the thread-local context is not set."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return fn

    def bound(*args, **kw):
        prev = getattr(_tls, "ctx", None)
        set_ctx(ctx)
        try:
            return fn(*args, **kw)
        finally:
            set_ctx(prev)

    return bound


def scan_unroll() -> bool:
    """Whether model-code scans should unroll (analysis mode)."""
    return current_ctx().unroll


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 if no mesh)."""
    return current_ctx().axes_size(logical)


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the logical axes' spec (the reference's
    sharding constraint); a plain tensor, or any tensor with no mesh, is
    returned as it is. Dimensions that do not divide their mapped mesh
    axes fall back to replication."""
    ctx = current_ctx()
    if ctx.mesh is None or not is_dtensor(x):
        return x
    pl = ctx.placements(logical_axes, x.shape)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(ctx.mesh, pl)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank (gathered, partial sums
    reduced), before an op that DTensor has no sharding rule for; a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N). DTensor multiplies a 3-D x by
    flattening its leading dims to rows, which it refuses (before torch
    2.13) when a dim after the first is sharded, as the sequence is under
    context parallelism: such an x is cut into its local rows on each
    rank, multiplied as a (rows, K) DTensor sharded along the rows, and
    put back in its layout (a row-wise product keeps each rank's rows)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.dim() - 1
    if not is_dtensor(x) or x.dim() <= 2 or not any(
            isinstance(p, Shard) and 0 < p.dim < last for p in x.placements):
        return x @ w
    mesh = x.device_mesh
    rows_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim < last
                    else Shard(1) if isinstance(p, Shard) else p
                    for p in x.placements)
    loc = x.to_local()
    rows = DTensor.from_local(
        loc.reshape(-1, loc.shape[-1]), mesh, rows_pl, run_check=False,
        shape=torch.Size((math.prod(x.shape[:-1]), x.shape[-1])),
        stride=(x.shape[-1], 1))
    out_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim < last
                   else Replicate() for p in x.placements)
    out = (rows @ w).redistribute(mesh, out_pl).to_local()
    out = out.reshape(*loc.shape[:-1], out.shape[-1])
    shape = torch.Size((*x.shape[:-1], out.shape[-1]))
    return DTensor.from_local(
        out, mesh, tuple(p if isinstance(p, Shard) and p.dim < last
                         else Replicate() for p in x.placements),
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; a DTensor's gradient is brought back to ``x``'s own
    layout in the backward (a redistribute to its own placements moves
    nothing forward), before a reshape that DTensor cannot take in the
    gradient's layout."""
    return x.redistribute(x.device_mesh, x.placements) if is_dtensor(x) \
        else x


def logical_sharding(logical_axes: Sequence[str | None],
                     shape: Sequence[int]) -> NamedSharding | None:
    return current_ctx().sharding(logical_axes, shape)


def tree_map2(fn: Callable, tree, axes):
    """``fn(leaf, axes_leaf)`` over a dict tree and its axes tree."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def abstract_leaf(t: torch.Tensor, axes, ctx: ShardingCtx | None = None):
    """A meta tensor carrying the logical axes' sharding: with a
    ``DeviceMesh``, a DTensor over a meta local shard of the spec's local
    shape; otherwise the meta tensor itself."""
    ctx = ctx or current_ctx()
    if not is_device_mesh(ctx.mesh):
        return t
    return sharded_zeros(t, axes, "meta", ctx)


def sharded_zeros(t: torch.Tensor, axes, device,
                  ctx: ShardingCtx | None = None):
    """Zeros of ``t``'s shape and dtype on ``device``. With a
    ``DeviceMesh``, a DTensor laid out by the logical axes of which each
    rank allocates its own shard only (a tensor sharded because it does
    not fit whole on one device is never whole anywhere)."""
    ctx = ctx or current_ctx()
    if not is_device_mesh(ctx.mesh):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    from torch.distributed.tensor import DTensor
    spec = ctx.spec(axes, t.shape)
    local = torch.zeros(local_shape(ctx.mesh, spec, t.shape), dtype=t.dtype,
                        device=device)
    return DTensor.from_local(local, ctx.mesh, placements(ctx.mesh, spec),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def abstract_sharded(tree_struct, axes_tree) -> Any:
    """Attach the logical axes' shardings to a tree of meta tensors."""
    ctx = current_ctx()
    return tree_map2(lambda t, ax: abstract_leaf(t, ax, ctx), tree_struct,
                     axes_tree)


def distribute(t: torch.Tensor, axes, ctx: ShardingCtx | None = None):
    """A whole tensor, the same on every rank, as a DTensor laid out by
    the logical axes; a plain tensor as it is without a ``DeviceMesh``."""
    ctx = ctx or current_ctx()
    if not is_device_mesh(ctx.mesh) or is_dtensor(t):
        return t
    return from_whole(t, ctx.mesh, ctx.placements(axes, t.shape))


def from_whole(t: torch.Tensor, mesh, pl: Sequence):
    """The DTensor over ``mesh`` with placements ``pl`` whose shards are
    cut from the whole tensor ``t`` every rank holds: no collective, and
    no copy where a shard is the whole (a mesh dim of size 1)."""
    from torch.distributed.tensor import DTensor, Shard
    local = t
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(j), dim=p.dim)[
                mesh.get_local_rank(j)]
    return DTensor.from_local(local.contiguous(), mesh, tuple(pl),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def mesh_dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def local_part(x) -> tuple[torch.Tensor, tuple[int, ...]]:
    """A DTensor's local shard (its storage: writes into it write the
    DTensor) and the shard's offset along each tensor dim."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    loc = x.to_local()
    idx = [0] * x.dim()
    for j, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            idx[pl.dim] = idx[pl.dim] * mesh.size(j) + mesh.get_local_rank(j)
    return loc, tuple(i * n for i, n in zip(idx, loc.shape))


def gathered(pl: Sequence, dims) -> tuple:
    """Placements ``pl`` with the tensor dims ``dims`` whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                 for p in pl)


def gather_dims(x, dims):
    """A DTensor with ``dims`` gathered whole (its other dims keep their
    sharding), before an op DTensor takes only along unsharded dims: a
    layer selected along a ZeRO/FSDP-sharded stack dim, a head split of a
    dim sharded over more ranks than heads; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    pl = gathered(x.placements, set(dims))
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def dim_shards(x, dim: int) -> int:
    """Over how many shards a DTensor splits ``dim``."""
    from torch.distributed.tensor import Shard
    return math.prod(x.device_mesh.size(j) for j, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim)


# ------------------------------------------------------------ shard_map
def _to_local(x, mesh, spec, grad_pl):
    """A DTensor (or a whole tensor, replicated) as this rank's shard by
    ``spec``; its gradient comes back with ``grad_pl``."""
    if not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    pl = placements(mesh, spec)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return x.to_local(grad_placements=grad_pl)


def _from_local(t, mesh, spec):
    from torch.distributed.tensor import DTensor
    sizes = mesh_shape(mesh)
    shape = list(t.shape)
    for i, part in enumerate(spec):
        shape[i] *= math.prod(sizes[a] for a in spec_axes(part))
    stride = torch.empty(shape, device="meta").stride()
    # contiguous: DTensor's views of a DTensor act on its local shard
    return DTensor.from_local(t.contiguous(), mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def shard_map(f: Callable, *, mesh, in_specs: Sequence, out_specs,
              whole_grads: bool = False):
    """``f`` over each rank's local shards, the reference's ``shard_map``:
    every tensor argument is redistributed to its spec in ``in_specs``
    (a plain tensor counts as whole and replicated) and handed to ``f``
    as this rank's shard; each tensor ``f`` returns becomes a DTensor by
    its spec in ``out_specs`` (a spec, or a list of specs for a tuple of
    outputs). Non-tensor arguments pass through.

    Gradients follow the reference's transpose: an input replicated over
    a mesh axis on which another input or the output is split gets a
    ``Partial`` (summed) gradient there, since each rank's share of it
    differs; elsewhere its gradient keeps its placement. With
    ``whole_grads`` (``f`` is a Function whose backward sums its own
    gradients, the reference's custom VJPs) every gradient keeps its
    input's placement."""
    from torch.distributed.tensor import Partial, Replicate

    multi = isinstance(out_specs, list)
    outs = tuple(out_specs) if multi else (out_specs,)
    names = list(mesh_shape(mesh))
    split_on = set()
    for spec in (*in_specs, *outs):
        for part in spec:
            split_on.update(spec_axes(part))

    def grad_placements(spec):
        pl = list(placements(mesh, spec))
        for j, name in enumerate(names):
            if (isinstance(pl[j], Replicate) and name in split_on
                    and not whole_grads):
                pl[j] = Partial()
        return tuple(pl)

    def wrapped(*args):
        local = [_to_local(a, mesh, s, grad_placements(s))
                 for a, s in zip(args, in_specs)]
        res = f(*local)
        res_t = res if multi else (res,)
        out = tuple(_from_local(r, mesh, s) for r, s in zip(res_t, outs))
        return out if multi else out[0]

    return wrapped


# ------------------------------------------------------------ collectives
def _group(mesh, axes):
    """The process group of one mesh axis (a tuple of several: the group
    of their flattened product, in mesh order)."""
    axes = spec_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    sub = mesh[tuple(axes)]
    return sub._flatten().get_group()


def axis_index(mesh, axes) -> int:
    """This rank's index along a mesh axis, or along several flattened in
    their order (the reference's ``axis_index``)."""
    idx = 0
    for a in spec_axes(axes):
        idx = idx * mesh.size(mesh_dim(mesh, a)) + mesh.get_local_rank(a)
    return idx


def axis_count(mesh, axes) -> int:
    return math.prod(mesh.size(mesh_dim(mesh, a)) for a in spec_axes(axes))


def _all_gather(x, group, n, dim):
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, n, dim):
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    """All-reduce to a value replicated over the axis: its cotangent is
    replicated too and passes through (the reference's psum transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x, mesh, axes, dim: int):
    """Tiled all-gather of ``x`` along ``dim`` over the axes (backward:
    reduce-scatter)."""
    return _AllGather.apply(x, _group(mesh, axes), axis_count(mesh, axes),
                            dim)


def psum_scatter(x, mesh, axes, dim: int):
    """Tiled reduce-scatter of ``x`` along ``dim`` (backward:
    all-gather)."""
    return _ReduceScatter.apply(x, _group(mesh, axes),
                                axis_count(mesh, axes), dim)


def psum(x, mesh, axes):
    """All-reduce (sum) over the axes; its cotangent passes through."""
    return _Psum.apply(x, _group(mesh, axes))


def pmax(x, mesh, axes):
    """All-reduce (max) over the axes; not differentiated (the reference
    uses it on stop-gradient statistics and in a custom VJP)."""
    return _all_reduce(x.detach(), _group(mesh, axes), dist.ReduceOp.MAX)


def all_to_all(x, mesh, axis):
    """``all_to_all(split_axis=0, concat_axis=0, tiled=False)``: block i of
    dim 0 goes to rank i, and block i of the result came from rank i."""
    return _AllToAll.apply(x, _group(mesh, axis))
