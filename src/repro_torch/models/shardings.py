"""Logical-axis -> mesh-axis resolution (counterpart of
`repro/models/shardings.py`), and what the port does with it: each rank
holds its own block of a split tensor, and the collectives below join
the blocks where the model needs them.

Models name tensor dimensions with *logical* axes; the rules map them
onto whatever mesh is active ((data, model), or (pod, data, model) with
the pod folded into data parallelism). `resolve` gives the reference's
per-dimension entries: a mesh-axis name, a tuple of names (split over
their product, the first the major one), or None (replicated). A mesh
is a `torch.distributed.device_mesh.DeviceMesh` (`launch/mesh.py`); the
pure functions read only its `mesh_dim_names` and `shape`.

A split tensor is never a DTensor in the model: every rank computes on
its local block, and the model places the collectives itself
(`to_model`, `from_model`, `gather_model`), so no op can fall back to a
silent redistribution. `placements` turns an entry tuple into the
DTensor placements of the same layout; `whole` joins the blocks through
them (a checkpoint's gather), so DTensor's reading of a layout is
checked against the port's on every gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# logical name -> tuple of mesh axis names it wants (first match wins on
# presence in the mesh).
RULES = {
    "batch":   ("pod", "data"),   # data parallel (pod folds into DP)
    "seq_sp":  ("model",),        # sequence-parallel residual stream
    "seq":     (),                # unsharded sequence
    "heads":   ("model",),        # tensor parallel attention heads
    "kv_heads": ("model",),
    "d_ff":    ("model",),        # tensor parallel MLP hidden
    "vocab":   ("model",),        # tensor parallel embedding/logits
    "experts": ("model",),        # expert parallel
    "d_model": (),                # replicated model dim
    "fsdp":    ("data",),         # ZeRO param/optimizer sharding axis
    "null":    (),
}

SCALAR = ("@scalar",)     # sharding-axes marker for 0-dim leaves
DP_AXES = ("pod", "data")


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _extents(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve(logical: Sequence[Optional[str]], mesh) -> tuple:
    """Map a tuple of logical axis names to per-dimension entries for
    `mesh` (the reference's PartitionSpec, as a tuple)."""
    if tuple(logical) == SCALAR:
        return ()
    present = set(mesh_axes(mesh))
    spec, used = [], set()
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        want = [a for a in RULES[name] if a in present and a not in used]
        if not want:
            spec.append(None)
        elif len(want) == 1:
            used.add(want[0])
            spec.append(want[0])
        else:
            used.update(want)
            spec.append(tuple(want))
    return tuple(spec)


def axis_size(mesh, logical_name: str) -> int:
    """Product of mesh axis sizes a logical axis maps to (1 w/o mesh)."""
    if mesh is None:
        return 1
    present = _extents(mesh)
    n = 1
    for a in RULES[logical_name]:
        n *= present.get(a, 1)
    return n


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry (None, a name, or a tuple of names)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block(mesh, axes) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dimension split over
    `axes`: its coordinates on them, the first the major one."""
    ext = _extents(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for a in axes:
        index, count = index * ext[a] + coord[a], count * ext[a]
    return index, count


def axis_index(mesh, logical_name: str) -> int:
    """This rank's block index along a logical axis (0 w/o mesh)."""
    if mesh is None:
        return 0
    present = set(mesh_axes(mesh))
    return _block(mesh, [a for a in RULES[logical_name] if a in present])[0]


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of `shape` split as
    `spec` says; raises if a split dimension does not divide."""
    ext = _extents(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        n = math.prod(ext[a] for a in entry_axes(e))
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {entry_axes(e)} ({n})")
        out[i] //= n
    return tuple(out)


def local_block(x, spec, mesh):
    """This rank's block of `x`, a tensor every rank holds whole, split
    as `spec` says (x itself where nothing splits); raises if a split
    dimension does not divide."""
    for i, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            index, count = _block(mesh, axes)
            if x.shape[i] % count:
                raise ValueError(f"dimension {i} of {tuple(x.shape)} does "
                                 f"not split over {axes} ({count})")
            if count > 1:
                n = x.shape[i] // count
                x = x.narrow(i, index * n, n)
    return x


def shard(x, logical: Sequence[Optional[str]], mesh=None):
    """This rank's block of a tensor that every rank holds whole, split
    as the logical names say; a no-op without a mesh or on a one-device
    mesh, as the reference's `with_sharding_constraint` is."""
    if mesh is None or math.prod(mesh.shape) == 1:
        return x
    return local_block(x, resolve(logical, mesh), mesh)


def placements(spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`, one per mesh dimension:
    Shard(i) where tensor dimension i is split over that axis, else
    Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {a: i for i, e in enumerate(spec) for a in entry_axes(e)}
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in mesh_axes(mesh)]


def whole(local, spec, mesh):
    """The whole tensor from every rank's block, split as `spec` says (a
    collective: every rank calls it and gets the whole tensor):
    DTensor's full_tensor of `placements(spec, mesh)`."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False).full_tensor()


@dataclass(frozen=True)
class NamedSharding:
    """A split of a tensor over a mesh: `spec` holds one entry per
    dimension (a tree leaf, where a bare tuple would be a container)."""
    mesh: Any
    spec: tuple

    def local_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)

    def local(self, x):
        return local_block(x, self.spec, self.mesh)

    def whole(self, local):
        return whole(local, self.spec, self.mesh)

    def copies(self) -> int:
        """How many ranks hold each element: the ranks over the product
        of the split axes' extents."""
        ext = _extents(self.mesh)
        return math.prod(ext.values()) // math.prod(
            ext[a] for e in self.spec for a in entry_axes(e))


# ------------------------------------------------------------ collectives
def group(mesh, axes):
    """The process group over the mesh axes `axes` that the mesh has, in
    rank order with the first the major one (None for none)."""
    axes = tuple(a for a in axes if a in mesh_axes(mesh))
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _model_group(mesh):
    return None if mesh is None else group(mesh, RULES["heads"])


def _all_reduce(x, grp):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=grp)
    return x


def gather_dim(x, dim: int, grp):
    """All-gather of every rank's block of `x` along `dim`, in rank
    order."""
    n = dist.get_world_size(grp)
    parts = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    dist.all_gather_into_tensor(parts.view(-1), x.contiguous().view(-1),
                                group=grp)
    shape = list(x.shape)
    shape[dim] *= n
    return parts.movedim(0, dim).reshape(shape)


def reduce_scatter_dim(x, dim: int, grp):
    """Sum of `x` over the group, each rank keeping its block of `dim`."""
    n = dist.get_world_size(grp)
    shape = list(x.shape)
    shape[dim] //= n
    parts = x.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), parts.contiguous().view(-1),
                               group=grp)
    return out


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over `model` (a replicated
    input to rank-specific products)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grp), None


class _FromModel(torch.autograd.Function):
    """Sum over `model` forward (partial sums to a replicated result);
    identity backward."""

    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather along `dim` forward (every rank's lanes, for a
    rank-specific product); the gradient reduce-scattered back."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        ctx.dim, ctx.grp = dim, grp
        return gather_dim(x, dim, grp)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.grp), None, None


class _SplitModel(torch.autograd.Function):
    """This rank's block along `dim` of a tensor every `model` rank holds
    whole forward; the blocks of the gradient all-gathered backward."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        ctx.dim, ctx.grp = dim, grp
        n = x.shape[dim] // dist.get_world_size(grp)
        return x.narrow(dim, dist.get_rank(grp) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.grp), None, None


def to_model(x, mesh):
    """Enter a tensor-parallel region: x as it is, its gradient summed
    over the mesh's `model` axis (no-op without one)."""
    grp = _model_group(mesh)
    return x if grp is None else _ToModel.apply(x, grp)


def from_model(x, mesh):
    """Leave a tensor-parallel region: the partial sums of every `model`
    rank added up (no-op without a `model` axis)."""
    grp = _model_group(mesh)
    return x if grp is None else _FromModel.apply(x, grp)


def gather_model(x, mesh, dim: int = -1):
    """Every `model` rank's block of x along `dim`, joined (no-op without
    a `model` axis)."""
    grp = _model_group(mesh)
    return x if grp is None else _GatherModel.apply(x, dim % x.dim(), grp)


def split_model(x, mesh, dim: int = -1):
    """This `model` rank's block along `dim` of x, which every rank holds
    whole (after `from_model`): the inverse of `gather_model`, its
    gradient gathered from every rank's block (no-op without a `model`
    axis; raises where the extent does not divide the dimension)."""
    grp = _model_group(mesh)
    if grp is None:
        return x
    if x.shape[dim] % dist.get_world_size(grp):
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {dist.get_world_size(grp)} model "
                         f"ranks")
    return _SplitModel.apply(x, dim % x.dim(), grp)


def max_over_model(x, mesh):
    """Elementwise maximum over the `model` ranks, without a gradient."""
    grp = _model_group(mesh)
    x = x.detach()
    if grp is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=grp)
    return x


def sum_over_batch(x, mesh):
    """Sum over the data-parallel ranks (`pod` and `data`), without a
    gradient (no-op without a mesh)."""
    x = x.detach()
    grp = None if mesh is None else group(mesh, DP_AXES)
    if grp is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=grp)
    return x


# -------------------------------------------------------------- axes trees
def axes_leaf(x) -> bool:
    """A leaf of an axes tree: a non-empty tuple of names and Nones (an
    empty tuple is an empty container, e.g. an empty tail)."""
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, axes, *trees):
    """fn(leaf, *subtrees) at every leaf of an axes tree, walking `trees`
    (which share its structure) alongside; None stays None."""
    if axes is None:
        return None
    if axes_leaf(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_axes(fn, a, *(t[k] for t in trees))
                for k, a in axes.items()}
    return tuple(map_axes(fn, a, *(t[i] for t in trees))
                 for i, a in enumerate(axes))


def shard_tree(tree, axes, mesh):
    """This rank's blocks of a tree of whole tensors, each an own copy
    (so the whole tensor can be freed), as `axes` names their
    dimensions."""
    def one(ax, x):
        y = shard(x, ax, mesh)
        return y if y is x else y.clone()
    return map_axes(one, axes, tree)
