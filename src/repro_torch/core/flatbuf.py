"""Flat-buffer gradient/state representation over torch tensors
(counterpart of `repro/core/flatbuf.py`).

  FlatSpec      - homogeneous-dtype view of a pytree as ONE 1-D tensor.
  SegmentedSpec - one contiguous 1-D bucket per dtype (segment order =
                  first appearance in leaf order); the engine's gradient
                  bucket layout and the master space of the flat Adam
                  state. `unflatten` returns views over the buckets, so
                  materialized parameters alias the flat storage.
  ByteSpec      - dtype-preserving byte packing of a pytree into one
                  host uint8 buffer (numpy), bit for bit; CUDA tensors
                  are copied to the host explicitly.

Specs are built from shape metadata (ShapeDtype leaves work), so a
joiner can unpack buffers for roles it never held. Leaf order is JAX's
(repro_torch.tree), so offsets and byte counts equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import TreeDef, tree_flatten


def _leaf_meta(tree) -> Tuple[TreeDef, Tuple, Tuple]:
    """(treedef, shapes, dtypes) for tensors OR ShapeDtype leaves."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    return treedef, shapes, dtypes


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _cat(parts, dtype, device=None) -> torch.Tensor:
    return torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype,
                                                      device=device)


@dataclass(frozen=True)
class FlatSpec:
    """One contiguous 1-D buffer of a common dtype for a pytree."""
    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    size: int                       # total elements
    dtype: Any

    @classmethod
    def from_tree(cls, tree) -> "FlatSpec":
        treedef, shapes, dtypes = _leaf_meta(tree)
        if len(set(dtypes)) > 1:
            raise TypeError(f"FlatSpec needs a homogeneous dtype, "
                            f"got {sorted(set(str(d) for d in dtypes))}")
        sizes = tuple(_numel(s) for s in shapes)
        offsets, off = [], 0
        for n in sizes:
            offsets.append(off)
            off += n
        return cls(treedef, shapes, sizes, tuple(offsets), off,
                   dtypes[0] if dtypes else torch.float32)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def flatten(self, tree) -> torch.Tensor:
        leaves = self.treedef.flatten_up_to(tree)
        return _cat([l.reshape(-1) for l in leaves], self.dtype)

    def unflatten(self, buf):
        leaves = [buf[o:o + n].view(s)
                  for o, n, s in zip(self.offsets, self.sizes, self.shapes)]
        return self.treedef.unflatten(leaves)

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros((self.size,), dtype=self.dtype, device=device)


@dataclass(frozen=True)
class Segment:
    """One contiguous same-dtype bucket inside a SegmentedSpec."""
    dtype: Any
    size: int                       # elements

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


@dataclass(frozen=True)
class SegmentedSpec:
    """Per-dtype segmented view of a pytree: one contiguous 1-D bucket
    per dtype. The master space is the segment-major concatenation of
    all segments; flat optimizer vectors live in it."""
    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    segments: Tuple[Segment, ...]
    leaf_seg: Tuple[int, ...]       # per-leaf segment index
    leaf_off: Tuple[int, ...]       # per-leaf offset within its segment
    leaf_sizes: Tuple[int, ...]
    size: int                       # total elements over all segments
    nbytes: int

    @classmethod
    def from_tree(cls, tree) -> "SegmentedSpec":
        treedef, shapes, dtypes = _leaf_meta(tree)
        sizes = tuple(_numel(s) for s in shapes)
        seg_of: dict = {}               # dtype -> segment index
        seg_sizes: list = []
        leaf_seg, leaf_off = [], []
        for dt, n in zip(dtypes, sizes):
            if dt not in seg_of:
                seg_of[dt] = len(seg_sizes)
                seg_sizes.append(0)
            si = seg_of[dt]
            leaf_seg.append(si)
            leaf_off.append(seg_sizes[si])
            seg_sizes[si] += n
        segments = tuple(Segment(dt, seg_sizes[si])
                         for dt, si in sorted(seg_of.items(),
                                              key=lambda kv: kv[1]))
        return cls(treedef, shapes, dtypes, segments, tuple(leaf_seg),
                   tuple(leaf_off), sizes, sum(seg_sizes),
                   sum(s.nbytes for s in segments))

    # ------------------------------------------------------------ layout
    def leaf_views(self) -> Tuple[Tuple[int, int, int, Tuple], ...]:
        """(segment_idx, offset, size, shape) per leaf, in leaf order."""
        return tuple(zip(self.leaf_seg, self.leaf_off, self.leaf_sizes,
                         self.shapes))

    def segment_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """(lo, hi) of each segment in the master space."""
        out, off = [], 0
        for s in self.segments:
            out.append((off, off + s.size))
            off += s.size
        return tuple(out)

    # ------------------------------------------------------- conversions
    def flatten(self, tree) -> Tuple[torch.Tensor, ...]:
        """Pytree -> per-dtype 1-D buckets (new tensors)."""
        leaves = self.treedef.flatten_up_to(tree)
        per_seg: list = [[] for _ in self.segments]
        for leaf, si in zip(leaves, self.leaf_seg):
            per_seg[si].append(leaf.reshape(-1))
        return tuple(_cat(c, seg.dtype)
                     for c, seg in zip(per_seg, self.segments))

    def unflatten(self, bufs):
        """Per-dtype buckets -> pytree of views over the buckets."""
        leaves = [bufs[si][o:o + n].view(sh)
                  for si, o, n, sh in self.leaf_views()]
        return self.treedef.unflatten(leaves)

    def unflatten_master(self, vec):
        """Master-space vector -> pytree of leaf-shaped views."""
        return self.unflatten([vec[lo:hi] for lo, hi in
                               self.segment_bounds()])

    def zeros(self, device=None) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.zeros((s.size,), dtype=s.dtype, device=device)
                     for s in self.segments)


def host_bytes(t) -> np.ndarray:
    """A tensor's exact bytes as a host uint8 array (CUDA tensors are
    copied to the host)."""
    t = torch.as_tensor(t).detach().contiguous().reshape(-1)
    return t.cpu().view(torch.uint8).numpy()


@dataclass(frozen=True)
class ByteSpec:
    """Dtype-preserving byte layout of a pytree in one uint8 buffer."""
    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    nbytes_leaf: Tuple[int, ...]
    offsets: Tuple[int, ...]
    nbytes: int

    @classmethod
    def from_tree(cls, tree) -> "ByteSpec":
        treedef, shapes, dtypes = _leaf_meta(tree)
        nb = tuple(_numel(s) * d.itemsize for s, d in zip(shapes, dtypes))
        offsets, off = [], 0
        for n in nb:
            offsets.append(off)
            off += n
        return cls(treedef, shapes, dtypes, nb, tuple(offsets), off)

    def pack(self, tree) -> np.ndarray:
        """Pytree -> one contiguous host uint8 buffer (exact bytes)."""
        leaves = self.treedef.flatten_up_to(tree)
        buf = np.empty((self.nbytes,), np.uint8)
        for leaf, off, nb, dt in zip(leaves, self.offsets,
                                     self.nbytes_leaf, self.dtypes):
            if leaf.dtype != dt:    # a cast would silently round values
                raise TypeError(f"leaf dtype {leaf.dtype} != spec dtype "
                                f"{dt}; bit-for-bit packing impossible")
            buf[off:off + nb] = host_bytes(leaf)
        return buf

    def unpack(self, buf: np.ndarray):
        """uint8 buffer -> pytree of host tensors (exact bytes)."""
        if buf.nbytes != self.nbytes:
            raise ValueError(f"buffer holds {buf.nbytes} bytes, spec "
                             f"{self.nbytes}")
        leaves = []
        for off, nb, dt, sh in zip(self.offsets, self.nbytes_leaf,
                                   self.dtypes, self.shapes):
            raw = torch.from_numpy(np.array(buf[off:off + nb]))
            leaves.append(raw.view(dt).reshape(sh))
        return self.treedef.unflatten(leaves)
