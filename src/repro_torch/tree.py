"""Minimal pytrees with JAX's leaf order.

Containers are dicts (flattened in sorted key order, as `jax.tree`
does), tuples and lists; `None` is an empty subtree; everything else is
a leaf. Keeping JAX's order is what makes the port's flat-buffer
offsets, byte layouts and per-leaf collective tags equal the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch


@dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a tensor that is not materialized (the
    counterpart of `jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class TreeDef:
    kind: str                       # leaf | none | dict | tuple | list
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("too many leaves for this treedef")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return tuple(kids) if self.kind == "tuple" else kids

    def flatten_up_to(self, tree) -> List[Any]:
        out: List[Any] = []
        self._up_to(tree, out)
        return out

    def _up_to(self, tree, out) -> None:
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "none":
            if tree is not None:
                raise ValueError(f"expected None, got {type(tree)}")
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or sorted(tree) != list(self.keys):
                raise ValueError(f"dict keys differ: {self.keys}")
            kids = [tree[k] for k in self.keys]
        else:
            if not isinstance(tree, (tuple, list)) or \
                    len(tree) != len(self.children):
                raise ValueError(f"expected a {self.kind} of "
                                 f"{len(self.children)}")
            kids = list(tree)
        for c, t in zip(self.children, kids):
            c._up_to(t, out)


_END = object()
_LEAF = TreeDef("leaf")
_NONE = TreeDef("none")


def _flatten(tree, leaves: list) -> TreeDef:
    if tree is None:
        return _NONE
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys,
                       tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return TreeDef(kind, (), tuple(_flatten(c, leaves) for c in tree))
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, td = tree_flatten(tree)
    others = [td.flatten_up_to(t) for t in rest]
    return td.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def shape_dtype(tree):
    """Tree of ShapeDtype for a tree of tensors."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), tree)
