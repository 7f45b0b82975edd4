"""Checkpoints (counterpart of `repro/train/checkpoint.py`): to disk
("remote storage", `save`/`load`) and in memory (neighbour copies).

State held here lives in host memory: CUDA tensors are copied to the
host explicitly when they are saved or put.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def to_host(tree):
    """Host copies of every tensor leaf (other leaves pass through)."""
    return tree_map(lambda l: l.detach().to("cpu", copy=True)
                    if isinstance(l, torch.Tensor) else l, tree)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def tree_bytes(tree) -> int:
    return sum(_nbytes(l) for l in tree_leaves(tree))


def save(path: str, tree, step: int) -> int:
    """Write a checkpoint of `tree` (tensors go to the host first) at
    `step`, atomically (a temporary file renamed into place); returns
    the bytes of its leaves."""
    leaves, treedef = tree_flatten(to_host(tree))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": step, "treedef": treedef, "leaves": leaves}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
    return sum(_nbytes(l) for l in leaves)


def load(path: str) -> Tuple[Any, int]:
    """(tree with host tensors, step) as `save` wrote them."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload["treedef"].unflatten(payload["leaves"]), payload["step"]


class InMemoryCheckpoint:
    """Per-iteration host-memory checkpoint with neighbour redundancy:
    each logical node keeps its own latest state plus a copy of its ring
    neighbour's."""

    def __init__(self):
        self._own: Dict[int, Tuple[int, Any]] = {}
        # owner -> (holder_node, step, state)
        self._replica: Dict[int, Tuple[int, int, Any]] = {}

    def put(self, node: int, step: int, state, ring: list) -> None:
        host = to_host(state)
        self._own[node] = (step, host)
        if len(ring) > 1:
            holder = ring[(ring.index(node) + 1) % len(ring)]
            self._replica[node] = (holder, step, host)

    def get(self, node: int):
        """Recover `node`'s state: own copy, else surviving replica."""
        if node in self._own:
            return self._own[node]
        if node in self._replica:
            holder, step, state = self._replica[node]
            if holder in self._own or any(
                    h == holder for h, _, _ in self._replica.values()):
                return (step, state)
        return None

    def drop_node(self, node: int) -> None:
        """Node loss: its host memory (own copy + any replicas it holds
        for peers) disappears."""
        self._own.pop(node, None)
        for owner in [o for o, (h, _, _) in self._replica.items()
                      if h == node]:
            self._replica.pop(owner)

    def bytes_for(self, node: int) -> int:
        hit = self.get(node)
        return 0 if hit is None else tree_bytes(hit[1])
