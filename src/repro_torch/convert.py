"""Parameter trees between numpy and the port.

`params_from_numpy` takes the JAX package's parameters as numpy arrays
(for example `jax.tree.map(np.asarray, backbone.init_params(...))`) and
returns the port's tree of tensors; `params_to_numpy` is the reverse.
Both keep the tree's shape and bytes, so a run of the port and a run of
the reference can start from the very same weights. Every leaf keeps
its own dtype (RecurrentGemma's f32 `lam`, `b_a` and `b_x` among bf16
weights), and empty subtrees (a `None` period position when there are
fewer layers than one period, an empty `tail`) pass through as they
are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, device, dtype=None):
    """numpy tree -> tensors on `device` (all cast to `dtype` if given,
    else each in its own dtype)."""
    return tree_map(lambda a: _to_tensor(a).to(device=device, dtype=dtype),
                    tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                     # numpy's bfloat16 type
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(tree):
    """tensor tree -> numpy tree with the same bytes."""
    return tree_map(_to_numpy, tree)
