"""Public wrappers around the port's kernels (counterpart of
`repro/kernels/ops.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm


def flash_attention(q, k, v, *, causal=True):
    """(B, H, S, K) attention through the CUDA kernels (plain version for
    CPU tensors). Differentiable."""
    b, h, s, kd = q.shape
    fold = lambda t: t.reshape(b * h, t.shape[2], t.shape[3])
    out = _fa.flash_attention(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(b, h, s, kd)


def grouped_matmul(x, w):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) through the CUDA kernels
    (plain version for CPU tensors). Mixed f32/bf16 operands are
    promoted to their common dtype first, as jnp.einsum promotes them.
    Differentiable."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return _gmm.grouped_matmul(x.to(dt), w.to(dt))
