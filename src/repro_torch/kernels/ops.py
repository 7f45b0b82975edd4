"""Public wrappers around the port's kernels (counterpart of
`repro/kernels/ops.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _ml
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rglru_scan as _rg


def flash_attention(q, k, v, *, causal=True, window=0):
    """(B, H, S, K) attention through the CUDA kernels (plain version for
    CPU tensors); window > 0 limits each query to the `window` latest
    keys. Differentiable."""
    b, h, s, kd = q.shape
    fold = lambda t: t.reshape(b * h, t.shape[2], t.shape[3])
    out = _fa.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                              window=window)
    return out.reshape(b, h, s, kd)


def grouped_matmul(x, w):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) through the CUDA kernels
    (plain version for CPU tensors). Mixed f32/bf16 operands are
    promoted to their common dtype first, as jnp.einsum promotes them.
    Differentiable."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return _gmm.grouped_matmul(x.to(dt), w.to(dt))


def rglru_scan(a, x):
    """h_t = a_t h_{t-1} + x_t along axis 1 of (B, S, D) through the CUDA
    kernels (plain version for CPU tensors), with an f32 carry and h in
    x's dtype. Differentiable."""
    return _rg.rglru_scan(a, x)


def mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk=64):
    """Chunkwise stabilized mLSTM from the zero state through the CUDA
    kernels (plain version for CPU tensors): q, k, v (BH, S, K), log_i,
    log_f (BH, S) -> h (BH, S, K) in q's dtype, with chunk = min(chunk,
    S) dividing S, as the reference asserts. Differentiable."""
    return _ml.mlstm_chunkwise(q, k, v, log_i, log_f, min(chunk, q.shape[1]))
