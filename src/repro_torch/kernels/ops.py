"""Public wrappers around the port's kernels (counterpart of
`repro/kernels/ops.py`)."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal=True):
    """(B, H, S, K) attention through the CUDA kernels (plain version for
    CPU tensors). Differentiable."""
    b, h, s, kd = q.shape
    fold = lambda t: t.reshape(b * h, t.shape[2], t.shape[3])
    out = _fa.flash_attention(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(b, h, s, kd)
