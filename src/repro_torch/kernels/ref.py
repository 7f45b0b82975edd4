"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch


def attention(q, k, v, causal=True, scale=None):
    """q,k,v: (BH, S, d); softmax(q k^T * scale + causal mask) v in f32,
    cast to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bsk,btk->bst", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    return torch.einsum("bst,btk->bsk", p, v.float()).to(q.dtype)


def grouped_matmul(x, w):
    """x: (E, C, D), w: (E, D, F) -> (E, C, F): per-expert products in
    f32, cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rglru_scan(a, x):
    """h_t = a_t h_{t-1} + x_t along axis 1 of (B, S, D), h_{-1} = 0: a
    sequential loop with an f32 carry, each h_t cast to x's dtype."""
    h = torch.zeros_like(x[:, 0], dtype=torch.float32)
    out = []
    for t in range(x.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        out.append(h.to(x.dtype))
    return torch.stack(out, 1)
