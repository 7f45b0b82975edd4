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
