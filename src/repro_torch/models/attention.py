"""Attention primitives (counterpart of `repro/models/attention.py`):
RoPE, the position mask, the plain dense attention, and `attend`,
which sends full-sequence attention through the CUDA kernels.

Layout conventions
  q:    (B, S, NKV, G, K)   NKV = physical kv heads, G = q-per-kv
  k/v:  (B, T, NKV, K), v's last axis Kv where it differs (MLA)
All attention math runs in f32 and casts back to the input dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30
PAD_SENTINEL = 2 ** 29


def rope(x, positions, theta: float):
    """Rotary embedding. x: (B, S, ..., K); positions: (B, S) int."""
    k = x.shape[-1]
    half = k // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                  # (B,S,half)
    extra = x.dim() - 3
    ang = ang.reshape(ang.shape[:2] + (1,) * extra + (half,))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(..., S, T) additive bias from positions (entries 0 or NEG_INF).
    k positions >= PAD_SENTINEL are always masked."""
    ok = (k_pos < PAD_SENTINEL)[..., None, :]
    ok = ok.expand(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]))
    d = q_pos[..., :, None] - k_pos[..., None, :]
    if causal:
        ok = ok & (d >= 0)
    if window:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def dense_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                    scale=None):
    """Plain reference. q:(B,S,N,G,K) k,v:(B,T,N,K)."""
    K = q.shape[-1]
    scale = scale or K ** -0.5
    qf = q.float() * scale
    logits = torch.einsum("bsngk,btnk->bngst", qf, k.float())
    bias = _mask_bias(q_pos, k_pos, causal, window)             # (B,S,T)
    p = torch.softmax(logits + bias[:, None, None], dim=-1)
    out = torch.einsum("bngst,btnk->bsngk", p, v.float())
    return out.to(q.dtype)


def attend(q, k, v, q_pos, k_pos, *, causal=True, window=0,
           impl="chunked", scale=None):
    """Full-sequence attention through `ops.flash_attention`, whatever
    `impl` names: the kernel is the port's only attention path, the
    sliding window (`window` > 0, `local_attn`) included.

    q and k share the q.k width K; v may have its own width Kv (MLA's
    128 against K = 192), which the output takes. q_pos and k_pos must
    be 0..S-1 in every row (the training and prefill positions); the
    kernel masks by index. q and kv of different lengths (KV caches,
    decode) and a scale other than K^-0.5 (MLA's explicit scale is
    that one) are not ported yet."""
    B, S, N, G, K = q.shape
    T, Kv = k.shape[1], v.shape[-1]
    if S != T or scale not in (None, K ** -0.5):
        raise NotImplementedError(
            "attend supports full-sequence attention at the default "
            "scale only")
    if impl not in ("dense", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, N * G, S, K)
    grp = lambda t: t.permute(0, 2, 1, 3)[:, :, None] \
        .expand(B, N, G, T, t.shape[-1]).reshape(B, N * G, T, t.shape[-1])
    out = ops.flash_attention(qh, grp(k), grp(v), causal=causal,
                              window=window)
    return out.reshape(B, N, G, S, Kv).permute(0, 3, 1, 2, 4)
