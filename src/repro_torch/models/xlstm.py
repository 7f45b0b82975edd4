"""xLSTM blocks (counterpart of `repro/models/xlstm.py`): the
chunkwise-parallel mLSTM (matrix memory) and the sequential sLSTM
(scalar memory with recurrent weights).

Training runs the mLSTM cell through the CUDA kernels
(`ops.mlstm_chunkwise`, forward and backward), where the reference calls
its own `jnp` chunkwise function. Decoding with a carried state is not
ported yet (ROADMAP Queue 1 item 10): a given state raises. The sLSTM
has no kernel: its recurrence is a Python loop over time, as the reference's
`lax.scan`, with the input projection x_t W for every step taken in one
product before the loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG


def _silu(x):
    """jax.nn.silu: x * sigmoid(x), each op rounded in x's dtype."""
    return x * torch.sigmoid(x)


def _normal(gen, shape, dtype, device):
    """normal * shape[0]^-0.5 in `dtype`, as the reference's `nrm`."""
    return (torch.randn(shape, generator=gen, device=device)
            * shape[0] ** -0.5).to(dtype)


# =============================================================== mLSTM
def init_mlstm(gen, cfg: ArchConfig, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Random init from `gen`; `w_i`, `b_i`, `w_f` and `b_f` stay f32
    whatever `dtype` is, as in the reference."""
    d, h = cfg.d_model, cfg.num_heads
    inner = 2 * d
    dh = inner // h
    nrm = lambda *s: _normal(gen, s, dtype, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": nrm(d, 2 * inner),          # (x_m, z) branches
        "conv_w": nrm(cfg.conv_width, inner) * 0.1,
        "conv_b": torch.zeros((inner,), dtype=dtype, device=device),
        "w_q": nrm(inner, h, dh),
        "w_k": nrm(inner, h, dh),
        "w_v": nrm(inner, h, dh),
        "w_i": torch.randn((inner, h), generator=gen, **f32) * 0.01,
        "b_i": torch.zeros((h,), **f32),
        "w_f": torch.randn((inner, h), generator=gen, **f32) * 0.01,
        "b_f": torch.full((h,), 3.0, **f32),   # open forget gates
        "skip": torch.ones((inner,), dtype=dtype, device=device),
        "ogate_ln": torch.ones((inner,), dtype=dtype, device=device),
        "w_down": nrm(inner, d),
    }


def _pad_chunks(chunk: int, q, k, v, log_i, log_f):
    """S (axis 2 of q, k, v; the last axis of the log gates) padded to a
    multiple of `chunk`: q, k, v and log_f by 0, log_i by -1e30, so the
    padding adds nothing to the state."""
    pad = (-q.shape[2]) % chunk
    if not pad:
        return q, k, v, log_i, log_f
    zp = lambda t: F.pad(t, (0, 0, 0, pad))
    return (zp(q), zp(k), zp(v), F.pad(log_i, (0, pad), value=NEG),
            F.pad(log_f, (0, pad)))


def _refuse_state(state) -> None:
    if state is not None:
        raise NotImplementedError("xLSTM decode with a carried state is "
                                  "not ported yet: ROADMAP Queue 1 item 10")


def _mlstm_cell(q, k, v, log_i, log_f, chunk: int):
    """The training path's cell from the zero state, through the kernels:
    q, k, v (B, H, S, K) f32, log gates (B, H, S), padded by
    _pad_chunks. Returns h (B, H, S, K)."""
    B, H, S, K = q.shape
    q, k, v, log_i, log_f = _pad_chunks(chunk, q, k, v, log_i, log_f)
    fold = lambda t: t.reshape(B * H, *t.shape[2:])
    h = ops.mlstm_chunkwise(fold(q), fold(k), fold(v), fold(log_i),
                            fold(log_f), chunk=chunk)
    return h.reshape(B, H, -1, K)[:, :, :S]


def _conv_silu(x, w, b):
    """Causal depthwise conv + SiLU from a zero context. x: (B, S, D), w:
    (W, D). The shifted products are summed in x's dtype, in order, from
    0, as the reference's Python `sum`."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return _silu(sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W)) + b)


def _groupnorm(x, groups: int, eps: float = 1e-6):
    B, S, D = x.shape
    xf = x.float().reshape(B, S, groups, D // groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, D).to(x.dtype)


def apply_mlstm(p: dict, x, cfg: ArchConfig, state: Optional[dict] = None,
                chunk: int = 64) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (B, S, D), training/prefill from the zero state;
    returns (y, None). A decode state raises (not ported yet)."""
    _refuse_state(state)
    B, S, D = x.shape
    H = cfg.num_heads
    up = x @ p["w_up"]
    inner = up.shape[-1] // 2
    xm, z = up[..., :inner], up[..., inner:]
    xc = _conv_silu(xm, p["conv_w"], p["conv_b"])
    xcf = xc.float()
    to_heads = lambda w: torch.einsum("bsi,ihk->bhsk", xcf, w.float())
    q, k, v = to_heads(p["w_q"]), to_heads(p["w_k"]), to_heads(p["w_v"])
    # the gate leaves are f32 at init and in the parameters' dtype after
    # an update; against f32 activations jnp promotes them to f32
    log_i = (xcf @ p["w_i"].float() + p["b_i"]).transpose(1, 2)   # (B,H,S)
    log_f = F.logsigmoid(xcf @ p["w_f"].float() + p["b_f"]).transpose(1, 2)
    h = _mlstm_cell(q, k, v, log_i, log_f, min(chunk, S))
    h = h.transpose(1, 2).reshape(B, S, inner).to(x.dtype)
    h = _groupnorm(h, H) * p["ogate_ln"] + xc * p["skip"]
    y = h * _silu(z.float()).to(x.dtype)
    return y @ p["w_down"], None


# =============================================================== sLSTM
def init_slstm(gen, cfg: ArchConfig, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Random init from `gen`; `w_zifo` (drawn in `dtype`, then widened),
    `r_zifo` and `b_zifo` are f32, as in the reference."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    nrm = lambda *s: _normal(gen, s, dtype, device)
    ff = max(2 * d // 2, d)
    b = torch.zeros((4, h, dh), dtype=torch.float32, device=device)
    b[2] = 3.0                                    # forget bias open
    return {
        # input projections for the 4 gates: z, i, f, o
        "w_zifo": nrm(d, 4, h, dh).float(),
        # per-head recurrent block-diagonal weights
        "r_zifo": torch.randn((4, h, dh, dh), generator=gen,
                              device=device) * dh ** -0.5 * 0.1,
        "b_zifo": b,
        "gn": torch.ones((d,), dtype=dtype, device=device),
        "w_ff1": nrm(d, ff), "w_ff2": nrm(d, ff), "w_ff3": nrm(ff, d),
    }


def _slstm_step(zin, carry):
    """One step from the gate pre-activations zin (H, B, 4, Dh) f32 and
    carry (h, c, n, m), each (H, B, Dh). The gates are taken with one
    unbind, whose backward stacks their gradients in one op."""
    h, c, n, m = carry
    z_t, i_t, f_t, o_t = zin.unbind(2)
    z_t = torch.tanh(z_t)
    f_t = F.logsigmoid(f_t)
    o_t = torch.sigmoid(o_t)
    fm = f_t + m
    m_new = torch.maximum(fm, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(fm - m_new)
    c_new = fp * c + ip * z_t
    n_new = fp * n + ip
    h_new = o_t * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def apply_slstm(p: dict, x, cfg: ArchConfig, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (B, S, D), training/prefill from the zero state;
    returns (y, None). A decode state raises (not ported yet).

    The carry is kept head-major, (H, B, Dh), so that each step's
    recurrent product is one batched matmul over heads fused with the
    add of the step's input projection (torch.baddbmm)."""
    _refuse_state(state)
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    z = torch.zeros((H, B, Dh), dtype=torch.float32, device=x.device)
    carry = (z, z, z, torch.full_like(z, NEG))
    xf = x.float()
    # x_t W + b for every step: (S, H, B, 4 * Dh). The gate leaves are
    # f32 at init and in the parameters' dtype after an update; against
    # the f32 carry jnp promotes them to f32.
    pre = torch.einsum("bsd,dghk->shbgk", xf, p["w_zifo"].float()) \
        + p["b_zifo"].float().permute(1, 0, 2)[None, :, None]
    pre = pre.reshape(S, H, B, 4 * Dh)
    # r[g, h, k, l] -> R[h, k, g * Dh + l]
    R = p["r_zifo"].float().permute(1, 2, 0, 3).reshape(H, Dh, 4 * Dh)
    hs = []
    for pre_t in pre.unbind(0):
        zin = torch.baddbmm(pre_t, carry[0], R).view(H, B, 4, Dh)
        carry = _slstm_step(zin, carry)
        hs.append(carry[0])
    h = torch.stack(hs, 0).permute(2, 0, 1, 3).reshape(B, S, D).to(x.dtype)
    h = _groupnorm(h, H) * p["gn"]
    # GeGLU feed-forward; jax.nn.gelu's default is the tanh approximation
    y = (F.gelu((h @ p["w_ff1"]).float(), approximate="tanh").to(x.dtype)
         * (h @ p["w_ff2"]))
    return y @ p["w_ff3"], None
