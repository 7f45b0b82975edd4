"""RG-LRU recurrent block (Griffin / RecurrentGemma), the counterpart of
`repro/models/rglru.py`.

Temporal mixing:   conv1d(width w) -> RG-LRU gated linear recurrence
  r_t = sigmoid(x_t W_a + b_a)            recurrence gate
  i_t = sigmoid(x_t W_x + b_x)            input gate
  log a_t = -c * softplus(Lambda) * r_t   (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Training runs the recurrence through the CUDA scan kernels
(`ops.rglru_scan`, forward and backward), where the reference takes
`jax.lax.associative_scan`; decode is the O(1) single-step update.

Under a mesh the recurrence width Dr is split over `model`
(`rglru_axes`): each rank runs the conv and the scan kernels on its
Dr/tp lanes, gathers every rank's conv output for the gate products
(whose weights keep all Dr input rows and the rank's output columns),
and the partial sums after `w_out` are added up over `model`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.shardings import from_model, gather_model, to_model

_C = 8.0


def init_rglru(gen, cfg: ArchConfig, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Random init from `gen`; `lam`, `b_a` and `b_x` stay f32 whatever
    `dtype` is, as in the reference."""
    d = cfg.d_model
    dr = cfg.rnn_state_dim or cfg.d_model
    w = cfg.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    nrm = lambda *s: (torch.randn(s, generator=gen, device=device)
                      * s[0] ** -0.5).to(dtype)
    # Lambda init so a^c in [0.9, 0.999] (Griffin appendix)
    u = torch.rand((dr,), generator=gen, **f32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))      # softplus^-1
    return {
        "w_in_x": nrm(d, dr),       # recurrence branch input
        "w_in_g": nrm(d, dr),       # multiplicative gate branch
        "conv_w": nrm(w, dr) * 0.1,
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "w_a": nrm(dr, dr) * 0.1,
        "b_a": torch.zeros((dr,), **f32),
        "w_x": nrm(dr, dr) * 0.1,
        "b_x": torch.zeros((dr,), **f32),
        "lam": lam,
        "w_out": nrm(dr, d),
    }


def rglru_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_rglru's structure."""
    return {
        "w_in_x": (None, "d_ff"), "w_in_g": (None, "d_ff"),
        "conv_w": (None, "d_ff"), "conv_b": ("d_ff",),
        "w_a": (None, "d_ff"), "b_a": ("d_ff",),
        "w_x": (None, "d_ff"), "b_x": ("d_ff",),
        "lam": ("d_ff",),
        "w_out": ("d_ff", None),
    }


def _conv1d(x, w, b, state: Optional[torch.Tensor]):
    """Causal depthwise conv. x: (B,S,Dr), w: (W,Dr).
    state: (B, W-1, Dr) trailing context (decode) or None (train)."""
    W = w.shape[0]
    if state is None:
        ctx = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        ctx = state.to(x.dtype)
    xp = torch.cat([ctx, x], 1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else ctx
    return out + b, new_state


def _gates(p, xr, mesh=None):
    """Gate computations in f32. xr: (B,S,Dr), the rank's lanes under a
    mesh, whose gate products read every rank's. Returns (a, gated)."""
    xf = xr.float()
    xa = gather_model(xf, mesh)
    r = torch.sigmoid(xa @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xa @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r             # (B,S,Dr) <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(a, x, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + x_t along axis 1, through the scan kernels;
    h0 (B, Dr) is the state before the first step."""
    if h0 is not None:
        x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], 1)
    return ops.rglru_scan(a, x)


def apply_rglru(p: dict, x, cfg: ArchConfig, state: Optional[dict] = None,
                mesh=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,D) -> (B,S,D). state (decode): {"h": (B,Dr), "conv": ...}.
    Under `mesh`, p holds the rank's blocks (training only)."""
    x = to_model(x, mesh)
    xr = x @ p["w_in_x"]
    gate = x @ p["w_in_g"]
    conv_state = None if state is None else state["conv"]
    xr, new_conv = _conv1d(xr, p["conv_w"], p["conv_b"], conv_state)
    a, gated = _gates(p, xr, mesh)
    if state is None:
        h = rglru_scan(a, gated)
        new_state = None
    else:
        h = a * state["h"][:, None] + gated              # S == 1
        new_state = {"h": h[:, -1], "conv": new_conv}
    # jax.nn.gelu's default is the tanh approximation
    y = (F.gelu(gate.float(), approximate="tanh") * h).to(x.dtype)
    return from_model(y @ p["w_out"], mesh), new_state


def init_rglru_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    dr = cfg.rnn_state_dim or cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                            device=device),
    }
