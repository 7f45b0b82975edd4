"""xLSTM blocks (counterpart of `repro/models/xlstm.py`): the
chunkwise-parallel mLSTM (matrix memory) and the sequential sLSTM
(scalar memory with recurrent weights).

Training runs the mLSTM cell through the CUDA kernels
(`ops.mlstm_chunkwise`, forward and backward), where the reference calls
its own `jnp` chunkwise function. Decoding with a carried state (C, n,
m and the conv's context) runs the reference's chunkwise function,
plain (`mlstm_chunkwise`), from that state. The sLSTM has no kernel:
its recurrence is a Python loop over time, as the reference's
`lax.scan`, with the input projection x_t W for every step taken in one
product before the loop, from the zero state or a carried one.

Under a mesh the weights keep the reference's layout (`mlstm_axes`,
`slstm_axes`): a `model` rank holds a block of the mLSTM's `inner`
lanes of every weight, and for the sLSTM its `d_ff` block of the GeGLU
feed-forward. `w_up`'s columns are the concatenation [x_m | z], so a
rank's block of them is not its lanes of both branches: the up
projection is gathered over `model` and each rank takes its lanes of
each half. The q, k, v and gate products contract over the lanes, so
their partial sums are added over `model` (the gate biases after the
sum) and each rank keeps its heads: a rank runs the cell on its heads,
whose lanes are its block, which needs the head count to split over
`model`. The sLSTM's recurrence runs whole on every rank.

Decoding under a mesh carries the mLSTM's state in the layout its cell
runs: C, n and m the rank's heads and the conv's context its lanes (the
reference splits C's and n's value lanes); the sLSTM's state is whole
on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG, mlstm_chunks
from repro_torch.models.shardings import (axis_index, axis_size,
                                          from_model, gather_model,
                                          local_extent, split_model,
                                          to_model)


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


def mlstm_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_mlstm's structure."""
    return {
        "w_up": (None, "d_ff"), "conv_w": (None, "d_ff"),
        "conv_b": ("d_ff",),
        "w_q": ("d_ff", None, None), "w_k": ("d_ff", None, None),
        "w_v": ("d_ff", None, None),
        "w_i": ("d_ff", None), "b_i": (None,),
        "w_f": ("d_ff", None), "b_f": (None,),
        "skip": ("d_ff",), "ogate_ln": ("d_ff",),
        "w_down": ("d_ff", None),
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


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk: int = 64):
    """The reference's model-level chunkwise mLSTM, plain: q, k, v (B, H,
    S, K) f32, log gates (B, H, S), state (C (B, H, K, K), n (B, H, K),
    m (B, H)) or None for the zero state; S padded up to a multiple of
    `chunk`. Returns h (B, H, S, K) f32 and the state after step S. The
    decode path's cell (the training path's is `_mlstm_cell`)."""
    B, H, S, K = q.shape
    q, k, v, log_i, log_f = _pad_chunks(chunk, q, k, v, log_i, log_f)
    fold = lambda t: t.reshape(B * H, *t.shape[2:])
    if state is not None:
        state = tuple(fold(t) for t in state)
    h, _, state = mlstm_chunks(fold(q), fold(k), fold(v), fold(log_i),
                               fold(log_f), chunk, state)
    unfold = lambda t: t.reshape(B, H, *t.shape[1:])
    return unfold(h)[:, :, :S], tuple(unfold(t) for t in state)


def _conv_silu(x, w, b, state=None):
    """Causal depthwise conv + SiLU. x: (B, S, D), w: (W, D); state (B,
    W - 1, D) is the context before x (decode), or None for zeros. The
    shifted products are summed in x's dtype, in order, from 0, as the
    reference's Python `sum`. Returns (out, the last W - 1 inputs)."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return _silu(out + b), xp[:, -(W - 1):]


def _groupnorm(x, groups: int, eps: float = 1e-6):
    B, S, D = x.shape
    xf = x.float().reshape(B, S, groups, D // groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, D).to(x.dtype)


def init_mlstm_state(cfg: ArchConfig, batch: int, device="cpu",
                     mesh=None) -> dict:
    """The zero state; under `mesh` the rank's heads of C, n and m and its
    lanes of the conv's context."""
    dh = 2 * cfg.d_model // cfg.num_heads
    H = local_extent(cfg.num_heads, "heads", mesh)
    inner = local_extent(2 * cfg.d_model, "d_ff", mesh)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, inner), **f32)}


def apply_mlstm(p: dict, x, cfg: ArchConfig, state: Optional[dict] = None,
                chunk: int = 64, mesh=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (y (B, S, D), new state). With state None
    (training, prefill) the cell runs the kernels from the zero state
    and the new state is None; with a decode state {"C", "n", "m",
    "conv"} it runs `mlstm_chunkwise` from it and returns the next.
    Under `mesh`, p holds the rank's lanes, the cell runs the rank's
    heads and the state holds them (see the module's docstring)."""
    B, S, D = x.shape
    tp = axis_size(mesh, "d_ff")
    H = cfg.num_heads // tp
    # the whole [x_m | z] on every rank, the rank's lanes of each half
    up = gather_model(to_model(x, mesh) @ p["w_up"], mesh)
    inner = up.shape[-1] // 2
    width = inner // tp
    lo = axis_index(mesh, "d_ff") * width
    xm, z = up[..., lo:lo + width], up[..., inner + lo:inner + lo + width]
    xc, new_conv = _conv_silu(xm, p["conv_w"], p["conv_b"],
                              None if state is None else state["conv"])
    xcf = xc.float()
    # each product is over the rank's lanes: summed over `model`, then
    # the rank's heads kept
    to_heads = lambda w: split_model(from_model(torch.einsum(
        "bsi,ihk->bhsk", xcf, w.float()), mesh), mesh, 1)
    q, k, v = to_heads(p["w_q"]), to_heads(p["w_k"]), to_heads(p["w_v"])
    # the gate leaves are f32 at init and in the parameters' dtype after
    # an update; against f32 activations jnp promotes them to f32. The
    # bias is added once, after the sum
    gate = lambda w, b: split_model(from_model(xcf @ w.float(), mesh) + b,
                                    mesh, -1).transpose(1, 2)   # (B,H,S)
    log_i = gate(p["w_i"], p["b_i"])
    log_f = F.logsigmoid(gate(p["w_f"], p["b_f"]))
    new_state = None
    if state is None:
        h = _mlstm_cell(q, k, v, log_i, log_f, min(chunk, S))
    else:
        h, (C, n, m) = mlstm_chunkwise(
            q, k, v, log_i, log_f, (state["C"], state["n"], state["m"]),
            chunk=min(chunk, S))
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    h = h.transpose(1, 2).reshape(B, S, width).to(x.dtype)
    h = _groupnorm(h, H) * p["ogate_ln"] + xc * p["skip"]
    y = h * _silu(z.float()).to(x.dtype)
    return from_model(y @ p["w_down"], mesh), new_state


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


SLSTM_STATE = ("h", "c", "n", "m")


def slstm_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_slstm's structure."""
    return {
        "w_zifo": (None, None, None, None),
        "r_zifo": (None, None, None, None),
        "b_zifo": (None, None, None),
        "gn": (None,),
        "w_ff1": (None, "d_ff"), "w_ff2": (None, "d_ff"),
        "w_ff3": ("d_ff", None),
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


def apply_slstm(p: dict, x, cfg: ArchConfig, state: Optional[dict] = None,
                mesh=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (y (B, S, D), new state): from the zero state
    with state None (training, prefill; the new state is None), else
    from the decode state {"h", "c", "n", "m"}, each (B, H, Dh) f32,
    returning the state after step S. Under `mesh` the recurrence runs
    whole (the state whole on every rank) and the feed-forward on the
    rank's `d_ff` block.

    The carry is kept head-major, (H, B, Dh), so that each step's
    recurrent product is one batched matmul over heads fused with the
    add of the step's input projection (torch.baddbmm)."""
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    if state is None:
        z = torch.zeros((H, B, Dh), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full_like(z, NEG))
    else:
        carry = tuple(state[k].float().transpose(0, 1) for k in SLSTM_STATE)
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
    h = to_model(_groupnorm(h, H) * p["gn"], mesh)
    # GeGLU feed-forward; jax.nn.gelu's default is the tanh approximation
    y = (F.gelu((h @ p["w_ff1"]).float(), approximate="tanh").to(x.dtype)
         * (h @ p["w_ff2"]))
    new_state = None
    if state is not None:
        new_state = {k: t.transpose(0, 1) for k, t in zip(SLSTM_STATE,
                                                          carry)}
    return from_model(y @ p["w_ff3"], mesh), new_state


def init_slstm_state(cfg: ArchConfig, batch: int, device="cpu") -> dict:
    H = cfg.num_heads
    z = lambda v: torch.full((batch, H, cfg.d_model // H), v,
                             dtype=torch.float32, device=device)
    return {"h": z(0.0), "c": z(0.0), "n": z(0.0), "m": z(NEG)}
