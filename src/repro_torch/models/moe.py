"""Mixture-of-Experts FFN with capacity-based dispatch (counterpart of
`repro/models/moe.py`), and `decode_moe`, the decode path's
dense-gather form.

The router, the top-k choice, dispatch and combine are plain tensor
code, as the reference computes them outside any kernel; the three
expert products (gate, up, down) run in the grouped-matmul kernels
(kernels/moe_gmm.py), folded from (E, B, C, .) to (E, B*C, .). The
shared (always-on) experts are one dense SwiGLU MLP of width
num_shared * d_expert. `moe_axes` names the weights' logical axes.

Under a mesh each `model` rank holds E / tp experts (the padded count,
`phys_experts`), its columns of the router and its `d_ff` block of the
shared experts. Every rank gathers the whole (B, S, E) logits and
routes its rows as one device does: capacity is per batch row, so a
data rank that routes its own rows drops exactly the tokens the
reference drops. It then runs the grouped matmul on its experts' slice
of the dispatch, and its experts' and shared block's partial outputs are
added over `model`. The load-balance loss is each rank's exact share of
the global batch's: its experts' terms, its rows' mean router
probability over the data extent, and the expert counts summed over the
data ranks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.models.shardings import (axis_index, axis_size,
                                          from_model, gather_model,
                                          sum_over_batch, to_model)


def phys_experts(moe: MoECfg, ep: int) -> int:
    return -(-moe.num_experts // ep) * ep


def _uniform(gen, shape, fan, dtype, device):
    """U(-lim, lim) with lim = sqrt(6 / sum(fan)) (Glorot), drawn in
    `shape` directly (the reference draws (fan..., E) and transposes;
    the entries are i.i.d. either way)."""
    lim = (6.0 / sum(fan)) ** 0.5
    u = torch.rand(shape, generator=gen, device=device)
    return ((u * 2 - 1) * lim).to(dtype)


def init_moe(gen, cfg: ArchConfig, ep: int, dtype, device="cpu") -> dict:
    moe = cfg.moe
    d, de = cfg.d_model, (moe.d_expert or cfg.d_ff)
    e = phys_experts(moe, ep)
    p = {
        "router": torch.randn((d, e), generator=gen, device=device) * 0.02,
        "w_gate": _uniform(gen, (e, d, de), (d, de), dtype, device),
        "w_up": _uniform(gen, (e, d, de), (d, de), dtype, device),
        "w_down": _uniform(gen, (e, de, d), (de, d), dtype, device),
    }
    if moe.num_shared:
        ds = moe.num_shared * de
        p["ws_gate"] = _uniform(gen, (d, ds), (d, ds), dtype, device)
        p["ws_up"] = _uniform(gen, (d, ds), (d, ds), dtype, device)
        p["ws_down"] = _uniform(gen, (ds, d), (ds, d), dtype, device)
    return p


def moe_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_moe's structure."""
    a = {
        "router": (None, "experts"),
        "w_gate": ("experts", None, None),
        "w_up": ("experts", None, None),
        "w_down": ("experts", None, None),
    }
    if cfg.moe.num_shared:
        a.update(ws_gate=(None, "d_ff"), ws_up=(None, "d_ff"),
                 ws_down=("d_ff", None))
    return a


def _expert_matmul(x, w):
    """(E, B, C, K) @ (E, K, N) -> (E, B, C, N) through the kernel."""
    E, B, C, K = x.shape
    y = ops.grouped_matmul(x.reshape(E, B * C, K), w)
    return y.reshape(E, B, C, w.shape[-1])


def route(p: dict, x, cfg: ArchConfig, capacity: int, mesh=None):
    """Router and capacity-based top-k dispatch over every expert (under
    a mesh the rank's router columns' logits gathered over `model`).
    Returns (probs, onehot, dispatch, combine): probs (B,S,E) f32,
    onehot (B,S,k,E), dispatch and combine (B,S,E,C) f32."""
    moe = cfg.moe
    k = moe.top_k
    B, S, _ = x.shape
    logits = gather_model(blocks.matmul(x.float(), p["router"]), mesh)
    E = logits.shape[-1]                                    # (B,S,E)
    if E > moe.num_experts:                                 # mask padding
        pad = torch.arange(E, device=x.device) >= moe.num_experts
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, -1)
    # sorted, descending: the order of the k choices sets the buffer
    # positions below, as jax.lax.top_k's order does in the reference
    gate_vals, idx = torch.topk(probs, k, dim=-1, sorted=True)  # (B,S,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    onehot_i = F.one_hot(idx, E)                            # (B,S,k,E) int
    onehot = onehot_i.float()
    # position of each (token, expert-choice) in that expert's buffer;
    # summed in int32 (a float cumsum on CUDA is refused in
    # deterministic mode, and the integer sum is exact)
    flat = onehot_i.reshape(B, S * k, E).to(torch.int32)
    pos = (torch.cumsum(flat, 1) - 1).float().reshape(B, S, k, E)
    keep = (pos < capacity) & (onehot > 0)
    oh_keep = onehot * keep.float()                         # (B,S,k,E)
    pos_sel = (pos * oh_keep).sum(-1)                       # (B,S,k)
    slot = F.one_hot(pos_sel.long(), capacity).float()      # (B,S,k,C)
    slot = slot * keep.any(-1, keepdim=True).float()
    dispatch = torch.einsum("bske,bskc->bsec", oh_keep, slot)
    # two two-operand einsums: no (B,S,k,E,C) intermediate
    combine = torch.einsum("bske,bskc->bsec",
                           gate_vals[..., None] * oh_keep, slot)
    return probs, onehot, dispatch, combine


def apply_moe(p: dict, x, cfg: ArchConfig, capacity: Optional[int] = None,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Capacity-based top-k dispatch (Switch/Mixtral style): the dispatch
    one-hot (B,S,E,C) routes tokens into per-expert buffers of C slots
    per batch row; overflow tokens are dropped (their residual path
    carries them). Under `mesh`, p holds the rank's experts and x its
    rows; y is whole over `model` and aux the rank's share of the
    global batch's (see the module's docstring)."""
    moe = cfg.moe
    B, S, D = x.shape
    if capacity is None:
        capacity = max(4, int(math.ceil(S * moe.top_k / moe.num_experts
                                        * moe.capacity_factor)))
    # the router, the routed and the shared experts all read x: its
    # gradient is summed over `model` here, once
    x = to_model(x, mesh)
    probs, onehot, dispatch, combine = route(p, x, cfg, capacity, mesh)
    # the rank's experts [lo, lo + n) of the E routed over
    n = p["w_gate"].shape[0]
    lo = axis_index(mesh, "experts") * n
    if n < dispatch.shape[2]:
        dispatch = dispatch.narrow(2, lo, n)
        combine = combine.narrow(2, lo, n)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    h = F.silu(_expert_matmul(xin, p["w_gate"]))
    h = h * _expert_matmul(xin, p["w_up"])
    out = _expert_matmul(h, p["w_down"])
    y = blocks.einsum("ebcd,bsec->bsd", out, combine.to(x.dtype))

    if moe.num_shared:
        hs = F.silu(blocks.matmul(x, p["ws_gate"])) * \
            blocks.matmul(x, p["ws_up"])
        y = y + blocks.matmul(hs, p["ws_down"])
    y = from_model(y, mesh)

    # Switch-style load-balance auxiliary loss over live experts: the
    # rank's experts' terms, added over `model`; means over the global
    # batch, the rank's share of me and the data ranks' sum of ce
    live = slice(lo, min(lo + n, moe.num_experts))
    dp = axis_size(mesh, "batch")
    me = probs[..., live].mean((0, 1)) / dp
    ce = sum_over_batch(onehot[..., live].sum(2).mean((0, 1)), mesh) / dp
    aux = moe.num_experts * torch.sum(me * ce) * moe.router_aux_weight
    return y.to(x.dtype), from_model(aux, mesh)


def decode_moe(p: dict, x, cfg: ArchConfig, mesh=None):
    """Decode-path MoE (S small), the reference's dense-gather form:
    every expert runs on the tiny token set, and each token's output is
    its experts' outputs weighted by its renormalised top-k gates, plus
    the shared experts. Nothing is dropped (apply_moe drops tokens over
    capacity). The products are plain, as the reference computes them
    outside any kernel. x: (B, S, D). Under `mesh`, p holds the rank's
    experts and x its rows: the router's logits are gathered over
    `model` and the top-k taken over every expert, the rank's experts
    run on every token with its columns of the combine weights, and the
    partial outputs (with the shared experts' `d_ff` block's) are added
    over `model`."""
    moe = cfg.moe
    logits = gather_model(blocks.matmul(x.float(), p["router"]), mesh)
    E = logits.shape[-1]
    if E > moe.num_experts:                                 # mask padding
        pad = torch.arange(E, device=x.device) >= moe.num_experts
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, -1)
    gate_vals, idx = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # the one-hot by comparison with a fixed class count: no host sync
    onehot = (idx[..., None] == torch.arange(E, device=x.device)).float()
    w = torch.einsum("bsk,bske->bse", gate_vals, onehot)
    n = p["w_gate"].shape[0]                # the rank's experts
    if n < E:
        w = w.narrow(-1, axis_index(mesh, "experts") * n, n)
    h = F.silu(blocks.einsum("bsd,edf->ebsf", x, p["w_gate"]))
    h = h * blocks.einsum("bsd,edf->ebsf", x, p["w_up"])
    out = blocks.einsum("ebsf,efd->ebsd", h, p["w_down"])
    y = blocks.einsum("ebsd,bse->bsd", out, w.to(x.dtype))
    if moe.num_shared:
        hs = F.silu(blocks.matmul(x, p["ws_gate"])) * \
            blocks.matmul(x, p["ws_up"])
        y = y + blocks.matmul(hs, p["ws_down"])
    return from_model(y, mesh).to(x.dtype)
