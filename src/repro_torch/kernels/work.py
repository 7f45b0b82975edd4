"""The work each kernel does at a shape: the FLOPs its function needs and
the bytes it must move (each input read once, each output written
once). `chip_smoke.py` divides them by the card's peaks for each
kernel's bound; the kernels' `meta` branches add them to the tally
below, which the dry-run (`launch/dryrun.py`) reads, so a kernel's
roofline counts the same work whichever code reads it.

A wrapper given `meta` tensors allocates what its CUDA path allocates
and launches nothing; it calls `record` with its kernel's name and
work instead.
"""
from __future__ import annotations

import torch

# kernel name -> {"calls", "flops", "bytes"} since the last reset()
TALLY: dict = {}


def reset() -> None:
    TALLY.clear()


def record(name: str, flops: int, nbytes: int) -> None:
    """One call of kernel `name` on `meta` tensors, doing this work."""
    t = TALLY.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    t["calls"] += 1
    t["flops"] += int(flops)
    t["bytes"] += int(nbytes)


def totals() -> tuple:
    """(FLOPs, bytes) of every kernel call tallied since the reset."""
    return (sum(t["flops"] for t in TALLY.values()),
            sum(t["bytes"] for t in TALLY.values()))


def _el(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def visible_pairs(s, causal, window):
    """(q, k) pairs the mask keeps: k <= q when causal, q - k < window
    when window > 0."""
    q = torch.arange(s)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    hi = q + 1 if causal else torch.full_like(q, s)
    return int((hi - lo).clamp(min=0).sum())


def attention_work(name, bh, s, d, dtype, causal, window, dv=None):
    """(FLOPs, bytes) the function needs at this shape, q and k (and
    their gradients) `d` wide, v, o and dO (and dv) `dv` wide (d where
    None): only the unmasked (q, k) pairs count; each input read once,
    each output written once."""
    dv = dv or d
    pairs = bh * visible_pairs(s, causal, window)
    el = _el(dtype)
    tk, tv = bh * s * d * el, bh * s * dv * el   # one (BH, S, .) tensor
    row = bh * s * 4                 # one f32 value a row: lse, delta
    if name == "flash_fwd":          # QK^T, PV; reads q,k,v; writes o,lse
        return 2 * (d + dv) * pairs, 2 * tk + tv + tv + row
    if name == "flash_bwd_dkdv":     # S, dP, dV, dK; reads q,k,v,dO,lse,D
        return 4 * (d + dv) * pairs, 2 * tk + 2 * tv + 2 * row + tk + tv
    # dq: D = rowsum(dO O), S, dP, dQ; reads q,k,v,o,dO,lse; writes dq,D
    return ((4 * d + 2 * dv) * pairs + 2 * bh * s * dv,
            2 * tk + 3 * tv + row + tk + row)


def gmm_work(e, m, k, n, dtype):
    """(FLOPs, bytes) of one grouped product at this shape, the same for
    all three kernels: 2*E*M*K*N FLOPs; two of x (E,M,K), w (E,K,N) and
    dy (E,M,N) read once, the third written once."""
    el = _el(dtype)
    return 2 * e * m * k * n, (e * m * k + e * k * n + e * m * n) * el


def scan_work(name, b, s, d, a_dtype, x_dtype):
    """(FLOPs, bytes) of one scan at this shape: forward reads a and x
    and writes h (a multiply and an add a step); backward reads a, h and
    g and writes da and dx (three operations a step)."""
    n = b * s * d
    if name == "rglru_fwd":
        return 2 * n, n * (_el(a_dtype) + 2 * _el(x_dtype))
    return 3 * n, n * (2 * _el(a_dtype) + 3 * _el(x_dtype))


def mlstm_work(name, bh, s, k, chunk, dtype):
    """(FLOPs, bytes) one mLSTM kernel needs at this shape, per (head,
    chunk) summed: products over the causal pairs s <= t only; each
    input read once, each output written once (the forward's outputs
    include the per-chunk states and each row's m_loc and den)."""
    nc, L = s // chunk, chunk
    pairs = L * (L + 1) // 2
    el = _el(dtype)
    row = bh * s * k                       # elements of one (BH, S, K)
    gates = bh * s * 4                     # one (BH, S) f32 array
    states = bh * nc * (k * k + k + 1) * 4
    if name == "mlstm_fwd":    # q C, C update; q k^T, (D * qk) v; q.n, n
        flops = bh * nc * (4 * L * k * k + 4 * k * pairs + 4 * L * k)
        return flops, 4 * row * el + 2 * gates + states + 2 * gates
    if name == "mlstm_bwd_dqdk":
        # C dnum, dC v, dC update; v dnum^T, dP k, dP^T q; dh.h, n, dn
        flops = bh * nc * (6 * L * k * k + 6 * k * pairs + 6 * L * k)
        return flops, (5 * row * el + 4 * gates + states
                       + 2 * row * 4)
    # dv: k dC; q k^T, P'^T dh; q.dq, k.dk. Reads q, k, dh, dq, dk, the
    # dC workspace once, log_i, m_loc and the workspace's F, w and
    # denominator; writes dv, dlog_i, dlog_f
    flops = bh * nc * (2 * L * k * k + 4 * k * pairs + 4 * L * k)
    return flops, (3 * row * el + 2 * row * 4 + bh * nc * k * k * 4
                   + 5 * gates + row * 4 + 2 * gates)
