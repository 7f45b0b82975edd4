"""Attention primitives (counterpart of `repro/models/attention.py`):
RoPE, the position mask, the plain dense, chunked (online softmax) and
sliding-window attention, `attend`, which sends full-sequence attention
through the CUDA kernels, and the KV caches (full and ring buffer) with
single-token `decode_attend`.

Layout conventions
  q:    (B, S, NKV, G, K)   NKV = physical kv heads, G = q-per-kv
  k/v:  (B, T, NKV, K), v's last axis Kv where it differs (MLA)
All attention math runs in f32 and casts back to the input dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import online_softmax

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


def chunked_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      q_chunk=512, kv_chunk=1024, scale=None):
    """Flash-style attention in plain torch ops, O(S * chunk) memory: q
    chunks of `q_chunk` rows, each walking kv chunks of `kv_chunk` keys
    with a running (max, denom, acc) (`ref.online_softmax`).
    q:(B,S,N,G,K) k:(B,T,N,K) v:(B,T,N,V) -> (B,S,N,G,V) in q's dtype;
    the mask from the positions, as `_mask_bias` gives it. The last q
    and kv chunks may be short, where the reference pads them."""
    B, S, N, G, K = q.shape
    scale = scale or K ** -0.5

    def bias(qs, ks):                                   # (B,1,1,qc,kc)
        return _mask_bias(q_pos[:, qs], k_pos[:, ks], causal,
                          window)[:, None, None]

    out, _ = online_softmax(q.permute(0, 2, 3, 1, 4),
                            k.permute(0, 2, 1, 3)[:, :, None],
                            v.permute(0, 2, 1, 3)[:, :, None], bias,
                            q_chunk=min(q_chunk, S),
                            kv_chunk=min(kv_chunk, k.shape[1]), scale=scale)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def local_attention(q, k, v, q_pos, k_pos, *, window, q_chunk=512,
                    scale=None):
    """Sliding-window attention: each q chunk attends only the kv range
    it can see (window + chunk keys), so the cost is O(S * window). As
    in the reference, S no multiple of the chunk, or a span that covers
    T, runs `chunked_attention`."""
    S, K = q.shape[1], q.shape[-1]
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        return chunked_attention(q, k, v, q_pos, k_pos, causal=True,
                                 window=window, q_chunk=q_chunk, scale=scale)
    span = window + q_chunk
    if span >= T:
        return chunked_attention(q, k, v, q_pos, k_pos, causal=True,
                                 window=window, q_chunk=q_chunk,
                                 kv_chunk=min(1024, T), scale=scale)
    scale = scale or K ** -0.5
    outs = []
    for i in range(S // q_chunk):
        # jax.lax.dynamic_slice's clamp: the span stays inside T
        start = min(max(i * q_chunk + q_chunk - span, 0), T - span)
        qs, ks = slice(i * q_chunk, (i + 1) * q_chunk), \
            slice(start, start + span)
        outs.append(dense_attention(q[:, qs], k[:, ks], v[:, ks],
                                    q_pos[:, qs], k_pos[:, ks], causal=True,
                                    window=window, scale=scale))
    return torch.cat(outs, 1)


def attend(q, k, v, q_pos, k_pos, *, causal=True, window=0,
           impl="chunked", scale=None):
    """Full-sequence attention through `ops.flash_attention`, whatever
    `impl` names: the kernel is the port's only attention path, the
    sliding window (`window` > 0, `local_attn`) included.

    q and k share the q.k width K; v may have its own width Kv (MLA's
    128 against K = 192), which the output takes. q_pos and k_pos must
    be 0..S-1 in every row (the training and prefill positions); the
    kernel masks by index. q and kv of different lengths (KV caches,
    decode) go through `decode_attend`; a scale other than K^-0.5
    (MLA's explicit scale is that one) is refused."""
    B, S, N, G, K = q.shape
    T, Kv = k.shape[1], v.shape[-1]
    if S != T or scale not in (None, K ** -0.5):
        raise NotImplementedError(
            "attend supports full-sequence attention at the default "
            "scale only; single-token decode is decode_attend")
    if impl not in ("dense", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, N * G, S, K)
    grp = lambda t: t.permute(0, 2, 1, 3)[:, :, None] \
        .expand(B, N, G, T, t.shape[-1]).reshape(B, N * G, T, t.shape[-1])
    out = ops.flash_attention(qh, grp(k), grp(v), causal=causal,
                              window=window)
    return out.reshape(B, N, G, S, Kv).permute(0, 3, 1, 2, 4)


# ------------------------------------------------------------ KV cache
# Cache tree: {"k": (B,size,N,K), "v": (B,size,N,K), "pos": () int32}, the
# reference's; ring-ness and the window are static arguments of the
# functions, not leaves. `pos` stays on the device: every index below is
# a tensor, so a decode step never waits for the host.
UNWRITTEN = 2 ** 30          # position of a slot never written


def init_kv_cache(batch: int, max_len: int, n_kv: int, k_dim: int,
                  dtype=torch.bfloat16, ring: bool = False, window: int = 0,
                  device="cpu") -> dict:
    size = min(window, max_len) if (ring and window) else max_len
    zeros = lambda: torch.zeros((batch, size, n_kv, k_dim), dtype=dtype,
                                device=device)
    return {"k": zeros(), "v": zeros(),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def write_slot(buf, idx, new) -> None:
    """buf[:, idx[0]] = new[:, 0] in place; idx is a (1,) int64 tensor on
    buf's device. In deterministic mode CUDA's index_copy_ takes
    index_put_'s sorted path, which reads the index's range on the host
    (a sync per call); with one index there is one writer, so the plain
    kernel, run with the mode off, is deterministic too."""
    det = buf.is_cuda and torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if det:
        torch.use_deterministic_algorithms(False)
    try:
        buf.index_copy_(1, idx, new.to(buf.dtype))
    finally:
        if det:
            torch.use_deterministic_algorithms(True, warn_only=warn)


def cache_update(cache: dict, k_new, v_new, *, ring: bool = False) -> dict:
    """Append one step (S_new = 1) of k/v: slot pos % size for a ring,
    else min(pos, size - 1) (past the end the last slot is overwritten,
    as in the reference). k and v are written in place; the returned
    dict holds them and a new pos = pos + 1."""
    pos = cache["pos"]
    size = cache["k"].shape[1]
    idx = torch.remainder(pos, size) if ring else torch.clamp(pos,
                                                              max=size - 1)
    idx = idx.reshape(1).long()
    write_slot(cache["k"], idx, k_new)
    write_slot(cache["v"], idx, v_new)
    return dict(cache, pos=pos + 1)


def cache_positions(cache: dict, *, ring: bool = False):
    """Absolute positions of the cache slots, (1, size); unwritten slots
    get UNWRITTEN, which the mask hides (>= PAD_SENTINEL)."""
    size = cache["k"].shape[1]
    pos = cache["pos"]
    slots = torch.arange(size, dtype=pos.dtype, device=pos.device)
    if ring:
        # slot i holds the largest absolute p < pos with p % size == i
        last = pos - 1
        abs_pos = slots + torch.div(last - slots, size,
                                    rounding_mode="floor") * size
        abs_pos = torch.where(abs_pos > last, abs_pos - size, abs_pos)
        abs_pos = torch.where(abs_pos < 0, UNWRITTEN, abs_pos)
    else:
        abs_pos = torch.where(slots < pos, slots, UNWRITTEN)
    return abs_pos[None, :]


def decode_attend(q, cache: dict, q_pos, *, ring=False, window=0,
                  scale=None):
    """Single-token attention against a cache, q (B,1,N,G,K): the plain
    `dense_attention` over every slot, as the reference computes it.
    The keys and values of unwritten slots are zeroed as well as masked,
    so a slot never written adds nothing whatever its buffer holds (NaN
    included); a masked slot's weight is 0 either way, so the result is
    the reference's."""
    size = cache["k"].shape[1]
    k_pos = cache_positions(cache, ring=ring).expand(q.shape[0], size)
    written = (k_pos[0] < PAD_SENTINEL)[None, :, None, None]
    k = torch.where(written, cache["k"], 0)
    v = torch.where(written, cache["v"], 0)
    return dense_attention(q, k, v, q_pos, k_pos, causal=True,
                           window=window, scale=scale)
