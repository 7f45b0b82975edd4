"""Attention on Hopper: the CUDA kernels of `csrc/flash_attention.cu`
bound through ctypes, their plain PyTorch versions, and the
`autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in
`repro/kernels/flash_attention.py` (`_flash_kernel`), which is
forward-only; here `flash_bwd_dq` and then `flash_bwd_dkdv` carry the
gradient. A CUDA tensor launches the kernel (or raises); only a CPU
tensor runs the plain version, so the CPU tests exercise the same
wiring and the same recompute-from-lse formula. A `meta` tensor (the
dry-run's) allocates what the CUDA path allocates, launches nothing and
adds the kernel's work to `work.TALLY`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.ref import online_softmax

NEG_INF = -1e30
# (q.k width, v width) pairs with an instance: one width for both, or
# multi-head latent attention's 128 + 64 rotary beside its v width 128
WIDTHS = tuple((d, d) for d in (16, 32, 64, 128, 256)) + ((192, 128),)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the plain versions take the chunked form above this sequence length,
# in chunks of these many queries and keys (the reference's
# `chunked_attention` defaults): no (BH, S, S) logits at long S
CHUNKED_FROM = 2048
Q_CHUNK, KV_CHUNK = 512, 1024

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else; callers zero them with reset_launches().
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q, k, v, *vs) -> None:
    """q and k (BH, S, dk), v and the other tensors `vs` (o, dO)
    (BH, S, dv), one dtype and device, (dk, dv) in WIDTHS."""
    if q.dim() != 3:
        raise ValueError(f"expected (BH, S, d), got {tuple(q.shape)}")
    dk, dv = q.shape[-1], v.shape[-1]
    if (dk, dv) not in WIDTHS:
        raise ValueError(f"head dims (q.k {dk}, v {dv}) not in {WIDTHS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not in float32/bfloat16")
    for t, d in [(k, dk)] + [(t, dv) for t in (v,) + vs]:
        if t.shape != q.shape[:-1] + (d,) or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError("q and k (BH, S, dk), v (and o, dO) (BH, S, "
                             "dv) must share dtype and device; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} "
                             f"against q {tuple(q.shape)} {q.dtype} "
                             f"{q.device}")


def _device_kind(t) -> str:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no attention kernel for device {t.device}")
    return t.device.type


def launch(fn: str, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.libraries()["flash_attention"], fn)(
            *args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed (code {rc})")
    LAUNCHES[fn] += 1


def _mask(s_len: int, t_len: int, causal: bool, window: int, device,
          q0: int = 0, k0: int = 0):
    """(S, T) bool for queries q0.. and keys k0.., True where key k is
    visible to query q: k <= q when causal, q - k < window when window >
    0; None when all are."""
    if not causal and not window:
        return None
    qi = torch.arange(q0, q0 + s_len, device=device)[:, None]
    ki = torch.arange(k0, k0 + t_len, device=device)[None]
    ok = (ki <= qi) if causal else torch.ones_like(qi == ki)
    return ok & (qi - ki < window) if window else ok


def _check_window(window: int) -> None:
    if window < 0:
        raise ValueError(f"window {window} < 0 (0 means no window)")


# ------------------------------------------------------ plain versions
def _block_mask(qs: slice, ks: slice, causal: bool, window: int, device):
    """_mask's block for the query slice qs and the key slice ks."""
    return _mask(qs.stop - qs.start, ks.stop - ks.start, causal, window,
                 device, qs.start, ks.start)


def _key_span(s_len: int, causal: bool, window: int):
    """(lo, hi) of the keys any query of a slice of rows may see."""
    def span(qs):
        lo = max(qs.start - window + 1, 0) if window else 0
        return lo, (qs.stop if causal else s_len)
    return span


def attention_fwd_chunked(q, k, v, causal: bool, scale: float, window=0):
    """attention_fwd_ref by the online softmax over chunks of Q_CHUNK
    queries and KV_CHUNK keys (`ref.online_softmax`), kv chunks no query
    of a chunk sees skipped."""
    def bias(qs, ks):
        mask = _block_mask(qs, ks, causal, window, q.device)
        return None if mask is None else torch.where(mask, 0.0, NEG_INF)
    o, lse = online_softmax(q, k, v, bias, q_chunk=Q_CHUNK,
                            kv_chunk=KV_CHUNK, scale=scale,
                            kv_range=_key_span(k.shape[1], causal, window))
    return o.to(q.dtype), lse


def attention_bwd_chunked(q, k, v, o, lse, do, causal: bool, scale: float,
                          window=0):
    """attention_bwd_ref a chunk of Q_CHUNK queries at a time against the
    keys it may see: P, dP and dS are (BH, Q_CHUNK, keys), never (BH, S,
    S); dk and dv sum over the chunks in f32."""
    s_len = q.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    span = _key_span(s_len, causal, window)
    for q0 in range(0, s_len, Q_CHUNK):
        qs = slice(q0, min(q0 + Q_CHUNK, s_len))
        ks = slice(*span(qs))
        p = torch.exp(qf[:, qs] @ kf[:, ks].transpose(1, 2) * scale
                      - lse[:, qs, None])
        mask = _block_mask(qs, ks, causal, window, q.device)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        dv[:, ks] += p.transpose(1, 2) @ dof[:, qs]
        ds = p * (dof[:, qs] @ vf[:, ks].transpose(1, 2)
                  - delta[:, qs, None])
        dq[:, qs] = ds @ kf[:, ks] * scale
        dk[:, ks] += ds.transpose(1, 2) @ qf[:, qs] * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_fwd_ref(q, k, v, causal: bool, scale: float, window=0):
    """(o in q's dtype, lse (BH, S) f32) in plain torch ops; the chunked
    form above CHUNKED_FROM queries."""
    if q.shape[1] > CHUNKED_FROM:
        return attention_fwd_chunked(q, k, v, causal, scale, window)
    s = torch.einsum("bsk,btk->bst", q.float(), k.float()) * scale
    mask = _mask(s.shape[1], s.shape[2], causal, window, s.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    den = torch.clamp(p.sum(-1), min=1e-30)
    o = torch.einsum("bst,btk->bsk", p, v.float()) / den[..., None]
    return o.to(q.dtype), m + torch.log(den)


def attention_bwd_ref(q, k, v, o, lse, do, causal: bool, scale: float,
                      window=0):
    """(dq, dk, dv) by the kernels' formula: P = exp(S*scale - lse),
    D = rowsum(dO * O), dS = P * (dO V^T - D); the chunked form above
    CHUNKED_FROM queries."""
    if q.shape[1] > CHUNKED_FROM:
        return attention_bwd_chunked(q, k, v, o, lse, do, causal, scale,
                                     window)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bsk,btk->bst", qf, kf) * scale
                  - lse[..., None])
    mask = _mask(p.shape[1], p.shape[2], causal, window, p.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bst,bsk->btk", p, dof)
    dp = torch.einsum("bsk,btk->bst", dof, vf)
    delta = (dof * o.float()).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bst,btk->bsk", ds, kf) * scale
    dk = torch.einsum("bst,bsk->btk", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -------------------------------------------------------------- wrappers
def _aligned16(t):
    """t itself when its data starts on a 16-byte boundary (the kernels
    copy rows 16 bytes at a time), else a fresh copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_fwd(q, k, v, causal: bool, scale: float, window: int = 0):
    """(o, lse): the `flash_fwd` kernel for CUDA tensors, the plain
    version for CPU tensors, the kernel's outputs unwritten for `meta`
    tensors."""
    _check(q, k, v)
    _check_window(window)
    if _device_kind(q) == "cpu":
        return attention_fwd_ref(q, k, v, causal, scale, window)
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    bh, s, dk = q.shape
    o = torch.empty_like(v)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        work.record("flash_fwd", *work.attention_work(
            "flash_fwd", bh, s, dk, q.dtype, causal, window, v.shape[-1]))
        return o, lse
    launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr(), bh, s, dk, v.shape[-1],
           _DTYPE_CODE[q.dtype], int(causal), int(window), float(scale),
           device=q.device)
    return o, lse


def flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
              window: int = 0):
    """(dq, dk, dv, delta): the `flash_bwd_dq` kernel, which also writes
    delta = rowsum(dO * O) ((BH, S) f32), then `flash_bwd_dkdv`, which
    reads it, for CUDA tensors; the plain version for CPU tensors."""
    _check(q, k, v, o, do)
    _check_window(window)
    if _device_kind(q) == "cpu":
        delta = (do.float() * o.float()).sum(-1)
        return (*attention_bwd_ref(q, k, v, o, lse, do, causal, scale,
                                   window), delta)
    q, k, v, o, do = (_aligned16(t.contiguous()) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    bh, s, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    common = (bh, s, q.shape[-1], v.shape[-1], _DTYPE_CODE[q.dtype],
              int(causal), int(window), float(scale))
    if q.device.type == "meta":
        for fn in ("flash_bwd_dq", "flash_bwd_dkdv"):
            work.record(fn, *work.attention_work(
                fn, bh, s, q.shape[-1], q.dtype, causal, window,
                v.shape[-1]))
        return dq, dk, dv, delta
    launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
           delta.data_ptr(), *common, device=q.device)
    launch("flash_bwd_dkdv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           delta.data_ptr(), lse.data_ptr(), do.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), *common, device=q.device)
    return dq, dk, dv, delta


class FlashAttentionFn(torch.autograd.Function):
    """Attention over (BH, S, d) whose forward and backward are the
    wrappers above."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window: int = 0):
        o, lse = flash_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv, _ = flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                  ctx.scale, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    window: int = 0):
    """q, k: (BH, S, dk), v: (BH, S, dv). Returns (BH, S, dv) in q's
    dtype; the default scale is dk^-0.5. window > 0 limits query q to
    keys k with q - k < window."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttentionFn.apply(q, k, v, causal, scale, window)
