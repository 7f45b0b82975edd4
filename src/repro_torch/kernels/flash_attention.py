"""Attention on Hopper: the CUDA kernels of `csrc/flash_attention.cu`
bound through ctypes, their plain PyTorch versions, and the
`autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in
`repro/kernels/flash_attention.py` (`_flash_kernel`), which is
forward-only; here `flash_bwd_dkdv` and `flash_bwd_dq` carry the
gradient. A CUDA tensor launches the kernel (or raises); only a CPU
tensor runs the plain version, so the CPU tests exercise the same
wiring and the same recompute-from-lse formula.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else; callers zero them with reset_launches().
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(*ts) -> None:
    q = ts[0]
    if q.dim() != 3:
        raise ValueError(f"expected (BH, S, d), got {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not in float32/bfloat16")
    for t in ts[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError("q, k, v (and o, dO) must share shape, dtype "
                             f"and device; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device} against {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")


def _device_kind(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
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


def _mask(s_len: int, t_len: int, causal: bool, window: int, device):
    """(S, T) bool, True where key k is visible to query q: k <= q when
    causal, q - k < window when window > 0; None when all are."""
    if not causal and not window:
        return None
    qi = torch.arange(s_len, device=device)[:, None]
    ki = torch.arange(t_len, device=device)[None]
    ok = (ki <= qi) if causal else torch.ones_like(qi == ki)
    return ok & (qi - ki < window) if window else ok


def _check_window(window: int) -> None:
    if window < 0:
        raise ValueError(f"window {window} < 0 (0 means no window)")


# ------------------------------------------------------ plain versions
def attention_fwd_ref(q, k, v, causal: bool, scale: float, window=0):
    """(o in q's dtype, lse (BH, S) f32) in plain torch ops."""
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
    D = rowsum(dO * O), dS = P * (dO V^T - D)."""
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
def flash_fwd(q, k, v, causal: bool, scale: float, window: int = 0):
    """(o, lse): the `flash_fwd` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(q, k, v)
    _check_window(window)
    if _device_kind(q) == "cpu":
        return attention_fwd_ref(q, k, v, causal, scale, window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr(), bh, s, d, _DTYPE_CODE[q.dtype],
           int(causal), int(window), float(scale), device=q.device)
    return o, lse


def flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
              window: int = 0):
    """(dq, dk, dv): the `flash_bwd_dkdv` and `flash_bwd_dq` kernels for
    CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v, o, do)
    _check_window(window)
    if _device_kind(q) == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal, scale,
                                 window)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    bh, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    common = (bh, s, d, _DTYPE_CODE[q.dtype], int(causal), int(window),
              float(scale))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), do.data_ptr())
    launch("flash_bwd_dkdv", *ins, dk.data_ptr(), dv.data_ptr(), *common,
           device=q.device)
    launch("flash_bwd_dq", *ins, dq.data_ptr(), *common, device=q.device)
    return dq, dk, dv


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
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                               ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    window: int = 0):
    """q,k,v: (BH, S, d). Returns (BH, S, d) in q's dtype. window > 0
    limits query q to keys k with q - k < window."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttentionFn.apply(q, k, v, causal, scale, window)
