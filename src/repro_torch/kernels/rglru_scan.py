"""RG-LRU linear recurrence on Hopper: the CUDA kernels of
`csrc/rglru_scan.cu` bound through ctypes, their plain PyTorch versions,
and the `autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in `repro/kernels/rglru_scan.py`
(`_rglru_kernel`), which is forward-only; here `rglru_bwd` carries the
gradient in one reverse pass. A CUDA tensor launches the kernel (or
raises); only a CPU tensor runs the plain version, so the CPU tests
exercise the same wiring.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
# the plain forward is the oracle itself
from repro_torch.kernels.ref import rglru_scan as rglru_fwd_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else; callers zero them with reset_launches().
LAUNCHES = {"rglru_fwd": 0, "rglru_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(a, *rest) -> None:
    """a and every array of `rest`: (B, S, D), one shape and device;
    each f32 or bf16."""
    if a.dim() != 3 or a.numel() == 0:
        raise ValueError(f"expected a non-empty (B, S, D), got "
                         f"{tuple(a.shape)}")
    for t in (a, *rest):
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"dtype {t.dtype} not in float32/bfloat16")
        if t.shape != a.shape or t.device != a.device:
            raise ValueError(f"arrays must share shape and device; got "
                             f"{tuple(t.shape)} {t.device} against "
                             f"{tuple(a.shape)} {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no RG-LRU scan kernel for device {a.device}")


def launch(fn: str, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.libraries()["rglru_scan"], fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed (code {rc})")
    LAUNCHES[fn] += 1


# ------------------------------------------------------ plain version
def rglru_bwd_ref(a, h, g):
    """(da, dx) by the kernel's reverse pass in f32:
    delta_t = g_t + a_{t+1} delta_{t+1}, dx_t = delta_t,
    da_t = delta_t h_{t-1} (h_{-1} = 0); da in a's dtype, dx in h's."""
    s = a.shape[1]
    delta = torch.zeros_like(g[:, 0], dtype=torch.float32)
    a_next = torch.zeros_like(delta)
    da, dx = [None] * s, [None] * s
    for t in range(s - 1, -1, -1):
        delta = g[:, t].float() + a_next * delta
        dx[t] = delta.to(h.dtype)
        h_prev = h[:, t - 1].float() if t else torch.zeros_like(delta)
        da[t] = (delta * h_prev).to(a.dtype)
        a_next = a[:, t].float()
    return torch.stack(da, 1), torch.stack(dx, 1)


# -------------------------------------------------------------- wrappers
def rglru_fwd(a, x):
    """h (B, S, D) in x's dtype: the `rglru_fwd` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(a, x)
    if a.device.type == "cpu":
        return rglru_fwd_ref(a, x)
    a, x = a.contiguous(), x.contiguous()
    h = torch.empty_like(x)
    b, s, d = a.shape
    launch("rglru_fwd", a.data_ptr(), x.data_ptr(), h.data_ptr(), b, s, d,
           _DTYPE_CODE[a.dtype], _DTYPE_CODE[x.dtype], device=a.device)
    return h


def rglru_bwd(a, h, g):
    """(da, dx) for the upstream gradient g of h = rglru_fwd(a, x): the
    `rglru_bwd` kernel for CUDA tensors, the plain version for CPU
    tensors. g is taken in h's dtype."""
    _check(a, h, g)
    g = g.to(h.dtype)
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, h, g)
    a, h, g = a.contiguous(), h.contiguous(), g.contiguous()
    da, dx = torch.empty_like(a), torch.empty_like(h)
    b, s, d = a.shape
    launch("rglru_bwd", a.data_ptr(), h.data_ptr(), g.data_ptr(),
           da.data_ptr(), dx.data_ptr(), b, s, d, _DTYPE_CODE[a.dtype],
           _DTYPE_CODE[h.dtype], device=a.device)
    return da, dx


class RGLRUScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + x_t whose forward and backward are the
    wrappers above; the backward needs only a and h."""

    @staticmethod
    def forward(ctx, a, x):
        h = rglru_fwd(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, dx = rglru_bwd(a, h, g)
        return (da if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None)


def rglru_scan(a, x):
    """a, x: (B, S, D) -> h (B, S, D) in x's dtype. Differentiable."""
    return RGLRUScan.apply(a, x)
