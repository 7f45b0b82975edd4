"""Grouped expert matmul on Hopper: the CUDA kernels of
`csrc/moe_gmm.cu` bound through ctypes, their plain PyTorch versions,
and the `autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in `repro/kernels/moe_gmm.py`
(`_gmm_kernel`), which is forward-only; here `gmm_bwd_dx` and
`gmm_bwd_dw` carry the gradient. A CUDA tensor launches the kernel (or
raises); only a CPU tensor runs the plain version, so the CPU tests
exercise the same wiring. A `meta` tensor (the dry-run's) allocates what
the CUDA path allocates, launches nothing and adds the kernel's work to
`work.TALLY`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work
# the plain forward is the oracle itself
from repro_torch.kernels.ref import grouped_matmul as gmm_fwd_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 65535          # the kernels' grid z extent

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else; callers zero them with reset_launches().
LAUNCHES = {"gmm_fwd": 0, "gmm_bwd_dx": 0, "gmm_bwd_dw": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(a, b, a_dims: str, b_dims: str, shared) -> None:
    """a, b: (E, ., .) of one dtype and device; `shared` names which
    axis of each must agree besides E."""
    for t, dims in ((a, a_dims), (b, b_dims)):
        if t.dim() != 3:
            raise ValueError(f"expected {dims}, got {tuple(t.shape)}")
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {a.dtype} not in float32/bfloat16")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"operands must share dtype and device; got "
                         f"{a.dtype} {a.device} and {b.dtype} {b.device}")
    ia, ib = shared
    if a.shape[0] != b.shape[0] or a.shape[ia] != b.shape[ib]:
        raise ValueError(f"shapes {tuple(a.shape)} {a_dims} and "
                         f"{tuple(b.shape)} {b_dims} do not agree")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no grouped matmul kernel for device {a.device}")
    if a.shape[0] > MAX_EXPERTS:
        raise ValueError(f"{a.shape[0]} experts > {MAX_EXPERTS}")


def launch(fn: str, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.libraries()["moe_gmm"], fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed (code {rc})")
    LAUNCHES[fn] += 1


# ------------------------------------------------------ plain versions
def gmm_bwd_dx_ref(dy, w):
    """dx = dy @ w^T per expert, summed in f32, in dy's dtype."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def gmm_bwd_dw_ref(x, dy):
    """dw = x^T @ dy per expert (a sum over tokens), in f32, in x's
    dtype."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)


# -------------------------------------------------------------- wrappers
def _run(fn: str, a, b, out_shape, e: int, m: int, k: int, n: int):
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    a, b = a.contiguous(), b.contiguous()
    if a.device.type == "meta":
        work.record(fn, *work.gmm_work(e, m, k, n, a.dtype))
        return out
    launch(fn, a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m, k, n,
           _DTYPE_CODE[a.dtype], device=a.device)
    return out


def gmm_fwd(x, w):
    """x (E, M, K) @ w (E, K, N) -> (E, M, N): the `gmm_fwd` kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(x, w, "(E, M, K)", "(E, K, N)", (2, 1))
    if x.device.type == "cpu":
        return gmm_fwd_ref(x, w)
    (e, m, k), n = x.shape, w.shape[2]
    return _run("gmm_fwd", x, w, (e, m, n), e, m, k, n)


def gmm_bwd_dx(dy, w):
    """dy (E, M, N) @ w (E, K, N)^T -> dx (E, M, K)."""
    _check(dy, w, "(E, M, N)", "(E, K, N)", (2, 2))
    if dy.device.type == "cpu":
        return gmm_bwd_dx_ref(dy, w)
    (e, m, n), k = dy.shape, w.shape[1]
    return _run("gmm_bwd_dx", dy, w, (e, m, k), e, m, k, n)


def gmm_bwd_dw(x, dy):
    """x (E, M, K)^T @ dy (E, M, N) -> dw (E, K, N)."""
    _check(x, dy, "(E, M, K)", "(E, M, N)", (1, 1))
    if x.device.type == "cpu":
        return gmm_bwd_dw_ref(x, dy)
    (e, m, k), n = x.shape, dy.shape[2]
    return _run("gmm_bwd_dw", x, dy, (e, k, n), e, m, k, n)


class GroupedMatmul(torch.autograd.Function):
    """x (E, M, K) @ w (E, K, N) whose forward and backward are the
    wrappers above; the backward launches only the gradients that are
    needed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gmm_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = gmm_bwd_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = gmm_bwd_dw(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x, w):
    """x: (E, M, K), w: (E, K, N) -> (E, M, N) in x's dtype.
    Differentiable."""
    return GroupedMatmul.apply(x, w)
