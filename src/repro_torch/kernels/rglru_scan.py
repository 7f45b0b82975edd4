"""RG-LRU linear recurrence on Hopper: the CUDA kernels of
`csrc/rglru_scan.cu` bound through ctypes, their plain PyTorch versions,
and the `autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in `repro/kernels/rglru_scan.py`
(`_rglru_kernel`), which is forward-only; here `rglru_bwd` carries the
gradient in reverse time. Each kernel is a chunked scan in three passes
over chunks of `chunk_len(B, S, D)` steps (reduce, carry, out; see the
CUDA source), each pass with a plain version below that takes the chunk
length. A CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the one-pass plain version, so the CPU tests exercise the same
wiring.
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

SMS = 132                 # streaming multiprocessors of an H100 SXM
WAVE = SMS * 2048         # threads the card holds at once (2048 an SM)
MIN_CHUNK = 16


def chunk_len(b: int, s: int, d: int) -> int:
    """The chunk length L of both kernels at (B, S, D): the longest power
    of two from MIN_CHUNK for which the (chunk, lane) pairs, B * D *
    ceil(S / L), still fill a WAVE, and at most the power of two that
    covers S (one chunk: a walk over the whole row). A pair keeps its
    loads of 8 steps in flight (a thread takes one pair, or four where D
    allows), so a wave of pairs is as many loads as a wave of one-lane
    threads. A narrow B * D gets many short chunks, a wide one few long
    ones."""
    chunk = MIN_CHUNK
    while chunk < s and b * d * -(-s // (2 * chunk)) >= WAVE:
        chunk *= 2
    return chunk


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
    # the raw stream: a torch.cuda.Stream object costs microseconds of
    # host time, which the scan's 0.1 ms calls feel
    with torch.cuda.device(device):
        rc = getattr(_build.libraries()["rglru_scan"], fn)(
            *args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed (code {rc})")
    LAUNCHES[fn] += 1


# ------------------------------------------------------ plain versions
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


# The kernels' passes, each in f32 over all chunks at once: (B, S, D)
# arrays are cut into (B, nc, chunk, D), the ragged end padded with
# steps that leave every sum as it is. Aggregates and carries are (B,
# nc, D) f32, as in the kernels' workspace.
def _chunks(t, chunk: int, fill: float):
    b, s, d = t.shape
    nc = -(-s // chunk)
    t = t.float()
    if nc * chunk > s:
        t = torch.cat([t, t.new_full((b, nc * chunk - s, d), fill)], 1)
    return t.view(b, nc, chunk, d)


def _a_next(a):
    """a_{t+1} at each t, 0 at the last step (a_S = 0)."""
    a = a.float()
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)


def rglru_fwd_reduce_ref(a, x, chunk: int):
    """(A, X): per chunk the product of its a_t and its last h_t from a
    zero carry."""
    ac, xc = _chunks(a, chunk, 1.0), _chunks(x, chunk, 0.0)
    A, X = torch.ones_like(ac[:, :, 0]), torch.zeros_like(ac[:, :, 0])
    for u in range(chunk):
        X = ac[:, :, u] * X + xc[:, :, u]
        A = A * ac[:, :, u]
    return A, X


def rglru_bwd_reduce_ref(a, g, chunk: int):
    """(P, G): per chunk the product of a_{t+1} over its rows and its
    first row's delta from a zero delta after its end."""
    anc, gc = _chunks(_a_next(a), chunk, 0.0), _chunks(g, chunk, 0.0)
    P, G = torch.ones_like(gc[:, :, 0]), torch.zeros_like(gc[:, :, 0])
    for u in range(chunk - 1, -1, -1):
        G = anc[:, :, u] * G + gc[:, :, u]
        P = P * anc[:, :, u]
    return P, G


def rglru_carry_ref(prod, end, reverse: bool = False):
    """The carry each chunk starts from, walking the chunks in order
    (the forward) or from the last (`reverse`, the backward): carry = 0,
    then per chunk carry = prod * carry + end."""
    out = torch.empty_like(end)
    carry = torch.zeros_like(end[:, 0])
    nc = end.shape[1]
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        out[:, c] = carry
        carry = prod[:, c] * carry + end[:, c]
    return out


def rglru_fwd_out_ref(a, x, carry, chunk: int):
    """h in x's dtype: each chunk walked again from its carry."""
    b, s, d = a.shape
    ac, xc = _chunks(a, chunk, 1.0), _chunks(x, chunk, 0.0)
    h, out = carry, []
    for u in range(chunk):
        h = ac[:, :, u] * h + xc[:, :, u]
        out.append(h)
    return torch.stack(out, 2).reshape(b, -1, d)[:, :s].to(x.dtype)


def rglru_bwd_out_ref(a, h, g, carry, chunk: int):
    """(da, dx): each chunk walked again from its end, delta starting at
    the carry (the next chunk's first delta); da in a's dtype, dx in
    h's."""
    b, s, d = a.shape
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    anc, gc = _chunks(_a_next(a), chunk, 0.0), _chunks(g, chunk, 0.0)
    hc = _chunks(h_prev, chunk, 0.0)
    delta, da, dx = carry, [None] * chunk, [None] * chunk
    for u in range(chunk - 1, -1, -1):
        delta = anc[:, :, u] * delta + gc[:, :, u]
        dx[u], da[u] = delta, delta * hc[:, :, u]
    cut = lambda ts, dt: torch.stack(ts, 2).reshape(b, -1, d)[:, :s].to(dt)
    return cut(da, a.dtype), cut(dx, h.dtype)


def rglru_fwd_passes_ref(a, x, chunk: int):
    """h by the forward kernel's three passes."""
    A, X = rglru_fwd_reduce_ref(a, x, chunk)
    return rglru_fwd_out_ref(a, x, rglru_carry_ref(A, X), chunk)


def rglru_bwd_passes_ref(a, h, g, chunk: int):
    """(da, dx) by the backward kernel's three passes."""
    P, G = rglru_bwd_reduce_ref(a, g, chunk)
    return rglru_bwd_out_ref(a, h, g, rglru_carry_ref(P, G, reverse=True),
                             chunk)


# -------------------------------------------------------------- wrappers
def _workspace(a, chunk: int):
    """The kernels' (2, B, nc, D) f32 workspace: each chunk's product
    and end value, then its carry in place of the end value."""
    b, s, d = a.shape
    return torch.empty(2, b, -(-s // chunk), d, dtype=torch.float32,
                       device=a.device)


def _launch_fwd(a, x, chunk: int):
    """(h, ws) from the `rglru_fwd` kernel on contiguous CUDA tensors;
    ws ends holding each chunk's product of a and its carry."""
    h, ws = torch.empty_like(x), _workspace(a, chunk)
    b, s, d = a.shape
    launch("rglru_fwd", a.data_ptr(), x.data_ptr(), h.data_ptr(),
           ws.data_ptr(), b, s, d, chunk, _DTYPE_CODE[a.dtype],
           _DTYPE_CODE[x.dtype], device=a.device)
    return h, ws


def _launch_bwd(a, h, g, chunk: int):
    """(da, dx, ws) from the `rglru_bwd` kernel on contiguous CUDA
    tensors; ws ends holding each chunk's product of a_{t+1} and its
    carry."""
    da, dx, ws = torch.empty_like(a), torch.empty_like(h), \
        _workspace(a, chunk)
    b, s, d = a.shape
    launch("rglru_bwd", a.data_ptr(), h.data_ptr(), g.data_ptr(),
           da.data_ptr(), dx.data_ptr(), ws.data_ptr(), b, s, d, chunk,
           _DTYPE_CODE[a.dtype], _DTYPE_CODE[h.dtype], device=a.device)
    return da, dx, ws


def rglru_fwd(a, x):
    """h (B, S, D) in x's dtype: the `rglru_fwd` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(a, x)
    if a.device.type == "cpu":
        return rglru_fwd_ref(a, x)
    return _launch_fwd(a.contiguous(), x.contiguous(),
                       chunk_len(*a.shape))[0]


def rglru_bwd(a, h, g):
    """(da, dx) for the upstream gradient g of h = rglru_fwd(a, x): the
    `rglru_bwd` kernel for CUDA tensors, the plain version for CPU
    tensors. g is taken in h's dtype."""
    _check(a, h, g)
    if g.dtype != h.dtype:
        g = g.to(h.dtype)
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, h, g)
    return _launch_bwd(a.contiguous(), h.contiguous(), g.contiguous(),
                       chunk_len(*a.shape))[:2]


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
