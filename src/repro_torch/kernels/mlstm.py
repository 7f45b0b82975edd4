"""Chunkwise mLSTM on Hopper: the CUDA kernels of `csrc/mlstm.cu` bound
through ctypes, their plain PyTorch versions, and the
`autograd.Function` that trains through them.

The counterpart of the Pallas TPU kernel in `repro/kernels/mlstm.py`
(`_mlstm_kernel`), which is forward-only. Here the forward also writes
what the backward needs (the (C, n, m) state at the start of every
chunk, and each row's stabilizer m_loc and denominator den), and the
backward is two kernels: `mlstm_bwd_dqdk` (dq, dk) and then
`mlstm_bwd_dv` (dv and the log-gate gradients, which need the finished
dq and dk). A CUDA tensor launches the kernels (or raises); only a CPU
tensor runs the plain versions, so the CPU tests exercise the same
wiring.

The backward treats every stabilizer as a constant. With num = e^-M
num_raw and den = e^-M den_raw for a row's stabilizer M, the output
num_raw / max(|den_raw|, 1) does not depend on M, so its gradient is the
same with or without the stabilizer's; the stabilized form is kept
because the raw exponentials overflow. With a_ts = exp(F_t - F_s +
log_i_s - m_loc_t) (F the inclusive cumsum of log_f over the sequence)
and q scaled by K^-0.5, h_t = num_t / max(|den_t|, exp(-m_loc_t)) with
num_t = sum_{s<=t} a_ts (q_t.k_s) v_s and den_t = sum_{s<=t} a_ts
(q_t.k_s), whence
    dlog_i_s = k_s . dk_s,   dF_t = q_t . dq_t - k_t . dk_t,
    dlog_f_t = sum_{j>=t} dF_j.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_chunks, tril_ones

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64            # the kernels' column tile; K must be a multiple
MAX_K = 512          # C's column tile (K x 64 f32) fits shared memory
MAX_CHUNK = 64

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else; callers zero them with reset_launches().
LAUNCHES = {"mlstm_fwd": 0, "mlstm_bwd_dqdk": 0, "mlstm_bwd_dv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q, k, v, log_i, log_f, chunk: int) -> None:
    """q, k, v: (BH, S, K), one dtype (f32 or bf16) and device; log_i,
    log_f: (BH, S), f32 or bf16; K a multiple of 64 up to 512; chunk
    at most 64 and dividing S."""
    if q.dim() != 3 or q.numel() == 0:
        raise ValueError(f"expected a non-empty (BH, S, K), got "
                         f"{tuple(q.shape)}")
    bh, s, kd = q.shape
    for t in (q, k, v):
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one dtype of float32/"
                             f"bfloat16; got {t.dtype} against {q.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"q, k, v must share shape and device; got "
                             f"{tuple(t.shape)} {t.device} against "
                             f"{tuple(q.shape)} {q.device}")
    for t in (log_i, log_f):
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"log gate dtype {t.dtype} not in float32/"
                             f"bfloat16")
        if tuple(t.shape) != (bh, s) or t.device != q.device:
            raise ValueError(f"log gates must be (BH, S) = {(bh, s)} on "
                             f"{q.device}; got {tuple(t.shape)} {t.device}")
    if kd % TILE or kd > MAX_K:
        raise ValueError(f"head dim {kd} is not a multiple of {TILE} up "
                         f"to {MAX_K}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S = {s}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no mLSTM kernel for device {q.device}")


def launch(fn: str, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.libraries()["mlstm"], fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed (code {rc})")
    LAUNCHES[fn] += 1


# ------------------------------------------------------ plain versions
def mlstm_fwd_ref(q, k, v, log_i, log_f, chunk: int):
    """(h in q's dtype, aux) from the zero state, with aux = (C (BH, nc,
    K, K), n (BH, nc, K), m (BH, nc)) at each chunk's start and m_loc,
    den (BH, S), all f32."""
    h, aux = mlstm_chunks(q, k, v, log_i, log_f, chunk)
    return h.to(q.dtype), aux


def mlstm_bwd_ref(q, k, v, log_i, log_f, h, dh, aux, chunk: int):
    """(dq, dk, dv, dlog_i, dlog_f), all f32, for the upstream gradient
    dh of h = mlstm_fwd(...): the kernels' algebra, one chunk at a time
    from the last, carrying dC (K x K) and dn (K) backward."""
    C_st, n_st, m_st, m_loc, den = aux
    bh, s, kd = q.shape
    scale = kd ** -0.5
    dev = q.device
    tri = tril_ones(chunk, dev)
    mask = tri.bool()
    dC = torch.zeros(bh, kd, kd, device=dev)
    dn = torch.zeros(bh, kd, device=dev)
    carry = torch.zeros(bh, device=dev)       # sum of dF over later chunks
    dq, dk, dv, dli, dlf = ([None] * (s // chunk) for _ in range(5))
    for c in range(s // chunk - 1, -1, -1):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        hc, dhc = h[:, sl].float(), dh[:, sl].float()
        li, lf = log_i[:, sl].float(), log_f[:, sl].float()
        C, n, m = C_st[:, c], n_st[:, c], m_st[:, c]
        ml, dc = m_loc[:, sl], den[:, sl]
        F = lf @ tri.T
        Ftot = F[:, -1]
        scale_s = li + Ftot[:, None] - F
        m_new = torch.maximum(m + Ftot, scale_s.amax(-1))
        w_s = torch.exp(scale_s - m_new[:, None])
        decay = torch.exp(m + Ftot - m_new)
        c_int = torch.exp(m[:, None] + F - ml)
        floor = torch.exp(-ml)
        denom = torch.maximum(dc.abs(), floor)
        W = F[:, :, None] - F[:, None, :] + li[:, None, :]
        A = torch.where(mask, torch.exp(W - ml[..., None]),
                        torch.zeros_like(W))
        dnum = dhc / denom[..., None]
        dden = torch.where(dc.abs() > floor,
                           -torch.sign(dc) * (dhc * hc).sum(-1) / denom,
                           torch.zeros_like(dc))
        qs = qc * scale
        qk = (qc @ kc.transpose(1, 2)) * scale
        dP = A * (dnum @ vc.transpose(1, 2) + dden[..., None])
        dqs = c_int[..., None] * (dnum @ C.transpose(1, 2)
                                  + dden[..., None] * n[:, None]) + dP @ kc
        dk[c] = w_s[..., None] * (vc @ dC.transpose(1, 2) + dn[:, None]) \
            + dP.transpose(1, 2) @ qs
        dv[c] = w_s[..., None] * (kc @ dC) + (A * qk).transpose(1, 2) @ dnum
        cq = c_int[..., None] * qs
        dC = decay[:, None, None] * dC + cq.transpose(1, 2) @ dnum
        dn = decay[:, None] * dn + (dden[..., None] * cq).sum(1)
        dq[c] = dqs * scale
        dli[c] = (kc * dk[c]).sum(-1)
        dF = (qc * dq[c]).sum(-1) - dli[c]
        dlf[c] = carry[:, None] + dF @ tri          # sum over j >= t
        carry = carry + dF.sum(-1)
    return tuple(torch.cat(x, 1) for x in (dq, dk, dv, dli, dlf))


# -------------------------------------------------------------- wrappers
def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def mlstm_fwd(q, k, v, log_i, log_f, chunk: int, with_aux: bool = True):
    """(h in q's dtype, aux or None): the `mlstm_fwd` kernel for CUDA
    tensors, the plain version for CPU tensors. aux (what the backward
    needs, see mlstm_fwd_ref) is written only with `with_aux`."""
    _check(q, k, v, log_i, log_f, chunk)
    if q.device.type == "cpu":
        h, aux = mlstm_fwd_ref(q, k, v, log_i, log_f, chunk)
        return h, (aux if with_aux else None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    li, lf = log_i.float().contiguous(), log_f.float().contiguous()
    bh, s, kd = q.shape
    nc = s // chunk
    h = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    aux, ptrs = None, [0] * 5
    if with_aux:
        aux = (torch.empty(bh, nc, kd, kd, **f32),
               torch.empty(bh, nc, kd, **f32), torch.empty(bh, nc, **f32),
               torch.empty(bh, s, **f32), torch.empty(bh, s, **f32))
        ptrs = _ptrs(*aux)
    launch("mlstm_fwd", *_ptrs(q, k, v, li, lf, h), *ptrs, bh, s, kd, chunk,
           _DTYPE_CODE[q.dtype], kd ** -0.5, device=q.device)
    return h, aux


def mlstm_bwd(q, k, v, log_i, log_f, h, dh, aux, chunk: int):
    """(dq, dk, dv, dlog_i, dlog_f), all f32, for the upstream gradient
    dh (taken in h's dtype) of (h, aux) = mlstm_fwd(...): the
    `mlstm_bwd_dqdk` and then the `mlstm_bwd_dv` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(q, k, v, log_i, log_f, chunk)
    if h.shape != q.shape or dh.shape != q.shape or h.dtype != q.dtype:
        raise ValueError(f"h and dh must be {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(h.shape)} {h.dtype}, "
                         f"{tuple(dh.shape)}")
    dh = dh.to(h.dtype)
    if q.device.type == "cpu":
        return mlstm_bwd_ref(q, k, v, log_i, log_f, h, dh, aux, chunk)
    q, k, v, h, dh = (t.contiguous() for t in (q, k, v, h, dh))
    li, lf = log_i.float().contiguous(), log_f.float().contiguous()
    aux = tuple(t.contiguous() for t in aux)
    bh, s, kd = q.shape
    dq, dk, dv = (torch.empty(bh, s, kd, dtype=torch.float32,
                              device=q.device) for _ in range(3))
    dli, dlf = (torch.empty(bh, s, dtype=torch.float32, device=q.device)
                for _ in range(2))
    dims = (bh, s, kd, chunk, _DTYPE_CODE[q.dtype], kd ** -0.5)
    _, _, m_st, m_loc, den = aux
    launch("mlstm_bwd_dqdk", *_ptrs(q, k, v, li, lf, h, dh, *aux, dq, dk),
           *dims, device=q.device)
    launch("mlstm_bwd_dv", *_ptrs(q, k, li, lf, h, dh, m_st, m_loc, den, dq,
                                  dk, dv, dli, dlf), *dims, device=q.device)
    return dq, dk, dv, dli, dlf


class MLSTMChunkwise(torch.autograd.Function):
    """The chunkwise mLSTM whose forward and backward are the wrappers
    above; the forward keeps its per-chunk states for the backward only
    when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, chunk):
        grad = any(ctx.needs_input_grad[:5])
        h, aux = mlstm_fwd(q, k, v, log_i, log_f, chunk, with_aux=grad)
        ctx.chunk = chunk
        if grad:
            ctx.save_for_backward(q, k, v, log_i, log_f, h, *aux)
        return h

    @staticmethod
    def backward(ctx, dh):
        q, k, v, log_i, log_f, h, *aux = ctx.saved_tensors
        grads = mlstm_bwd(q, k, v, log_i, log_f, h, dh, aux, ctx.chunk)
        ins = (q, k, v, log_i, log_f)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, ins, ctx.needs_input_grad)) + (None,)


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int = 64):
    """q, k, v: (BH, S, K); log_i, log_f: (BH, S) -> h (BH, S, K) in q's
    dtype, from the zero state. Differentiable."""
    return MLSTMChunkwise.apply(q, k, v, log_i, log_f, chunk)
