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

`mlstm_fwd` and `mlstm_bwd_dqdk` each run as passes: only the state
recurrence walks the chunks in order (the forward's C and n, the
backward's dC and dn), and everything else runs every chunk at once
from the states stored per chunk. The plain versions of those passes
(`mlstm_fwd_states_ref`, `mlstm_fwd_out_ref`, `mlstm_bwd_dC_ref`,
`mlstm_bwd_dqdk_ref`) hold that algebra against the one-pass plain
versions in the tests.

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
from repro_torch.kernels.ref import NEG, mlstm_chunks, tril_ones

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64            # the kernels' column tile; K must be a multiple
MAX_K = 512          # C's column tile (K x 64 f32) fits shared memory
MAX_CHUNK = 64
WS_ROWS = 8          # mlstm_fwd's and mlstm_bwd_dqdk's workspace: (8, BH, S)

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


# ------------------------------------- plain versions of the kernels' passes
def _gates(log_i, log_f, chunk: int):
    """log_i, F (the inclusive cumsum of log_f within each chunk) and
    scale_s = log_i + Ftot - F, each (BH, nc, L) f32."""
    bh, s = log_i.shape
    tri = tril_ones(chunk, log_i.device)
    li = log_i.float().reshape(bh, s // chunk, chunk)
    F = log_f.float().reshape(bh, s // chunk, chunk) @ tri.T
    return li, F, li + F[..., -1:] - F


def _per_chunk(*ts, chunk: int):
    """Each (BH, S, K) tensor as (BH, nc, L, K) f32."""
    return tuple(t.float().reshape(t.shape[0], -1, chunk, t.shape[-1])
                 for t in ts)


def mlstm_fwd_states_ref(k, v, log_i, log_f, chunk: int):
    """The forward's state pass: the (C, n, m) state at each chunk's
    start, (BH, nc, K, K), (BH, nc, K) and (BH, nc) f32, walking the
    chunks in order from the zero state. The only serial part of
    `mlstm_fwd`."""
    bh, s, kd = k.shape
    kc, vc = _per_chunk(k, v, chunk=chunk)
    _, F, scale_s = _gates(log_i, log_f, chunk)
    Ftot, top = F[..., -1], scale_s.amax(-1)
    C = torch.zeros(bh, kd, kd, device=k.device)
    n = torch.zeros(bh, kd, device=k.device)
    m = torch.full((bh,), NEG, device=k.device)
    Cs, ns, ms = [], [], []
    for c in range(s // chunk):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        m_new = torch.maximum(m + Ftot[:, c], top[:, c])
        wk = torch.exp(scale_s[:, c] - m_new[:, None])[..., None] * kc[:, c]
        decay = torch.exp(m + Ftot[:, c] - m_new)
        C = decay[:, None, None] * C + wk.transpose(1, 2) @ vc[:, c]
        n = decay[:, None] * n + wk.sum(1)
        m = m_new
    return torch.stack(Cs, 1), torch.stack(ns, 1), torch.stack(ms, 1)


def mlstm_fwd_out_ref(q, k, v, log_i, log_f, C_st, n_st, m_st, chunk: int):
    """The forward's output pass, every chunk at once from the states at
    each chunk's start: (h in q's dtype, m_loc, den (BH, S) f32)."""
    bh, s, kd = q.shape
    scale = kd ** -0.5
    qc, kc, vc = _per_chunk(q, k, v, chunk=chunk)
    li, F, _ = _gates(log_i, log_f, chunk)
    W = F[..., :, None] - F[..., None, :] + li[..., None, :]
    W = torch.where(tril_ones(chunk, q.device).bool(), W,
                    torch.full_like(W, NEG))
    g = m_st[..., None] + F
    m_loc = torch.maximum(g, W.amax(-1))
    c_int = torch.exp(g - m_loc)
    P = torch.exp(W - m_loc[..., None]) * \
        ((qc @ kc.transpose(-1, -2)) * scale)
    qs = qc * scale
    num = c_int[..., None] * (qs @ C_st) + P @ vc
    den = c_int * (qs @ n_st[..., None])[..., 0] + P.sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_loc))[..., None]
    return (h.reshape(bh, s, kd).to(q.dtype), m_loc.reshape(bh, s),
            den.reshape(bh, s))


def _bwd_rows(log_i, log_f, h, dh, aux, chunk: int):
    """What both backward passes read, (BH, nc, L) f32 unless said: the
    decay matrix A (BH, nc, L, L), c_int, w_s, the denominator max(|den|,
    exp(-m_loc)), dden (the gradient of den, zero where the floor wins)
    and each chunk's decay (BH, nc)."""
    _, _, m_st, m_loc, den = aux
    bh, s = log_i.shape
    li, F, scale_s = _gates(log_i, log_f, chunk)
    ml, dc = (x.reshape(bh, s // chunk, chunk) for x in (m_loc, den))
    Ftot = F[..., -1]
    m_new = torch.maximum(m_st + Ftot, scale_s.amax(-1))
    W = F[..., :, None] - F[..., None, :] + li[..., None, :]
    A = torch.where(tril_ones(chunk, li.device).bool(),
                    torch.exp(W - ml[..., None]), torch.zeros_like(W))
    floor = torch.exp(-ml)
    denom = torch.maximum(dc.abs(), floor)
    hd = (dh.float() * h.float()).sum(-1).reshape(dc.shape)
    dden = torch.where(dc.abs() > floor, -torch.sign(dc) * hd / denom,
                       torch.zeros_like(dc))
    return (A, torch.exp(m_st[..., None] + F - ml),
            torch.exp(scale_s - m_new[..., None]), denom, dden,
            torch.exp(m_st + Ftot - m_new))


def mlstm_bwd_dC_ref(q, log_i, log_f, h, dh, aux, chunk: int):
    """The backward's reverse pass: the gradient of the state at each
    chunk's end, dC (BH, nc, K, K) and dn (BH, nc, K) f32 (zero after the
    last chunk), walking the chunks from the last. The only serial part
    of `mlstm_bwd_dqdk`; its kernel writes these as its workspace."""
    bh, s, kd = q.shape
    nc = s // chunk
    _, c_int, _, denom, dden, decay = _bwd_rows(log_i, log_f, h, dh, aux,
                                                chunk)
    qc, dhc = _per_chunk(q, dh, chunk=chunk)
    cq = c_int[..., None] * (qc * kd ** -0.5)
    dnum = dhc / denom[..., None]
    dC = torch.zeros(bh, kd, kd, device=q.device)
    dn = torch.zeros(bh, kd, device=q.device)
    dCs, dns = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        dCs[c], dns[c] = dC, dn
        dC = decay[:, c, None, None] * dC + \
            cq[:, c].transpose(1, 2) @ dnum[:, c]
        dn = decay[:, c, None] * dn + (dden[:, c, :, None] * cq[:, c]).sum(1)
    return torch.stack(dCs, 1), torch.stack(dns, 1)


def mlstm_bwd_dqdk_ref(q, k, v, log_i, log_f, h, dh, aux, dC, dn,
                       chunk: int):
    """dq, dk (BH, S, K) f32, every chunk at once from the states at each
    chunk's start (aux) and the reverse pass's dC, dn at each chunk's
    end."""
    bh, s, kd = q.shape
    scale = kd ** -0.5
    C_st, n_st = aux[:2]
    A, c_int, w_s, denom, dden, _ = _bwd_rows(log_i, log_f, h, dh, aux,
                                              chunk)
    qc, kc, vc, dhc = _per_chunk(q, k, v, dh, chunk=chunk)
    dnum = dhc / denom[..., None]
    dP = A * (dnum @ vc.transpose(-1, -2) + dden[..., None])
    dq = (c_int[..., None] * (dnum @ C_st.transpose(-1, -2)
                              + dden[..., None] * n_st[..., None, :])
          + dP @ kc) * scale
    dk = w_s[..., None] * (vc @ dC.transpose(-1, -2) + dn[..., None, :]) \
        + dP.transpose(-1, -2) @ (qc * scale)
    return dq.reshape(bh, s, kd), dk.reshape(bh, s, kd)


# -------------------------------------------------------------- wrappers
def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _aligned(t):
    """t contiguous and starting on 16 bytes, as the kernels' cp.async
    copies need (a view into a larger tensor may not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_bwd(q, k, v, log_i, log_f, h, dh, chunk: int) -> None:
    _check(q, k, v, log_i, log_f, chunk)
    if h.shape != q.shape or dh.shape != q.shape or h.dtype != q.dtype:
        raise ValueError(f"h and dh must be {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(h.shape)} {h.dtype}, "
                         f"{tuple(dh.shape)}")


def _f32(*shape, device):
    return torch.empty(*shape, dtype=torch.float32, device=device)


def mlstm_fwd(q, k, v, log_i, log_f, chunk: int, with_aux: bool = True):
    """(h in q's dtype, aux or None): the `mlstm_fwd` kernel for CUDA
    tensors, the plain version for CPU tensors. aux (what the backward
    needs, see mlstm_fwd_ref) is returned only with `with_aux`; the
    kernel writes it either way, since its output pass reads the
    states."""
    _check(q, k, v, log_i, log_f, chunk)
    if q.device.type == "cpu":
        h, aux = mlstm_fwd_ref(q, k, v, log_i, log_f, chunk)
        return h, (aux if with_aux else None)
    q, k, v = (_aligned(t) for t in (q, k, v))
    li, lf = log_i.float().contiguous(), log_f.float().contiguous()
    bh, s, kd = q.shape
    nc, dev = s // chunk, q.device
    h = torch.empty_like(q)
    aux = (_f32(bh, nc, kd, kd, device=dev), _f32(bh, nc, kd, device=dev),
           _f32(bh, nc, device=dev), _f32(bh, s, device=dev),
           _f32(bh, s, device=dev))
    ws = _f32(WS_ROWS, bh, s, device=dev)
    launch("mlstm_fwd", *_ptrs(q, k, v, li, lf, h, *aux, ws), bh, s, kd,
           chunk, _DTYPE_CODE[q.dtype], kd ** -0.5, device=dev)
    return h, (aux if with_aux else None)


def _launch_dqdk(q, k, v, li, lf, h, dh, aux, chunk: int):
    bh, s, kd = q.shape
    dev = q.device
    dq, dk = _f32(bh, s, kd, device=dev), _f32(bh, s, kd, device=dev)
    dC = _f32(bh, s // chunk, kd, kd, device=dev)
    dn = _f32(bh, s // chunk, kd, device=dev)
    ws = _f32(WS_ROWS, bh, s, device=dev)
    launch("mlstm_bwd_dqdk", *_ptrs(q, k, v, li, lf, h, dh, *aux, dq, dk,
                                    dC, dn, ws),
           bh, s, kd, chunk, _DTYPE_CODE[q.dtype], kd ** -0.5, device=dev)
    return dq, dk, dC, dn


def mlstm_bwd_dqdk(q, k, v, log_i, log_f, h, dh, aux, chunk: int):
    """(dq, dk, dC, dn), all f32: dq and dk as `mlstm_bwd` gives them,
    and the gradient of the state at each chunk's end, dC (BH, nc, K, K)
    and dn (BH, nc, K) (see mlstm_bwd_dC_ref). The `mlstm_bwd_dqdk`
    kernel for CUDA tensors, which writes dC and dn as its workspace; the
    plain passes for CPU tensors."""
    _check_bwd(q, k, v, log_i, log_f, h, dh, chunk)
    dh = dh.to(h.dtype)
    if q.device.type == "cpu":
        dC, dn = mlstm_bwd_dC_ref(q, log_i, log_f, h, dh, aux, chunk)
        return (*mlstm_bwd_dqdk_ref(q, k, v, log_i, log_f, h, dh, aux, dC,
                                    dn, chunk), dC, dn)
    q, k, v, h, dh = (_aligned(t) for t in (q, k, v, h, dh))
    li, lf = log_i.float().contiguous(), log_f.float().contiguous()
    return _launch_dqdk(q, k, v, li, lf, h, dh,
                        tuple(_aligned(t) for t in aux), chunk)


def mlstm_bwd(q, k, v, log_i, log_f, h, dh, aux, chunk: int):
    """(dq, dk, dv, dlog_i, dlog_f), all f32, for the upstream gradient
    dh (taken in h's dtype) of (h, aux) = mlstm_fwd(...): the
    `mlstm_bwd_dqdk` and then the `mlstm_bwd_dv` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_bwd(q, k, v, log_i, log_f, h, dh, chunk)
    dh = dh.to(h.dtype)
    if q.device.type == "cpu":
        return mlstm_bwd_ref(q, k, v, log_i, log_f, h, dh, aux, chunk)
    q, k, v, h, dh = (_aligned(t) for t in (q, k, v, h, dh))
    li, lf = log_i.float().contiguous(), log_f.float().contiguous()
    aux = tuple(_aligned(t) for t in aux)
    bh, s, kd = q.shape
    dq, dk, _, _ = _launch_dqdk(q, k, v, li, lf, h, dh, aux, chunk)
    dv = _f32(bh, s, kd, device=q.device)
    dli, dlf = _f32(bh, s, device=q.device), _f32(bh, s, device=q.device)
    _, _, m_st, m_loc, den = aux
    launch("mlstm_bwd_dv", *_ptrs(q, k, li, lf, h, dh, m_st, m_loc, den, dq,
                                  dk, dv, dli, dlf),
           bh, s, kd, chunk, _DTYPE_CODE[q.dtype], kd ** -0.5,
           device=q.device)
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
