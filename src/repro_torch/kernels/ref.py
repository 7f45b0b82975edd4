"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch


def attention(q, k, v, causal=True, scale=None):
    """q,k,v: (BH, S, d); softmax(q k^T * scale + causal mask) v in f32,
    cast to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bsk,btk->bst", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    return torch.einsum("bst,btk->bsk", p, v.float()).to(q.dtype)


def grouped_matmul(x, w):
    """x: (E, C, D), w: (E, D, F) -> (E, C, F): per-expert products in
    f32, cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rglru_scan(a, x):
    """h_t = a_t h_{t-1} + x_t along axis 1 of (B, S, D), h_{-1} = 0: a
    sequential loop with an f32 carry, each h_t cast to x's dtype."""
    h = torch.zeros_like(x[:, 0], dtype=torch.float32)
    out = []
    for t in range(x.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        out.append(h.to(x.dtype))
    return torch.stack(out, 1)


NEG = -1e30


def tril_ones(n: int, device) -> torch.Tensor:
    """(n, n) f32 with ones where column <= row."""
    return torch.ones(n, n, device=device).tril()


def mlstm_chunks(q, k, v, log_i, log_f, chunk: int):
    """The stabilized chunkwise mLSTM over (N, S, K) / (N, S) in f32,
    S a multiple of `chunk`, from the zero state (C = 0, n = 0, m =
    -1e30).

    Returns (h (N, S, K) f32, and the per-chunk values a backward needs:
    C (N, nc, K, K), n (N, nc, K) and m (N, nc) at the start of each
    chunk, m_loc and den (N, S)).
    Inclusive cumulative sums are products with a lower-triangular ones
    matrix: torch.cumsum on a float CUDA tensor is refused in
    deterministic mode."""
    nb, s, kd = q.shape
    scale = kd ** -0.5
    dev = q.device
    C = torch.zeros(nb, kd, kd, device=dev)
    n = torch.zeros(nb, kd, device=dev)
    m = torch.full((nb,), NEG, device=dev)
    tri = tril_ones(chunk, dev)
    mask = tri.bool()
    hs, Cs, ns, ms, mlocs, dens = [], [], [], [], [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li, lf = log_i[:, sl].float(), log_f[:, sl].float()
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        F = lf @ tri.T                               # inclusive cumsum
        W = F[:, :, None] - F[:, None, :] + li[:, None, :]
        W = torch.where(mask, W, torch.full_like(W, NEG))
        g_inter = m[:, None] + F
        m_loc = torch.maximum(g_inter, W.amax(-1))
        D = torch.exp(W - m_loc[..., None])
        c_int = torch.exp(g_inter - m_loc)
        qk = (qc @ kc.transpose(1, 2)) * scale
        qs = qc * scale
        num = c_int[..., None] * (qs @ C) + (D * qk) @ vc
        den = c_int * (qs @ n[..., None])[..., 0] + (D * qk).sum(-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_loc))[..., None])
        mlocs.append(m_loc)
        dens.append(den)
        # carry to the chunk's end
        Ftot = F[:, -1]
        scale_s = li + Ftot[:, None] - F
        m_new = torch.maximum(m + Ftot, scale_s.amax(-1))
        w_s = torch.exp(scale_s - m_new[:, None])
        decay = torch.exp(m + Ftot - m_new)
        wk = w_s[..., None] * kc
        C = decay[:, None, None] * C + wk.transpose(1, 2) @ vc
        n = decay[:, None] * n + wk.sum(1)
        m = m_new
    aux = (torch.stack(Cs, 1), torch.stack(ns, 1), torch.stack(ms, 1),
           torch.cat(mlocs, 1), torch.cat(dens, 1))
    return torch.cat(hs, 1), aux


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk=64):
    """Chunkwise stabilized mLSTM from the zero state. q, k, v: (BH, S,
    K); log_i, log_f: (BH, S); S a multiple of chunk. h (BH, S, K) in
    q's dtype (f32 arithmetic)."""
    h, _ = mlstm_chunks(q, k, v, log_i, log_f, chunk)
    return h.to(q.dtype)


def mlstm_stepwise(q, k, v, log_i, log_f):
    """The exact per-step stabilized recurrence (independent of the
    chunked algebra): C_t = f' C_{t-1} + i' k_t v_t^T, n_t = f' n_{t-1} +
    i' k_t, h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t)), q scaled by
    K^-0.5."""
    bh, s, kd = q.shape
    scale = kd ** -0.5
    C = torch.zeros(bh, kd, kd, device=q.device)
    n = torch.zeros(bh, kd, device=q.device)
    m = torch.full((bh,), NEG, device=q.device)
    out = []
    for t in range(s):
        i_t, f_t = log_i[:, t].float(), log_f[:, t].float()
        kt, vt = k[:, t].float(), v[:, t].float()
        m_new = torch.maximum(f_t + m, i_t)
        ip = torch.exp(i_t - m_new)[:, None]
        fp = torch.exp(f_t + m - m_new)[:, None]
        C = fp[..., None] * C + ip[..., None] * (kt[:, :, None] * vt[:, None])
        n = fp * n + ip * kt
        qt = q[:, t].float() * scale
        num = torch.einsum("bk,bkv->bv", qt, C)
        den = torch.einsum("bk,bk->b", qt, n)
        out.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[:, None])
        m = m_new
    return torch.stack(out, 1).to(q.dtype)
