"""Multi-head Latent Attention, DeepSeek-V2's attention (counterpart of
`repro/models/mla.py`): the training and prefill path.

Keys and values come from one compressed latent c_kv (kv_lora_rank wide,
RMS-normalised) per position, decompressed per head by `w_uk` and `w_uv`;
each head's key carries qk_nope_dim decompressed columns and qk_rope_dim
rotary columns shared by all heads. So q and k are qk_nope_dim +
qk_rope_dim wide (192 in DeepSeek-V2-Lite) and v is v_head_dim wide
(128): the attention kernels take that width pair, at the scale
(qk_nope_dim + qk_rope_dim)^-0.5. Queries come from `w_q`, or through
their own latent (`w_dq`, `q_ln`, `w_uq`) when q_lora_rank > 0.

Not ported yet: the absorbed decode path over the latent cache
(`init_mla_cache`, `decode_mla`; ROADMAP Queue 1 item 10) and the mesh
axes (`mla_axes`, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import blocks


def init_mla(gen, cfg: ArchConfig, dtype=torch.bfloat16,
             device="cpu") -> dict:
    """Random init from `gen`: every weight normal * (fan-in)^-0.5 in
    `dtype`, the norms' gains ones, the reference's tree."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    nrm = lambda *s: blocks.init_normal(gen, s, s[0] ** -0.5, dtype,
                                        device)
    p = {
        "w_dkv": nrm(d, m.kv_lora_rank + m.qk_rope_dim),
        "kv_ln": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        "w_uk": nrm(m.kv_lora_rank, h, m.qk_nope_dim),
        "w_uv": nrm(m.kv_lora_rank, h, m.v_head_dim),
        "w_o": nrm(h, m.v_head_dim, d),
    }
    if m.q_lora_rank:
        p["w_dq"] = nrm(d, m.q_lora_rank)
        p["q_ln"] = torch.ones((m.q_lora_rank,), dtype=dtype, device=device)
        p["w_uq"] = nrm(m.q_lora_rank, h, qd)
    else:
        p["w_q"] = nrm(d, h, qd)
    return p


def _rmsnorm(x, g, eps=1e-6):
    """MLA's own RMSNorm: the normalised f32 product rounded to x's
    dtype, then times g (blocks.rmsnorm multiplies in x's dtype)."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            ).to(x.dtype) * g


def _queries(p, x, positions, m, theta):
    """(q_nope, q_rope) (B, S, H, .), q_rope rotated."""
    if "w_dq" in p:
        q = _rmsnorm(blocks.matmul(x, p["w_dq"]), p["q_ln"])
        q = blocks.einsum("bsr,rhk->bshk", q, p["w_uq"])
    else:
        q = blocks.einsum("bsd,dhk->bshk", x, p["w_q"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, att.rope(q_rope, positions, theta)


def apply_mla(p: dict, x, positions, cfg: ArchConfig,
              impl="chunked"):
    """Train/prefill path. x: (B, S, D); positions: (B, S)."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _queries(p, x, positions, m, cfg.rope_theta)
    ckv = blocks.matmul(x, p["w_dkv"])
    c_kv = _rmsnorm(ckv[..., :m.kv_lora_rank], p["kv_ln"])
    k_rope = att.rope(ckv[..., None, m.kv_lora_rank:], positions,
                      cfg.rope_theta)                      # (B,S,1,rope)
    k_nope = blocks.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = blocks.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    # one rotary key for every head: expanded, so its gradient sums over
    # the heads
    k_rope_b = k_rope.expand(B, S, cfg.num_heads, m.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b], -1)
    # MLA is MHA (one kv per q head): N = h, G = 1
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    out = att.attend(q[:, :, :, None, :], k, v, positions, positions,
                     causal=True, impl=impl, scale=scale)[:, :, :, 0, :]
    return blocks.einsum("bshk,hkd->bsd", out, p["w_o"])
