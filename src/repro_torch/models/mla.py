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

Decode caches only the latent c_kv and the rotary key per position
(`init_mla_cache`) and absorbs `w_uk` into the query and `w_uv` into
the output (`decode_mla`), in f32 as in the reference. Under a mesh
the latent cache is whole on every `model` rank (the reference's axes
split it over `batch` only), and each rank runs the absorbed decode on
its heads.

`mla_axes` names its weights' logical axes. Under a mesh each `model`
rank holds its heads of `w_q` (or `w_uq`), `w_uk`, `w_uv` and `w_o`;
`w_dkv`, `kv_ln` (and `w_dq`, `q_ln`) are whole on every rank. The
tensors that the rank's products share (the query input, the normalised
latent c_kv and the rotary key) enter the tensor-parallel region there,
so the replicated leaves' gradients are whole on every rank, and the
output projection's partial sums are added over `model`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import blocks
from repro_torch.models.shardings import from_model, to_model


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


def mla_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_mla's structure."""
    a = {
        "w_dkv": (None, None),
        "kv_ln": (None,),
        "w_uk": (None, "heads", None),
        "w_uv": (None, "heads", None),
        "w_o": ("heads", None, None),
    }
    if cfg.mla.q_lora_rank:
        a.update(w_dq=(None, None), q_ln=(None,),
                 w_uq=(None, "heads", None))
    else:
        a["w_q"] = (None, "heads", None)
    return a


def _rmsnorm(x, g, eps=1e-6):
    """MLA's own RMSNorm: the normalised f32 product rounded to x's
    dtype, then times g (blocks.rmsnorm multiplies in x's dtype)."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            ).to(x.dtype) * g


def _queries(p, x, positions, m, theta, mesh=None):
    """(q_nope, q_rope) (B, S, H, .), q_rope rotated; under `mesh` the
    rank's heads."""
    if "w_dq" in p:
        q = to_model(_rmsnorm(blocks.matmul(x, p["w_dq"]), p["q_ln"]), mesh)
        q = blocks.einsum("bsr,rhk->bshk", q, p["w_uq"])
    else:
        q = blocks.einsum("bsd,dhk->bshk", to_model(x, mesh), p["w_q"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, att.rope(q_rope, positions, theta)


def apply_mla(p: dict, x, positions, cfg: ArchConfig,
              impl="chunked", mesh=None):
    """Train/prefill path. x: (B, S, D); positions: (B, S). Under
    `mesh`, p holds the rank's heads (see the module's docstring)."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _queries(p, x, positions, m, cfg.rope_theta, mesh)
    ckv = blocks.matmul(x, p["w_dkv"])
    c_kv = to_model(_rmsnorm(ckv[..., :m.kv_lora_rank], p["kv_ln"]), mesh)
    k_rope = to_model(att.rope(ckv[..., None, m.kv_lora_rank:], positions,
                               cfg.rope_theta), mesh)      # (B,S,1,rope)
    k_nope = blocks.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = blocks.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    # one rotary key for every head of the rank: expanded, so its
    # gradient sums over the heads
    k_rope_b = k_rope.expand(B, S, k_nope.shape[2], m.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b], -1)
    # MLA is MHA (one kv per q head): N = h, G = 1
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    out = att.attend(q[:, :, :, None, :], k, v, positions, positions,
                     causal=True, impl=impl, scale=scale)[:, :, :, 0, :]
    return from_model(blocks.einsum("bshk,hkd->bsd", out, p["w_o"]), mesh)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu") -> dict:
    m = cfg.mla
    zeros = lambda w: torch.zeros((batch, max_len, w), dtype=dtype,
                                  device=device)
    return {"ckv": zeros(m.kv_lora_rank), "k_rope": zeros(m.qk_rope_dim),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_mla(p: dict, x, cache: dict, cfg: ArchConfig, mesh=None):
    """Absorbed decode: the scores are taken against the latent cache
    directly. x: (B, 1, D). The new latent and rotary key are written in
    place at slot min(pos, T - 1) (dynamic_update_slice clamps its start
    so in the reference); the returned dict holds them and pos + 1.
    Slots after pos are masked, and zeroed so that one never written adds
    nothing whatever its buffer holds. Under `mesh`, p holds the rank's
    heads and x and the cache its rows; every `model` rank writes the
    same latent, and `w_o`'s partial sums are added over `model`."""
    m = cfg.mla
    B = x.shape[0]
    pos = cache["pos"]
    positions = pos.expand(B, 1)
    q_nope, q_rope = _queries(p, x, positions, m, cfg.rope_theta, mesh)

    ckv_new = blocks.matmul(x, p["w_dkv"])
    c_kv_new = _rmsnorm(ckv_new[..., :m.kv_lora_rank], p["kv_ln"])
    k_rope_new = att.rope(ckv_new[..., None, m.kv_lora_rank:], positions,
                          cfg.rope_theta)[:, :, 0, :]
    T = cache["ckv"].shape[1]
    idx = torch.clamp(pos, max=T - 1).reshape(1).long()
    att.write_slot(cache["ckv"], idx, c_kv_new)
    att.write_slot(cache["k_rope"], idx, k_rope_new)
    cache = dict(cache, pos=pos + 1)
    valid = torch.arange(T, device=x.device) <= pos            # (T,)
    ckv = torch.where(valid[:, None], cache["ckv"].float(), 0.0)
    k_rope = torch.where(valid[:, None], cache["k_rope"].float(), 0.0)
    # absorb W_uk: q_lat = q_nope W_uk, scored against c_kv directly
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                         p["w_uk"].float())
    logits = torch.einsum("bshr,btr->bhst", q_lat, ckv)
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                   k_rope)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    logits = torch.where(valid, logits * scale, att.NEG_INF)
    pr = torch.softmax(logits, -1)
    o_lat = torch.einsum("bhst,btr->bshr", pr, ckv)            # (B,1,h,R)
    out = torch.einsum("bshr,rhk->bshk", o_lat,
                       p["w_uv"].float()).to(x.dtype)
    return from_model(blocks.einsum("bshk,hkd->bsd", out, p["w_o"]),
                      mesh), cache
