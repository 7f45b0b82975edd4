"""Layer blocks (counterpart of `repro/models/blocks.py`):
- `attn`, `local_attn` and `attn_moe`: RMSNorm -> QKV + RoPE -> causal
  attention (sliding-window for `local_attn`) -> output projection, then
  RMSNorm -> SwiGLU MLP, or the MoE FFN for `attn_moe` (models/moe.py);
- `rglru`: RMSNorm -> RG-LRU temporal mixing (models/rglru.py), then
  RMSNorm -> SwiGLU MLP;
- `mlstm` and `slstm`: RMSNorm -> the xLSTM cell with its own up and
  down projections (models/xlstm.py), then the residual.
There is no mesh, so the reference's `shard()` constraints have no
counterpart. The other block types raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.tp_padding import HeadPlan, plan_heads

ATTN_TYPES = ("attn", "local_attn", "attn_moe")
# where each block type the port lacks is queued (ROADMAP.md)
_NOT_PORTED = {
    "mla_moe": "ROADMAP Queue 1 item 10 (DeepSeek-V2-Lite)",
    "attn_cross": "ROADMAP Queue 1 item 10 (Whisper)",
    "enc_attn": "ROADMAP Queue 1 item 10 (Whisper)",
}
# the xLSTM block types: (init, apply) of their cell
XLSTM = {"mlstm": (xlstm_mod.init_mlstm, xlstm_mod.apply_mlstm),
         "slstm": (xlstm_mod.init_slstm, xlstm_mod.apply_slstm)}


def _refuse(btype: str):
    if btype in _NOT_PORTED:
        raise NotImplementedError(f"block type {btype!r} is not ported "
                                  f"yet: {_NOT_PORTED[btype]}")
    if btype not in ATTN_TYPES + ("rglru",) + tuple(XLSTM):
        raise ValueError(btype)


def _promote(*ts):
    """Cast to the common dtype, as jnp.einsum and `@` promote mixed
    f32/bf16 operands (torch's matmul refuses them)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def matmul(a, b):
    a, b = _promote(a, b)
    return a @ b


def einsum(eq, a, b):
    a, b = _promote(a, b)
    return torch.einsum(eq, a, b)


def rmsnorm(x, g, eps=1e-6):
    """RMSNorm with f32 statistics and a data path in x's dtype."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return x * scale.to(x.dtype) * g


def init_normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std) \
        .to(dtype)


# ------------------------------------------------------------- dense MLP
def init_mlp(gen, d, f, dtype, device="cpu"):
    nrm = lambda *s: init_normal(gen, s, s[0] ** -0.5, dtype, device)
    return {"w_gate": nrm(d, f), "w_up": nrm(d, f), "w_down": nrm(f, d)}


def apply_mlp(p, x):
    gate = torch.nn.functional.silu(matmul(x, p["w_gate"]).float())
    return matmul(gate.to(x.dtype) * matmul(x, p["w_up"]), p["w_down"])


# -------------------------------------------------------- GQA attention
def head_plan(cfg: ArchConfig, tp: int) -> HeadPlan:
    return plan_heads(cfg.num_heads, cfg.num_kv_heads, tp)


def init_attn(gen, cfg: ArchConfig, tp: int, dtype, device="cpu") -> dict:
    plan = head_plan(cfg, tp)
    d, k = cfg.d_model, cfg.kq_dim
    nrm = lambda *s: init_normal(gen, s, s[0] ** -0.5, dtype, device)
    wq = nrm(d, plan.n_q_phys, k)
    # kv weights at the LOGICAL head count, gathered into physical slots
    wk_l, wv_l = nrm(d, plan.n_kv, k), nrm(d, plan.n_kv, k)
    kv_map = list(plan.kv_slot_to_logical)
    return {"wq": wq, "wk": wk_l[:, kv_map], "wv": wv_l[:, kv_map],
            "wo": nrm(plan.n_q_phys, k, d)}


def _q_mask(plan: HeadPlan, dtype, device):
    return torch.as_tensor(plan.q_mask, device=device).to(dtype)


def _project_qkv(p, x, plan: HeadPlan, cfg, positions):
    B, S, _ = x.shape
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    q = att.rope(q, positions, cfg.rope_theta)
    k = att.rope(k, positions, cfg.rope_theta)
    if plan.n_q_phys > plan.n_q:     # zero padded q slots (grad-safe)
        q = q * _q_mask(plan, x.dtype, x.device)[None, None, :, None]
    q = q.reshape(B, S, plan.n_kv_phys, plan.q_per_phys_kv, cfg.kq_dim)
    return q, k, v


def _attn_out(p, out, plan: HeadPlan, x_dtype):
    B, S = out.shape[:2]
    out = out.reshape(B, S, plan.n_q_phys, -1)
    if plan.n_q_phys > plan.n_q:
        out = out * _q_mask(plan, out.dtype, out.device)[None, None, :,
                                                          None]
    return einsum("bshk,hkd->bsd", out.to(x_dtype), p["wo"])


def apply_attn(p, x, cfg: ArchConfig, tp: int, *, positions, causal=True,
               window=0, impl="chunked"):
    plan = head_plan(cfg, tp)
    q, k, v = _project_qkv(p, x, plan, cfg, positions)
    out = att.attend(q, k, v, positions, positions, causal=causal,
                     window=window, impl=impl)
    return _attn_out(p, out, plan, x.dtype)


# ----------------------------------------------------------- block API
def init_block(gen, btype: str, cfg: ArchConfig, tp: int, dtype,
               device="cpu") -> dict:
    _refuse(btype)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)
    if btype in XLSTM:
        return {"ln1": ones(),
                "cell": XLSTM[btype][0](gen, cfg, dtype, device)}
    if btype == "rglru":
        return {"ln1": ones(),
                "rnn": rglru_mod.init_rglru(gen, cfg, dtype, device),
                "ln2": ones(),
                "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}
    p = {"ln1": ones(), "attn": init_attn(gen, cfg, tp, dtype, device),
         "ln2": ones()}
    if btype == "attn_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, tp, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def apply_block(btype: str, p: dict, x, cfg: ArchConfig, tp: int, *,
                positions=None, impl="chunked"):
    """Training/prefill path. Returns (x, aux_loss)."""
    _refuse(btype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if btype in XLSTM:
        h, _ = XLSTM[btype][1](p["cell"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                               cfg)
        return x + h, aux
    if btype == "rglru":
        h, _ = rglru_mod.apply_rglru(p["rnn"],
                                     rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
        x = x + h
        y = apply_mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x + y, aux
    window = cfg.attention_window if btype == "local_attn" else 0
    h = apply_attn(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, tp,
                   positions=positions, window=window, impl=impl)
    x = x + h
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if btype == "attn_moe":
        y, aux = moe_mod.apply_moe(p["moe"], h2, cfg)
    else:
        y = apply_mlp(p["mlp"], h2)
    return x + y, aux
