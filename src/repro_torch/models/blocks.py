"""Layer blocks (counterpart of `repro/models/blocks.py`):
- `attn`, `local_attn` and `attn_moe`: RMSNorm -> QKV + RoPE -> causal
  attention (sliding-window for `local_attn`) -> output projection, then
  RMSNorm -> SwiGLU MLP, or the MoE FFN for `attn_moe` (models/moe.py);
- `mla_moe`: RMSNorm -> multi-head latent attention (models/mla.py),
  then RMSNorm -> the MoE FFN;
- `rglru`: RMSNorm -> RG-LRU temporal mixing (models/rglru.py), then
  RMSNorm -> SwiGLU MLP;
- `mlstm` and `slstm`: RMSNorm -> the xLSTM cell with its own up and
  down projections (models/xlstm.py), then the residual;
- `enc_attn`: `attn` without the causal mask (Whisper's encoder);
- `attn_cross`: `attn`'s causal self-attention, then RMSNorm -> the
  non-causal cross-attention over the encoder's output (`cross_attn`),
  then RMSNorm -> SwiGLU MLP (Whisper's decoder).
Each decoder block type also decodes one token against its cache
(`init_block_cache`, `decode_block`): a KV cache for the attention
blocks (a ring of `attention_window` slots for `local_attn`; for
`attn_cross` beside the encoder's cross K/V, which
`backbone.setup_cross_cache` fills), MLA's latent cache, or the
recurrent cell's state.
Under a mesh (`models/shardings.py`) every block type trains on the
rank's block of its weights, split over `model` as `block_axes` says:
each rank projects to its own heads, lanes or experts (the input's
gradient summed over `model`), and the partial sums after the output
projections are added up over `model`. `attn_cross` projects the
encoder's output, which enters the decoder's tensor-parallel regions
once (`backbone.forward`), to its own kv slots. The residual stream
stays replicated where the reference splits it over the sequence
(`seq_sp`). Decoding splits the same way: each rank decodes its rows
against its block of the cache (`block_cache_axes`: its kv slots, its
lanes, or, for the mLSTM, its heads; MLA's latent cache and the
sLSTM's state are whole on every `model` rank). An unknown block type
raises ValueError, and so does a split that the block's heads do not
allow (`check_split`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.shardings import (SCALAR, axis_index, axis_size,
                                          from_model, local_extent,
                                          to_model)
from repro_torch.models.tp_padding import HeadPlan, plan_heads

ATTN_TYPES = ("attn", "local_attn", "attn_moe")
# the xLSTM block types: (init, apply, init_state) of their cell
XLSTM = {"mlstm": (xlstm_mod.init_mlstm, xlstm_mod.apply_mlstm,
                   xlstm_mod.init_mlstm_state),
         "slstm": (xlstm_mod.init_slstm, xlstm_mod.apply_slstm,
                   xlstm_mod.init_slstm_state)}


def _refuse(btype: str, decode: bool = False):
    """ValueError for an unknown block type, and with `decode` for the
    encoder's, which has no cache."""
    if btype not in ATTN_TYPES + ("enc_attn", "attn_cross", "mla_moe",
                                  "rglru") + tuple(XLSTM) or \
            (decode and btype == "enc_attn"):
        raise ValueError(btype)


def check_split(btype: str, cfg: ArchConfig, tp: int) -> None:
    """ValueError where a block of `btype` cannot split over `tp` model
    ranks: MLA and the mLSTM have no head padding, so tp must divide
    their heads (the attention blocks pad theirs, `plan_heads`)."""
    _refuse(btype)
    if btype in ("mla_moe", "mlstm") and cfg.num_heads % tp:
        raise ValueError(f"the {btype} block's {cfg.num_heads} heads do "
                         f"not split over tp {tp}")


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


MLP_AXES = {"w_gate": (None, "d_ff"), "w_up": (None, "d_ff"),
            "w_down": ("d_ff", None)}


def apply_mlp(p, x, mesh=None):
    x = to_model(x, mesh)
    gate = torch.nn.functional.silu(matmul(x, p["w_gate"]).float())
    return from_model(matmul(gate.to(x.dtype) * matmul(x, p["w_up"]),
                             p["w_down"]), mesh)


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


ATTN_AXES = {"wq": (None, "heads", None), "wk": (None, "kv_heads", None),
             "wv": (None, "kv_heads", None), "wo": ("heads", None, None)}


def _q_mask(plan: HeadPlan, dtype, device, mesh=None):
    """`plan.q_mask` of the rank's q slots: the plan's physical slots
    split evenly over `model` (each rank's q slots group onto its own kv
    slots, since slot s reads kv slot s // q_per_phys_kv). Built on the
    device from the plan's layout, each kv group's live heads first and
    then its padding, so a decode step copies nothing from the host."""
    n = plan.n_q_phys // axis_size(mesh, "heads")
    lo = axis_index(mesh, "heads") * n
    slots = torch.arange(lo, lo + n, device=device)
    return (slots % (plan.n_q_phys // plan.n_kv) <
            plan.n_q // plan.n_kv).to(dtype)


def _project_q(p, x, plan: HeadPlan, cfg, positions, mesh=None):
    """q (B, S, NKV, G, K) with RoPE at `positions`, NKV the rank's kv
    slots."""
    B, S, _ = x.shape
    q = att.rope(einsum("bsd,dhk->bshk", x, p["wq"]), positions,
                 cfg.rope_theta)
    if plan.n_q_phys > plan.n_q:     # zero padded q slots (grad-safe)
        q = q * _q_mask(plan, x.dtype, x.device, mesh)[None, None, :, None]
    return q.reshape(B, S, plan.n_kv_phys // axis_size(mesh, "kv_heads"),
                     plan.q_per_phys_kv, cfg.kq_dim)


def _project_qkv(p, x, plan: HeadPlan, cfg, positions, mesh=None):
    q = _project_q(p, x, plan, cfg, positions, mesh)
    k = att.rope(einsum("bsd,dhk->bshk", x, p["wk"]), positions,
                 cfg.rope_theta)
    return q, k, einsum("bsd,dhk->bshk", x, p["wv"])


def cross_kv(p, enc_out):
    """The encoder's keys and values for one cross-attention, (B, T, N,
    K) each (N the kv slots of `p`: under a mesh the rank's), in the
    promoted dtype of `enc_out` and the weights; no RoPE."""
    return (einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            einsum("bsd,dhk->bshk", enc_out, p["wv"]))


def _attn_out(p, out, plan: HeadPlan, x_dtype, mesh=None):
    """The output projection of the rank's heads, summed over `model`."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1, out.shape[-1])
    if plan.n_q_phys > plan.n_q:
        out = out * _q_mask(plan, out.dtype, out.device, mesh)[None, None,
                                                                :, None]
    return from_model(einsum("bshk,hkd->bsd", out.to(x_dtype), p["wo"]),
                      mesh)


def apply_attn(p, x, cfg: ArchConfig, tp: int, *, positions, causal=True,
               window=0, impl="chunked", mesh=None):
    plan = head_plan(cfg, tp)
    x = to_model(x, mesh)
    q, k, v = _project_qkv(p, x, plan, cfg, positions, mesh)
    out = att.attend(q, k, v, positions, positions, causal=causal,
                     window=window, impl=impl)
    return _attn_out(p, out, plan, x.dtype, mesh)


def cross_attn(p, x, k, v, cfg: ArchConfig, tp: int, *, positions,
               k_positions, mesh=None):
    """Cross-attention of x (B, S, D), its queries with RoPE at
    `positions`, over the encoder's keys and values k, v (B, T, N, K)
    (`cross_kv`, or the cross cache) at `k_positions` (B, T):
    non-causal, through the plain `dense_attention`, where the
    reference runs it too (impl="dense"); the kernels take one length
    for q and k. Training and decode share it; under `mesh` it runs the
    rank's heads."""
    plan = head_plan(cfg, tp)
    q = _project_q(p, to_model(x, mesh), plan, cfg, positions, mesh)
    out = att.dense_attention(q, k, v, positions, k_positions, causal=False)
    return _attn_out(p, out, plan, x.dtype, mesh)


def decode_attn(p, x, cache, cfg: ArchConfig, tp: int, *, window=0,
                ring=False, mesh=None):
    """One token, x (B, 1, D), against the KV cache; returns (y, cache).
    Under `mesh`, p and the cache hold the rank's heads and kv slots."""
    plan = head_plan(cfg, tp)
    positions = cache["pos"].expand(x.shape[0], 1)
    q, k, v = _project_qkv(p, to_model(x, mesh), plan, cfg, positions, mesh)
    cache = att.cache_update(cache, k, v, ring=ring)
    # q positions refer to the *pre-update* pos (the cache now holds it)
    out = att.decode_attend(q, cache, positions, ring=ring, window=window)
    return _attn_out(p, out, plan, x.dtype, mesh), cache


# ----------------------------------------------------------- block API
def init_block(gen, btype: str, cfg: ArchConfig, tp: int, dtype,
               device="cpu") -> dict:
    _refuse(btype)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)
    if btype in XLSTM:
        return {"ln1": ones(),
                "cell": XLSTM[btype][0](gen, cfg, dtype, device)}
    if btype == "mla_moe":
        return {"ln1": ones(),
                "mla": mla_mod.init_mla(gen, cfg, dtype, device),
                "ln2": ones(),
                "moe": moe_mod.init_moe(gen, cfg, tp, dtype, device)}
    if btype == "rglru":
        return {"ln1": ones(),
                "rnn": rglru_mod.init_rglru(gen, cfg, dtype, device),
                "ln2": ones(),
                "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}
    p = {"ln1": ones(), "attn": init_attn(gen, cfg, tp, dtype, device)}
    if btype == "attn_cross":
        p.update(lnx=ones(), xattn=init_attn(gen, cfg, tp, dtype, device))
    p["ln2"] = ones()
    if btype == "attn_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, tp, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def block_axes(btype: str, cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_block's structure."""
    _refuse(btype)
    if btype in ("attn", "local_attn", "enc_attn"):
        return {"ln1": (None,), "attn": dict(ATTN_AXES),
                "ln2": (None,), "mlp": dict(MLP_AXES)}
    if btype == "attn_moe":
        return {"ln1": (None,), "attn": dict(ATTN_AXES),
                "ln2": (None,), "moe": moe_mod.moe_axes(cfg)}
    if btype == "mla_moe":
        return {"ln1": (None,), "mla": mla_mod.mla_axes(cfg),
                "ln2": (None,), "moe": moe_mod.moe_axes(cfg)}
    if btype == "attn_cross":
        return {"ln1": (None,), "attn": dict(ATTN_AXES),
                "lnx": (None,), "xattn": dict(ATTN_AXES),
                "ln2": (None,), "mlp": dict(MLP_AXES)}
    if btype == "rglru":
        return {"ln1": (None,), "rnn": rglru_mod.rglru_axes(cfg),
                "ln2": (None,), "mlp": dict(MLP_AXES)}
    axes = {"mlstm": xlstm_mod.mlstm_axes, "slstm": xlstm_mod.slstm_axes}
    return {"ln1": (None,), "cell": axes[btype](cfg)}


def block_cache_axes(btype: str, cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring init_block_cache's structure: the
    reference's, but for the mLSTM's state, which is split over its
    heads as the cell runs them under a mesh (the reference splits C's
    and n's value lanes, `d_ff`, and keeps m whole)."""
    _refuse(btype, decode=True)
    kv = {"k": ("batch", None, "kv_heads", None),
          "v": ("batch", None, "kv_heads", None), "pos": SCALAR}
    if btype in ATTN_TYPES:
        return dict(kv)
    if btype == "mla_moe":
        return {"ckv": ("batch", None, None),
                "k_rope": ("batch", None, None), "pos": SCALAR}
    if btype == "attn_cross":
        return {"self": dict(kv),
                "cross_k": ("batch", None, "kv_heads", None),
                "cross_v": ("batch", None, "kv_heads", None)}
    if btype == "rglru":
        return {"h": ("batch", "d_ff"), "conv": ("batch", None, "d_ff")}
    if btype == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None), "m": ("batch", "heads"),
                "conv": ("batch", None, "d_ff")}
    return {"h": ("batch", None, None), "c": ("batch", None, None),
            "n": ("batch", None, None), "m": ("batch", None, None)}


def apply_block(btype: str, p: dict, x, cfg: ArchConfig, tp: int, *,
                positions=None, impl="chunked", enc_out=None,
                enc_positions=None, mesh=None):
    """Training/prefill path. Returns (x, aux_loss). `attn_cross` attends
    to `enc_out` (B, T, D), the encoder's output at `enc_positions`.
    Under `mesh`, `p` holds the rank's blocks of the weights and x its
    rows (and `enc_out` has entered the tensor-parallel region)."""
    _refuse(btype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if btype in XLSTM:
        h, _ = XLSTM[btype][1](p["cell"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                               cfg, mesh=mesh)
        return x + h, aux
    if btype == "mla_moe":
        h = mla_mod.apply_mla(p["mla"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                              positions, cfg, impl=impl, mesh=mesh)
        x = x + h
        y, aux = moe_mod.apply_moe(p["moe"],
                                   rmsnorm(x, p["ln2"], cfg.norm_eps), cfg,
                                   mesh=mesh)
        return x + y, aux
    if btype == "rglru":
        h, _ = rglru_mod.apply_rglru(p["rnn"],
                                     rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                                     mesh=mesh)
        x = x + h
        y = apply_mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), mesh)
        return x + y, aux
    window = cfg.attention_window if btype == "local_attn" else 0
    h = apply_attn(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, tp,
                   positions=positions, causal=btype != "enc_attn",
                   window=window, impl=impl, mesh=mesh)
    x = x + h
    if btype == "attn_cross":
        k, v = cross_kv(p["xattn"], enc_out)
        x = x + cross_attn(p["xattn"], rmsnorm(x, p["lnx"], cfg.norm_eps),
                           k, v, cfg, tp, positions=positions,
                           k_positions=enc_positions, mesh=mesh)
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if btype == "attn_moe":
        y, aux = moe_mod.apply_moe(p["moe"], h2, cfg, mesh=mesh)
    else:
        y = apply_mlp(p["mlp"], h2, mesh)
    return x + y, aux


def init_block_cache(btype: str, cfg: ArchConfig, batch: int, max_len: int,
                     tp: int, dtype=torch.bfloat16, device="cpu", mesh=None):
    """The block's decode cache for `batch` rows; the recurrent states are
    f32 whatever `dtype` is, as in the reference. `attn_cross`'s is
    {"self": its KV cache, "cross_k", "cross_v": (batch, encoder_seq, N,
    K)}, zeros until `backbone.setup_cross_cache` writes the encoder's.
    Under `mesh`, the rank's block of it (`block_cache_axes`), `batch`
    the rank's rows."""
    _refuse(btype, decode=True)
    if btype == "mla_moe":
        return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    if btype == "rglru":
        return rglru_mod.init_rglru_state(cfg, batch, device=device,
                                          mesh=mesh)
    if btype == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device, mesh)
    if btype == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    n_kv = local_extent(head_plan(cfg, tp).n_kv_phys, "kv_heads", mesh)
    if btype == "attn_cross":
        cross = lambda: torch.zeros((batch, cfg.encoder_seq, n_kv,
                                     cfg.kq_dim), dtype=dtype, device=device)
        return {"self": att.init_kv_cache(batch, max_len, n_kv, cfg.kq_dim,
                                          dtype, device=device),
                "cross_k": cross(), "cross_v": cross()}
    ring = btype == "local_attn"
    return att.init_kv_cache(batch, max_len, n_kv, cfg.kq_dim, dtype,
                             ring=ring,
                             window=cfg.attention_window if ring else 0,
                             device=device)


def decode_block(btype: str, p: dict, x, cache, cfg: ArchConfig, tp: int,
                 mesh=None):
    """Single-token decode. x: (B, 1, D). Returns (x, new cache). Under
    `mesh`, p and the cache hold the rank's blocks and x its rows."""
    _refuse(btype, decode=True)
    if btype in XLSTM:
        h, cache = XLSTM[btype][1](p["cell"],
                                   rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                                   state=cache, mesh=mesh)
        return x + h, cache
    if btype == "mla_moe":
        h, cache = mla_mod.decode_mla(p["mla"],
                                      rmsnorm(x, p["ln1"], cfg.norm_eps),
                                      cache, cfg, mesh)
        x = x + h
        y = moe_mod.decode_moe(p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                               cfg, mesh)
        return x + y, cache
    if btype == "rglru":
        h, cache = rglru_mod.apply_rglru(
            p["rnn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, state=cache,
            mesh=mesh)
        x = x + h
        y = apply_mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), mesh)
        return x + y, cache
    ring = btype == "local_attn"
    cross = btype == "attn_cross"
    h, self_c = decode_attn(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                            cache["self"] if cross else cache, cfg, tp,
                            ring=ring,
                            window=cfg.attention_window if ring else 0,
                            mesh=mesh)
    x = x + h
    if cross:
        cache = dict(cache, self=self_c)
        # the query's position is the one the self cache just took
        B, T = cache["cross_k"].shape[:2]
        x = x + cross_attn(
            p["xattn"], rmsnorm(x, p["lnx"], cfg.norm_eps), cache["cross_k"],
            cache["cross_v"], cfg, tp,
            positions=(self_c["pos"] - 1).expand(B, 1),
            k_positions=torch.arange(T, device=x.device)[None].expand(B, T),
            mesh=mesh)
    else:
        cache = self_c
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if btype == "attn_moe":
        y = moe_mod.decode_moe(p["moe"], h2, cfg, mesh)
    else:
        y = apply_mlp(p["mlp"], h2, mesh)
    return x + y, cache
