"""AdamW, per-leaf and fully flat (counterpart of
`repro/train/optimizer.py`).

`adam_update` and `adam_update_flat` are functional: each makes new
tensors and writes nothing in place, because the engine's DP replicas
share one bucket tuple and recorded tape entries must not change after
the fact. The flat path mirrors the per-leaf arithmetic elementwise
(same op order, same scalar schedule, per-leaf norm partials summed in
leaf order), which keeps the two paths bitwise identical.

`adam_update_` is the in-place counterpart for a caller that owns its
state (`train/step.py`, as the reference's launcher donates it): the
same arithmetic in the same order, so the same bits, written into m, v,
master and the parameters leaf after leaf, a slice at a time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _step0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_opt_state(params) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    return {
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "master": tree_map(lambda p: p.float(), params),
        "step": _step0(device),
    }


def _schedule(cfg: AdamCfg, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def _clip_scale(cfg: AdamCfg, gnorm):
    if not cfg.grad_clip:
        return 1.0
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


def _moments(cfg, g, m, v, master, lr, b1c, b2c):
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * master
    return m, v, master - lr * delta


def adam_update(grads, opt_state: dict, cfg: AdamCfg,
                param_dtype=torch.bfloat16):
    """Returns (new_params, new_opt_state, stats).

    param_dtype=None preserves each leaf's own dtype."""
    step = opt_state["step"] + 1
    flat_g, tdef = tree_flatten(grads)
    gnorm = global_norm(flat_g)
    scale = _clip_scale(cfg, gnorm)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_m = tdef.flatten_up_to(opt_state["m"])
    flat_v = tdef.flatten_up_to(opt_state["v"])
    flat_ma = tdef.flatten_up_to(opt_state["master"])
    out = [_moments(cfg, g.float() * scale, m, v, ma, lr, b1c, b2c)
           for g, m, v, ma in zip(flat_g, flat_m, flat_v, flat_ma)]
    new_master = tdef.unflatten([o[2] for o in out])
    if param_dtype is None:         # keep each leaf's own precision
        new_params = tdef.unflatten([o[2].to(g.dtype)
                                     for o, g in zip(out, flat_g)])
    else:
        new_params = tree_map(lambda x: x.to(param_dtype), new_master)
    new_state = {"m": tdef.unflatten([o[0] for o in out]),
                 "v": tdef.unflatten([o[1] for o in out]),
                 "master": new_master, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# Elements per slice of the in-place update: the temporaries of one
# slice (a few f32 copies) stay far below a large leaf's own size.
INPLACE_CHUNK = 1 << 24


@torch.no_grad()
def adam_update_(params, grads, opt_state: dict, cfg: AdamCfg,
                 param_dtype=torch.bfloat16):
    """AdamW in place; returns (params, stats).

    Writes the new m, v, master (and step) into `opt_state` and the new
    parameters into the tensors of `params` (a leaf whose dtype is not
    `param_dtype` is replaced by a new tensor in the returned tree, as
    adam_update casts it). The arithmetic is adam_update's, elementwise
    in the same order, so the results are bitwise equal to it. `grads`,
    a list in `params`' leaf order, is consumed: each gradient is
    dropped from it once used."""
    flat_p, tdef = tree_flatten(params)
    flat_g = grads
    step = opt_state["step"] + 1
    gnorm = global_norm(flat_g)
    scale = _clip_scale(cfg, gnorm)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_m = tdef.flatten_up_to(opt_state["m"])
    flat_v = tdef.flatten_up_to(opt_state["v"])
    flat_ma = tdef.flatten_up_to(opt_state["master"])
    new_p = []
    for i, (p, m, v, ma) in enumerate(zip(flat_p, flat_m, flat_v,
                                          flat_ma)):
        g = flat_g[i].reshape(-1)
        flat_g[i] = None
        out_dt = p.dtype if param_dtype is None else param_dtype
        if out_dt != p.dtype:
            p = torch.empty(p.shape, dtype=out_dt, device=p.device)
        mf, vf, maf, pf = (t.view(-1) for t in (m, v, ma, p))
        for lo in range(0, g.numel(), INPLACE_CHUNK):
            sl = slice(lo, lo + INPLACE_CHUNK)
            nm, nv, nma = _moments(cfg, g[sl].float() * scale, mf[sl],
                                   vf[sl], maf[sl], lr, b1c, b2c)
            mf[sl], vf[sl], maf[sl] = nm, nv, nma
            pf[sl] = nma.to(out_dt)
        del g
        new_p.append(p)
    opt_state["step"] = step
    return tdef.unflatten(new_p), {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------ fully-flat hot path
def init_flat_opt_state(spec, params) -> dict:
    """Flat m/v/master vectors over `spec`'s master space."""
    segs = spec.flatten(params)
    device = segs[0].device if segs else None
    master = (torch.cat([s.float() for s in segs]) if segs
              else torch.zeros((0,), dtype=torch.float32))
    return {
        "m": torch.zeros((spec.size,), dtype=torch.float32, device=device),
        "v": torch.zeros((spec.size,), dtype=torch.float32, device=device),
        "master": master,
        "step": _step0(device),
    }


def adam_update_flat(spec, grad_segs, opt_state: dict, cfg: AdamCfg):
    """AdamW over per-dtype gradient buckets; returns
    (new_param_segments, new_opt_state, stats). The norm is accumulated
    from per-leaf partials in leaf order, reshaped to the leaf shapes,
    exactly as global_norm does on the unflattened tree."""
    step = opt_state["step"] + 1
    views = [grad_segs[si][o:o + n].view(sh)
             for si, o, n, sh in spec.leaf_views()]
    gnorm = global_norm(views)
    scale = _clip_scale(cfg, gnorm)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    g = torch.cat([s.float() for s in grad_segs]) * scale
    m, v, master = _moments(cfg, g, opt_state["m"], opt_state["v"],
                            opt_state["master"], lr, b1c, b2c)
    new_segs = tuple(master[lo:hi].to(seg.dtype)
                     for seg, (lo, hi) in zip(spec.segments,
                                              spec.segment_bounds()))
    new_state = {"m": m, "v": v, "master": master, "step": step}
    return new_segs, new_state, {"grad_norm": gnorm, "lr": lr}
