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

Under a mesh, `adam_update_sharded_` is ZeRO-1's form of it: each
rank's m, v and master are its block of the optimizer's shardings
(`opt_shardings`: the parameter's tensor-parallel split, and the first
undivided dimension that the data extent divides split over the data
axes, `zero1_pspec`); the gradients are summed over the data axes into
those blocks, updated with the same arithmetic, and the new parameter
blocks gathered back over the data axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.models.shardings import (DP_AXES, NamedSharding,
                                          axis_size, entry_axes, gather_dim,
                                          group, local_block, mesh_axes,
                                          reduce_scatter_dim)
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
        g = flat_g[i]
        flat_g[i] = None
        out_dt = p.dtype if param_dtype is None else param_dtype
        if out_dt != p.dtype:
            p = torch.empty(p.shape, dtype=out_dt, device=p.device)
        _update_leaf_(cfg, g, m, v, ma, p, scale, lr, b1c, b2c)
        del g
        new_p.append(p)
    opt_state["step"] = step
    return tdef.unflatten(new_p), {"grad_norm": gnorm, "lr": lr}


def _update_leaf_(cfg, g, m, v, ma, p, scale, lr, b1c, b2c) -> None:
    """One leaf's moments, master and parameter (in p's dtype) written in
    place, a slice at a time."""
    g = g.reshape(-1)
    mf, vf, maf, pf = (t.view(-1) for t in (m, v, ma, p))
    for lo in range(0, g.numel(), INPLACE_CHUNK):
        sl = slice(lo, lo + INPLACE_CHUNK)
        nm, nv, nma = _moments(cfg, g[sl].float() * scale, mf[sl], vf[sl],
                               maf[sl], lr, b1c, b2c)
        mf[sl], vf[sl], maf[sl] = nm, nv, nma
        pf[sl] = nma.to(p.dtype)


# -------------------------------------------------- ZeRO-1 sharding rule
def zero1_pspec(pspec: tuple, shape, mesh) -> tuple:
    """Extend a param spec with DP sharding on the first unsharded dim
    divisible by the DP extent (ZeRO-1)."""
    sizes = dict(zip(mesh_axes(mesh), mesh.shape))
    dp_axes = tuple(a for a in DP_AXES if a in sizes)
    if not dp_axes:
        return tuple(pspec)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    used = {a for e in entries for a in entry_axes(e)}
    if used & set(dp_axes):          # already DP-sharded (e.g. FSDP)
        return tuple(entries)
    for cand in (dp_axes, dp_axes[-1:]):       # full DP, else 'data' only
        dp = 1
        for a in cand:
            dp *= sizes[a]
        for i, (e, s) in enumerate(zip(entries, shape)):
            if e is None and s % dp == 0 and s >= dp:
                entries[i] = cand if len(cand) > 1 else cand[0]
                return tuple(entries)
    return tuple(entries)


def opt_shardings(param_specs, param_shardings, mesh) -> dict:
    """Shardings tree for init_opt_state's output.

    param_specs: tree of ShapeDtype; param_shardings: the matching tree
    of NamedSharding."""
    z1 = tree_map(
        lambda spec, sh: NamedSharding(
            mesh, zero1_pspec(sh.spec, spec.shape, mesh)),
        param_specs, param_shardings)
    return {"m": z1, "v": z1, "master": z1,
            "step": NamedSharding(mesh, ())}


def dp_split(sh: NamedSharding):
    """(dim, axes): the dimension a sharding splits over data axes and
    those axes, or (None, ())."""
    for i, e in enumerate(sh.spec):
        axes = tuple(a for a in entry_axes(e) if a in DP_AXES)
        if axes:
            return i, axes
    return None, ()


def reduce_grad(g, sh: NamedSharding):
    """The gradient of one rank's rows summed over the data axes, in
    f32, kept as this rank's block of `sh`'s data split. With one data
    rank there is nothing to sum, and g is returned as it is: the update
    widens it a slice at a time, so the f32 copies of every gradient are
    never held at once."""
    mesh = sh.mesh
    if axis_size(mesh, "batch") == 1:
        return g
    g = g.float()
    dim, used = dp_split(sh)
    rest = group(mesh, [a for a in DP_AXES if a not in used])
    if rest is not None:
        g = g.contiguous()
        dist.all_reduce(g, group=rest)
    if used:
        g = reduce_scatter_dim(g, dim, group(mesh, used))
    return g


def data_block(x, sh: NamedSharding):
    """An own copy of this rank's block of `sh`'s data split of x, a
    tensor whole over the data axes (x itself where it splits nothing
    over data)."""
    dim, used = dp_split(sh)
    if not used:
        return x
    spec = tuple(used if i == dim else None for i in range(x.dim()))
    return local_block(x, spec, sh.mesh).clone()


def gather_over_data(x, sh: NamedSharding):
    """The whole of `sh`'s data split from every data rank's block (x
    itself where it splits nothing over data)."""
    dim, used = dp_split(sh)
    return gather_dim(x, dim, group(sh.mesh, used)) if used else x


def _square_sum(g):
    """sum(g²) in f32, the bits of global_norm's term: the f32 copy of a
    gradient in another dtype is squared in place, so a leaf costs one
    f32 temporary, not two."""
    x = g.float()
    return torch.sum(torch.square(x) if x is g else x.square_())


@torch.no_grad()
def adam_update_sharded_(params, grads, opt_state: dict, cfg: AdamCfg,
                         param_shardings: list, opt_shardings_: list,
                         param_dtype=torch.bfloat16):
    """ZeRO-1 AdamW in place under a mesh; returns (params, stats).

    params: the rank's blocks of the parameters (of `param_shardings`,
    one NamedSharding per leaf in leaf order); grads: a list of the
    gradients of the parameters as the forward used them (each whole
    over the data axes, from this rank's rows), consumed; opt_state:
    the rank's blocks of m, v and master (of `opt_shardings_`). The
    gradients are summed over the data axes into the optimizer's
    blocks, the norm is taken over every rank's blocks (each counted
    once), and each new parameter block is gathered over the data axes
    where the parameter is not split over them. With one rank the
    arithmetic is adam_update_'s, in the same order."""
    flat_p, tdef = tree_flatten(params)
    step = opt_state["step"] + 1
    shards, partials = [], []
    for i, sh in enumerate(opt_shardings_):
        g = reduce_grad(grads[i], sh)
        grads[i] = None
        part = _square_sum(g)
        shards.append(g)
        partials.append(part / sh.copies() if sh.copies() > 1 else part)
    total = sum(partials)
    dist.all_reduce(total)
    gnorm = torch.sqrt(total)
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
        g = shards[i]
        shards[i] = None
        out_dt = p.dtype if param_dtype is None else param_dtype
        psh = param_shardings[i]
        if dp_split(psh)[1]:           # the parameter is the block (FSDP)
            if out_dt != p.dtype:
                p = torch.empty(p.shape, dtype=out_dt, device=p.device)
            _update_leaf_(cfg, g, m, v, ma, p, scale, lr, b1c, b2c)
        else:
            blk = torch.empty(m.shape, dtype=out_dt, device=m.device)
            _update_leaf_(cfg, g, m, v, ma, blk, scale, lr, b1c, b2c)
            blk = gather_over_data(blk, opt_shardings_[i])
            if out_dt == p.dtype:
                p.copy_(blk)
            else:
                p = blk
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
