"""train_step / prefill_step / serve_step builders (counterpart of
`repro/train/step.py`): the programs the launcher runs, on one device
or under a mesh, and the one-token decode step that serves against a
cache; and the shardings of the training state.

The train step consumes its state, as the reference launcher's
`jax.jit(train_step, donate_argnums=(0,))` does: the Adam update writes
m, v, master and the parameters in place (`optimizer.adam_update_`),
so the old and the new optimizer state never exist at once.

Under a mesh (`launch/mesh.py`) every rank holds its blocks of the
state as `state_shardings` splits it: the parameters split over
`model` as `backbone.param_axes` says (and over the data axes too with
`fsdp`), m, v and master further split over the data axes (ZeRO-1,
`optimizer.zero1_pspec`). Each rank takes its rows of the global batch;
the gradients are summed over the data axes and the loss is the mean
over the global batch. The prefill and serve steps take the global
batch too and give the rank's rows of the logits, its vocab block; the
serve step decodes against the rank's block of the cache
(`cache_shardings`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import deterministic_cuda, resolve_device
from repro_torch.models import backbone
from repro_torch.models.shardings import (NamedSharding, axis_size,
                                          map_axes, resolve, shard,
                                          sum_over_batch)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import ShapeDtype, shape_dtype, tree_flatten, tree_map


@dataclass(frozen=True)
class RunCfg:
    remat: bool = True
    adam: AdamCfg = field(default_factory=AdamCfg)
    param_dtype: Any = torch.bfloat16
    # gradient-accumulation microbatches per step (1 = off): divides
    # activation memory by this factor at unchanged math (grads are
    # accumulated in f32)
    grad_accum: int = 1
    seed: int = 0


def default_run_cfg() -> RunCfg:
    return RunCfg(grad_accum=int(os.environ.get("REPRO_GRAD_ACCUM", "1")))


# ------------------------------------------------------------ shardings
def _tp(mesh) -> int:
    return axis_size(mesh, "heads")


def shardings_from_axes(axes_tree, mesh):
    return map_axes(lambda ax: NamedSharding(mesh, resolve(ax, mesh)),
                    axes_tree)


def param_shardings(cfg: ArchConfig, mesh, fsdp: Optional[bool] = None):
    """TP shardings from the model's logical axes; with fsdp=True (or
    REPRO_FSDP=1) each param additionally shards its first divisible
    unsharded dim over the DP axes (ZeRO-3/FSDP: the train step gathers
    each parameter over the data axes before the forward)."""
    if fsdp is None:
        fsdp = os.environ.get("REPRO_FSDP", "0") == "1"
    sh = shardings_from_axes(backbone.param_axes(cfg), mesh)
    if not fsdp:
        return sh
    return tree_map(
        lambda spec, s: NamedSharding(
            mesh, opt_mod.zero1_pspec(s.spec, spec.shape, mesh)),
        param_specs(cfg, mesh), sh)


def param_specs(cfg: ArchConfig, mesh=None):
    """Shapes and dtypes of the whole parameters in the mesh's layout."""
    return shape_dtype(backbone.init_params(cfg, None, tp=_tp(mesh),
                                            device="meta"))


def batch_shardings(cfg: ArchConfig, shape: ShapeCfg, mesh) -> dict:
    sh = {"tokens": NamedSharding(mesh, resolve(("batch", None), mesh))}
    for key, front in (("patches", "vision_patches"),
                       ("frames", "audio_frames")):
        if cfg.frontend == front:
            sh[key] = NamedSharding(mesh,
                                    resolve(("batch", None, None), mesh))
    return sh


def batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    b, s = shape.global_batch, shape.seq_len
    spec = {"tokens": ShapeDtype((b, s), torch.int32)}
    if cfg.frontend == "vision_patches":
        spec["patches"] = ShapeDtype((b, cfg.num_patches, cfg.d_model),
                                     torch.bfloat16)
    if cfg.frontend == "audio_frames":
        spec["frames"] = ShapeDtype((b, cfg.encoder_seq, cfg.d_model),
                                    torch.bfloat16)
    return spec


def cache_specs(cfg: ArchConfig, shape: ShapeCfg, mesh=None,
                dtype=torch.bfloat16):
    """Shapes and dtypes of the whole decode cache (`shape`'s global
    batch, seq_len slots) in the mesh's tp layout."""
    return shape_dtype(backbone.init_cache(cfg, shape.global_batch,
                                           shape.seq_len, tp=_tp(mesh),
                                           dtype=dtype, device="meta"))


def cache_shardings(cfg: ArchConfig, mesh):
    """How the decode cache splits over `mesh` (mirrors init_cache): the
    reference's, but for the mLSTM's state (`blocks.block_cache_axes`)."""
    return shardings_from_axes(backbone.stack_cache_axes(cfg), mesh)


def state_shardings(cfg: ArchConfig, mesh) -> dict:
    psh = param_shardings(cfg, mesh)
    pspec = param_specs(cfg, mesh)
    return {"params": psh,
            "opt": opt_mod.opt_shardings(pspec, psh, mesh)}


def state_specs(cfg: ArchConfig, run: "RunCfg", mesh=None) -> dict:
    pspec = param_specs(cfg, mesh)
    f32 = lambda s: ShapeDtype(s.shape, torch.float32)
    return {
        "params": pspec,
        "opt": {"m": tree_map(f32, pspec), "v": tree_map(f32, pspec),
                "master": tree_map(f32, pspec),
                "step": ShapeDtype((), torch.int32)},
    }


def _fresh(x, device):
    """An own copy of x on `device` (a block never keeps its whole)."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    return out.copy_(x)


def shard_state(state, cfg: ArchConfig, mesh, device) -> dict:
    """The rank's blocks on `device` of a whole state (a checkpoint's),
    as `state_shardings` splits it on `mesh`; the checkpoint's layout
    (padded heads and vocab) must be the mesh's."""
    want = param_specs(cfg, mesh)
    got = shape_dtype(state["params"])
    if tree_map(lambda s: s.shape, got) != tree_map(lambda s: s.shape, want):
        raise ValueError(f"the checkpoint's parameter layout is not tp "
                         f"{_tp(mesh)}'s ({cfg.name})")
    sh = state_shardings(cfg, mesh)
    return tree_map(lambda x, s: _fresh(s.local(x), device), state, sh)


def gather_state(state, cfg: ArchConfig, mesh):
    """The whole state on the host of rank 0 (None on the other ranks),
    gathered leaf by leaf; every rank of the mesh calls it."""
    rank0 = dist.get_rank() == 0
    leaves, tdef = tree_flatten(state)
    out = []
    for x, sh in zip(leaves, tdef.flatten_up_to(state_shardings(cfg,
                                                                mesh))):
        w = sh.whole(x)
        out.append(w.cpu() if rank0 else None)
        del w
    return tdef.unflatten(out) if rank0 else None


def _device(device, who: str) -> torch.device:
    dev = resolve_device(device, who)
    if dev.type == "cuda":
        deterministic_cuda()
    return dev


def _layout(cfg: ArchConfig, mesh, tp: Optional[int]) -> int:
    """The tp of a step builder: the mesh's model extent (a `tp` other
    than it raises), or `tp` with no mesh (default 1)."""
    if mesh is not None and tp not in (None, _tp(mesh)):
        raise ValueError(f"tp {tp} is not the mesh's model extent")
    tp = _tp(mesh) if tp is None else tp
    backbone.check_mesh(cfg, tp, mesh)
    return tp


def _rows(batch: dict, mesh) -> dict:
    """The rank's rows of every tensor of a batch of the global batch."""
    if mesh is None:
        return batch
    return {k: shard(v, ("batch",) + (None,) * (v.dim() - 1), mesh)
            for k, v in batch.items()}


def _forward_kwargs(cfg: ArchConfig, batch: dict) -> dict:
    """The frontend's stub embeddings, as forward takes them."""
    key = {"vision_patches": "patches",
           "audio_frames": "frames"}.get(cfg.frontend)
    return {key: batch[key]} if key else {}


# ------------------------------------------------------------ train step
def check_rows(batch: int, grad_accum: int, mesh) -> None:
    """Raise unless `grad_accum` micro-batches of equal size make the
    global batch and the data extent divides each: no row is dropped
    and every data rank holds as many rows as the next."""
    dp = axis_size(mesh, "batch")
    n = max(grad_accum, 1)
    if batch % n or (batch // n) % dp:
        raise ValueError(f"a global batch of {batch} in {n} micro-batch(es)"
                         f" does not split over {dp} data rank(s)")


def make_train_step(cfg: ArchConfig, run: RunCfg, mesh=None, *,
                    device=None, tp: Optional[int] = None):
    """train_step(state, batch) -> (state, stats) on `device` (the card
    unless the caller passes another; raises without CUDA then). `batch`
    holds numpy arrays or tensors of the global batch; they are moved to
    the device. The state passed in is updated in place and returned.

    Under `mesh` the state holds the rank's blocks (`init_state(...,
    mesh)`), the step trains on the rank's rows of each micro-batch, and
    the stats are the global batch's. Without one, `tp` picks the
    physical layout (padded heads and vocab; default 1)."""
    tp = _layout(cfg, mesh, tp)
    dev = _device(device, "make_train_step")
    if mesh is not None:
        sh = state_shardings(cfg, mesh)
        psh = tree_flatten(sh["params"])[0]
        osh = tree_flatten(sh["opt"]["m"])[0]

    def loss_fn(params, batch):
        logits, aux = backbone.forward(params, batch["tokens"], cfg, tp,
                                       mesh, remat=run.remat,
                                       **_forward_kwargs(cfg, batch))
        mask = None
        if cfg.frontend == "vision_patches":
            s = batch["tokens"].shape[1]
            mask = (torch.arange(s, device=dev)[None] >= cfg.num_patches) \
                .expand(batch["tokens"].shape)
        loss = backbone.lm_loss(logits, batch["tokens"], mask, mesh)
        return loss + aux, loss

    def value_and_grad(leaves, tdef, batch):
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            total, loss = loss_fn(tdef.unflatten(leaves), batch)
            grads = list(torch.autograd.grad(total, leaves))
        return total.detach(), loss.detach(), grads

    def train_step(state, batch):
        check_rows(batch["tokens"].shape[0], run.grad_accum, mesh)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].long()
        leaves, tdef = tree_flatten(state["params"])
        if mesh is not None:            # FSDP: the whole over data axes
            leaves = [opt_mod.gather_over_data(l, s)
                      for l, s in zip(leaves, psh)]
        n = run.grad_accum
        if n <= 1:
            total, loss, grads = value_and_grad(leaves, tdef,
                                                _rows(batch, mesh))
        else:
            grads = [torch.zeros(l.shape, dtype=torch.float32, device=dev)
                     for l in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            total = torch.zeros((), dtype=torch.float32, device=dev)
            b = batch["tokens"].shape[0]
            for i in range(n):
                mb = {k: v[i * (b // n):(i + 1) * (b // n)]
                      for k, v in batch.items()}
                t, l_, g = value_and_grad(leaves, tdef, _rows(mb, mesh))
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss, total = loss + l_, total + t
                del g
            grads = [g / n for g in grads]
            loss, total = loss / n, total / n
        del leaves
        if mesh is None:
            params, stats = opt_mod.adam_update_(state["params"], grads,
                                                 state["opt"], run.adam,
                                                 run.param_dtype)
        else:
            loss = sum_over_batch(loss, mesh)
            total = sum_over_batch(total, mesh)
            params, stats = opt_mod.adam_update_sharded_(
                state["params"], grads, state["opt"], run.adam, psh, osh,
                run.param_dtype)
        state["params"] = params
        return state, {"loss": loss, "total_loss": total, **stats}

    return train_step


def init_state(cfg: ArchConfig, run: RunCfg, seed: Optional[int] = None,
               mesh=None, *, device=None, tp: Optional[int] = None) -> dict:
    """{"params", "opt"} on `device` (the card unless the caller passes
    another), parameters drawn from a torch.Generator seeded with `seed`
    (default run.seed) on that device. Under `mesh`, the rank's blocks
    of `state_shardings` (the same model as one device's init at the
    mesh's tp); without one, `tp` picks the layout (default 1)."""
    tp = _tp(mesh) if tp is None else tp
    backbone.check_mesh(cfg, tp, mesh)
    dev = _device(device, "init_state")
    gen = torch.Generator(device=dev).manual_seed(
        run.seed if seed is None else seed)
    params = backbone.init_params(cfg, gen, tp=tp, dtype=run.param_dtype,
                                  device=dev, mesh=mesh)
    if mesh is None:
        return {"params": params, "opt": opt_mod.init_opt_state(params)}
    sh = state_shardings(cfg, mesh)
    master = tree_map(lambda p, s: opt_mod.data_block(p.float(), s),
                      params, sh["opt"]["master"])
    zeros = lambda t: torch.zeros_like(t)
    return {"params": tree_map(opt_mod.data_block, params, sh["params"]),
            "opt": {"m": tree_map(zeros, master),
                    "v": tree_map(zeros, master), "master": master,
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=dev)}}


def state_to(state, device) -> dict:
    """The state's tensors on `device` (resolved as the entry points
    resolve it)."""
    dev = _device(device, "state_to")
    return tree_map(lambda t: t.to(dev), state)


# ------------------------------------------------------------ prefill
def make_prefill_step(cfg: ArchConfig, run: RunCfg, mesh=None, *,
                      device=None, tp: Optional[int] = None):
    """prefill_step(params, batch) -> logits (B, S, V) f32, without
    gradients, on `device` (the card unless the caller passes another).

    Under `mesh`, params hold the rank's blocks, `batch` is the global
    batch (it must split evenly over the data ranks), the forward runs
    the rank's rows, and the logits are the rank's rows and its vocab
    block. Without one, `tp` picks the physical layout (default 1)."""
    tp = _layout(cfg, mesh, tp)
    dev = _device(device, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(params, batch):
        check_rows(batch["tokens"].shape[0], 1, mesh)
        batch = _rows({k: torch.as_tensor(v).to(dev)
                       for k, v in batch.items()}, mesh)
        logits, _ = backbone.forward(params, batch["tokens"].long(), cfg,
                                     tp, mesh, remat=run.remat,
                                     **_forward_kwargs(cfg, batch))
        return logits

    return prefill_step


# ------------------------------------------------------------ serve step
def make_serve_step(cfg: ArchConfig, mesh=None, *, device=None,
                    tp: Optional[int] = None):
    """serve_step(params, cache, tokens) -> (logits (B, 1, V) f32, cache):
    one decode step against the cache (`backbone.decode_step`) without
    gradients, on `device` (the card unless the caller passes another).
    The cache (from `backbone.init_cache`, and for an encoder-decoder
    model filled by `backbone.setup_cross_cache`) is updated in place and
    returned; tokens (B, 1) are moved to the device (no copy when they
    are there already, so a step on the card never waits for the host).

    Under `mesh`, params and the cache hold the rank's blocks (the cache
    from `init_cache(..., mesh=mesh)`), tokens are the global batch's
    (B, 1), of which the step decodes the rank's rows, and the logits
    are the rank's rows and its vocab block. Without one, `tp` picks the
    physical layout (default 1)."""
    tp = _layout(cfg, mesh, tp)
    dev = _device(device, "make_serve_step")

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        check_rows(tokens.shape[0], 1, mesh)
        tokens = _rows({"tokens": torch.as_tensor(tokens).to(dev).long()},
                       mesh)["tokens"]
        return backbone.decode_step(params, cache, tokens, cfg, tp, mesh)

    return serve_step
