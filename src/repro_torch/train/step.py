"""train_step / prefill_step / serve_step builders (counterpart of
`repro/train/step.py`) for one device: the programs the launcher runs,
and the one-token decode step that serves against a cache.

The train step consumes its state, as the reference launcher's
`jax.jit(train_step, donate_argnums=(0,))` does: the Adam update writes
m, v, master and the parameters in place (`optimizer.adam_update_`),
so the old and the new optimizer state never exist at once.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import deterministic_cuda, resolve_device
from repro_torch.models import backbone
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import tree_flatten, tree_map


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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("meshes are not ported "
                                  "(ROADMAP Queue 1 item 11)")


def _device(device, who: str) -> torch.device:
    dev = resolve_device(device, who)
    if dev.type == "cuda":
        deterministic_cuda()
    return dev


def _forward_kwargs(cfg: ArchConfig, batch: dict) -> dict:
    """The frontend's stub embeddings, as forward takes them."""
    key = {"vision_patches": "patches",
           "audio_frames": "frames"}.get(cfg.frontend)
    return {key: batch[key]} if key else {}


# ------------------------------------------------------------ train step
def make_train_step(cfg: ArchConfig, run: RunCfg, mesh=None, *,
                    device=None):
    """train_step(state, batch) -> (state, stats) on `device` (the card
    unless the caller passes another; raises without CUDA then). `batch`
    holds numpy arrays or tensors; they are moved to the device. The
    state passed in is updated in place and returned."""
    _no_mesh(mesh)
    dev = _device(device, "make_train_step")

    def loss_fn(params, batch):
        logits, aux = backbone.forward(params, batch["tokens"], cfg,
                                       remat=run.remat,
                                       **_forward_kwargs(cfg, batch))
        mask = None
        if cfg.frontend == "vision_patches":
            s = batch["tokens"].shape[1]
            mask = (torch.arange(s, device=dev)[None] >= cfg.num_patches) \
                .expand(batch["tokens"].shape)
        loss = backbone.lm_loss(logits, batch["tokens"], mask)
        return loss + aux, loss

    def value_and_grad(leaves, tdef, batch):
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            total, loss = loss_fn(tdef.unflatten(leaves), batch)
            grads = list(torch.autograd.grad(total, leaves))
        return total.detach(), loss.detach(), grads

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].long()
        leaves, tdef = tree_flatten(state["params"])
        n = run.grad_accum
        if n <= 1:
            total, loss, grads = value_and_grad(leaves, tdef, batch)
        else:
            grads = [torch.zeros(l.shape, dtype=torch.float32, device=dev)
                     for l in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            total = torch.zeros((), dtype=torch.float32, device=dev)
            b = batch["tokens"].shape[0]
            for i in range(n):
                mb = {k: v[i * (b // n):(i + 1) * (b // n)]
                      for k, v in batch.items()}
                t, l_, g = value_and_grad(leaves, tdef, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss, total = loss + l_, total + t
                del g
            grads = [g / n for g in grads]
            loss, total = loss / n, total / n
        params, stats = opt_mod.adam_update_(state["params"], grads,
                                             state["opt"], run.adam,
                                             run.param_dtype)
        state["params"] = params
        return state, {"loss": loss, "total_loss": total, **stats}

    return train_step


def init_state(cfg: ArchConfig, run: RunCfg, seed: Optional[int] = None,
               mesh=None, *, device=None) -> dict:
    """{"params", "opt"} on `device` (the card unless the caller passes
    another), parameters drawn from a torch.Generator seeded with `seed`
    (default run.seed) on that device."""
    _no_mesh(mesh)
    dev = _device(device, "init_state")
    gen = torch.Generator(device=dev).manual_seed(
        run.seed if seed is None else seed)
    params = backbone.init_params(cfg, gen, tp=1, dtype=run.param_dtype,
                                  device=dev)
    return {"params": params, "opt": opt_mod.init_opt_state(params)}


def state_to(state, device) -> dict:
    """The state's tensors on `device` (resolved as the entry points
    resolve it)."""
    dev = _device(device, "state_to")
    return tree_map(lambda t: t.to(dev), state)


# ------------------------------------------------------------ prefill
def make_prefill_step(cfg: ArchConfig, run: RunCfg, mesh=None, *,
                      device=None):
    """prefill_step(params, batch) -> logits (B, S, V) f32, without
    gradients, on `device` (the card unless the caller passes another)."""
    _no_mesh(mesh)
    dev = _device(device, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        logits, _ = backbone.forward(params, batch["tokens"].long(), cfg,
                                     remat=run.remat,
                                     **_forward_kwargs(cfg, batch))
        return logits

    return prefill_step


# ------------------------------------------------------------ serve step
def make_serve_step(cfg: ArchConfig, mesh=None, *, device=None):
    """serve_step(params, cache, tokens) -> (logits (B, 1, V) f32, cache):
    one decode step against the cache (`backbone.decode_step`) without
    gradients, on `device` (the card unless the caller passes another).
    The cache (from `backbone.init_cache`, and for an encoder-decoder
    model filled by `backbone.setup_cross_cache`) is updated in place and
    returned; tokens (B, 1) are moved to the device (no copy when they
    are there already, so a step on the card never waits for the host)."""
    _no_mesh(mesh)
    dev = _device(device, "make_serve_step")

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        tokens = torch.as_tensor(tokens).to(dev).long()
        return backbone.decode_step(params, cache, tokens, cfg)

    return serve_step
