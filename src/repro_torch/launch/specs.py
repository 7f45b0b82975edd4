"""input_specs(): the abstract inputs of every (arch x shape) cell on a
mesh (counterpart of `repro/launch/specs.py`): ShapeDtype trees of the
whole arguments, their shardings fitted to the shapes, which arguments
the step consumes, and the step itself. The dry-run reads from here.

Built from the port's own `train/step.py` (`state_specs`, `batch_specs`,
`param_specs`, `cache_specs` and the `*_shardings` functions), which read
of a mesh only its axis names and extents.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.models import registry
from repro_torch.models.shardings import NamedSharding, entry_axes, resolve
from repro_torch.train import step as step_mod
from repro_torch.tree import ShapeDtype, tree_map


def fit_sharding(spec: ShapeDtype, sh: NamedSharding) -> NamedSharding:
    """Drop the mesh axes of any dimension they do not divide (e.g.
    long_500k's global batch of 1): that dimension is whole on every
    rank."""
    sizes = dict(zip(sh.mesh.mesh_dim_names, sh.mesh.shape))
    entries = list(sh.spec) + [None] * (len(spec.shape) - len(sh.spec))
    changed = False
    for i, e in enumerate(entries):
        extent = math.prod(sizes[a] for a in entry_axes(e))
        if extent > 1 and spec.shape[i] % extent:
            entries[i] = None
            changed = True
    return NamedSharding(sh.mesh, tuple(entries)) if changed else sh


def fit_shardings(specs, shardings):
    return tree_map(fit_sharding, specs, shardings)


def input_specs(arch_id: str, shape_name: str, mesh,
                reduced: bool = False, cfg=None) -> Dict[str, Any]:
    """Everything the dry-run needs to run the cell's step once.

    Returns {kind, cfg, run, args: tuple of ShapeDtype trees of the
    whole arguments, in_shardings, out_shardings, consumed}: `consumed`
    holds the indices of the arguments the step updates in place (the
    train step's state, through `optimizer.adam_update_`; the serve
    step's cache), the counterpart of the reference's `donate_argnums`.
    `cfg` replaces the registry's config (e.g. with a cut depth), and a
    ShapeCfg may stand in place of `shape_name`."""
    if cfg is None:
        cfg = (registry.reduced_config(arch_id) if reduced
               else registry.get_config(arch_id))
    shape = shape_name if isinstance(shape_name, ShapeCfg) else \
        SHAPES[shape_name]
    run = step_mod.default_run_cfg()
    if mesh is None:
        raise ValueError("dry-run requires a mesh")

    if shape.kind == "train":
        state = step_mod.state_specs(cfg, run, mesh)
        batch = step_mod.batch_specs(cfg, shape)
        state_sh = fit_shardings(state, step_mod.state_shardings(cfg, mesh))
        batch_sh = fit_shardings(batch,
                                 step_mod.batch_shardings(cfg, shape, mesh))
        return dict(kind="train", cfg=cfg, run=run, args=(state, batch),
                    in_shardings=(state_sh, batch_sh),
                    out_shardings=(state_sh, None), consumed=(0,))

    params = step_mod.param_specs(cfg, mesh)
    params_sh = fit_shardings(params, step_mod.param_shardings(cfg, mesh))
    if shape.kind == "prefill":
        batch = step_mod.batch_specs(cfg, shape)
        batch_sh = fit_shardings(batch,
                                 step_mod.batch_shardings(cfg, shape, mesh))
        return dict(kind="prefill", cfg=cfg, run=run, args=(params, batch),
                    in_shardings=(params_sh, batch_sh), out_shardings=None,
                    consumed=())

    cache = step_mod.cache_specs(cfg, shape, mesh)
    cache_sh = fit_shardings(cache, step_mod.cache_shardings(cfg, mesh))
    tokens = ShapeDtype((shape.global_batch, 1), torch.int32)
    tok_sh = fit_sharding(tokens, NamedSharding(
        mesh, resolve(("batch", None), mesh)))
    return dict(kind="decode", cfg=cfg, run=run,
                args=(params, cache, tokens),
                in_shardings=(params_sh, cache_sh, tok_sh),
                out_shardings=(None, cache_sh), consumed=(1,))


def step_fn_for(spec: Dict[str, Any], mesh, device=None):
    """The cell's step: make_train_step, make_prefill_step or
    make_serve_step on `mesh`, on `device` (the card unless the caller
    passes another; the dry-run's is `meta`)."""
    cfg, run = spec["cfg"], spec["run"]
    if spec["kind"] == "train":
        return step_mod.make_train_step(cfg, run, mesh, device=device)
    if spec["kind"] == "prefill":
        return step_mod.make_prefill_step(cfg, run, mesh, device=device)
    return step_mod.make_serve_step(cfg, mesh, device=device)
