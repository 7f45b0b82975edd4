"""The five dense architectures the port builds but no other port test
runs, held against the JAX package at their reduced configs:
`backbone.forward` from the reference's f32 weights and one
`make_train_step` step (loss, grad norm and every parameter) against
`jax.jit(make_train_step)`. Yi's and LLaVA's reduced configs put 7 q
heads on one kv head (G = 7); LLaVA's stub patch embeddings take the
first 8 positions and are masked out of the loss."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import close, jit, one_torch_thread, to_port, tokens, x
from repro.models import backbone as jbackbone
from repro.models import registry as jregistry
from repro.train import step as jstep
from repro.train.optimizer import AdamCfg as JAdamCfg
from repro_torch.models import backbone, registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import tree_leaves

# the model at f32: the logits to 1e-5; after one Adam step a parameter
# moves by about lr, and its sign can flip where a moment is near zero
FWD_TOL, LOSS_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
B, S = 2, 16
ADAM = dict(lr=1e-3, warmup_steps=2)
ARCHS = ("stablelm-1.6b", "granite-3-8b", "granite-8b", "yi-34b",
         "llava-next-34b")


def _batch(cfg, seed):
    batch = {"tokens": tokens(seed, B, S, cfg.vocab_size)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = x(seed + 1, B, cfg.num_patches, cfg.d_model,
                             scale=0.02)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step_match_jax(arch):
    cfg, jcfg = registry.reduced_config(arch), jregistry.reduced_config(arch)
    assert (cfg.num_heads // cfg.num_kv_heads == 7) == (arch in (
        "yi-34b", "llava-next-34b"))
    run = jstep.RunCfg(adam=JAdamCfg(**ADAM), param_dtype=jnp.float32,
                       attention_impl="dense", remat=False)
    batch = _batch(cfg, 4)
    train_step = jstep.make_train_step(jcfg, run, None)

    def reference(key, batch):
        """One program (one build): the reference's init, its forward
        and one train step from that init."""
        state = jstep.init_state(jcfg, run, key)
        kw = {k: v for k, v in batch.items() if k != "tokens"}
        logits, _ = jbackbone.forward(state["params"], batch["tokens"],
                                      jcfg, impl="dense", remat=False, **kw)
        new, stats = train_step(state, batch)
        return state["params"], logits, new["params"], stats

    start, want, jnew, jst = jit(reference)(
        jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in batch.items()})
    params = to_port(start)
    got, aux = backbone.forward(
        params, torch.from_numpy(batch["tokens"]).long(), cfg,
        **{k: torch.from_numpy(v) for k, v in batch.items()
           if k != "tokens"})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    close(got, want, FWD_TOL)

    state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    fn = step.make_train_step(cfg, step.RunCfg(
        adam=AdamCfg(**ADAM), param_dtype=torch.float32), device="cpu")
    state, st = fn(state, batch)
    close(st["loss"], jst["loss"], LOSS_TOL)
    close(st["grad_norm"], jst["grad_norm"], LOSS_TOL)
    got, want = tree_leaves(state["params"]), jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, PARAM_TOL)
    if cfg.frontend == "vision_patches":
        # the patches replace the first positions' token embeddings: the
        # tokens under them change nothing (and the train step's loss,
        # held to the reference's above, masks their targets)
        other = batch["tokens"].copy()
        other[:, :cfg.num_patches] = 0
        fwd = lambda t: backbone.forward(
            params, torch.from_numpy(t).long(), cfg,
            patches=torch.from_numpy(batch["patches"]))[0]
        assert torch.equal(fwd(other), fwd(batch["tokens"]))
