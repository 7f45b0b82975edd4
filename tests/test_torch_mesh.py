"""The port's meshes on real gloo process groups on the CPU, held against
the JAX package at the same tp with no mesh: reduced Yi (7 q heads on
one kv head, padded to 8 on 2 slots at tp 2) on (2, 2) and (1, 2)
(tests/test_torch_mesh_{rg,moe,mla,xlstm,whisper}.py do the other block
types), from the reference's weights at tp 2 carried over with
`convert`: the forward's logits, one train step (the loss with the
forward's aux loss, grad norm, parameters: the reference's forward and
lm_loss plus aux under jax.value_and_grad, then adam_update, as its
train step), and each rank's blocks of every parameter and Adam leaf
against the shapes `state_shardings` gives them. The ranks run
`mesh_workers.parity`, spawned once for the module.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_workers
from decode_helpers import close, jit, one_torch_thread, tokens, x
from repro.models import backbone as jbackbone
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro.train.optimizer import AdamCfg as JAdamCfg

# f32: the logits to 1e-5; after one Adam step a parameter moves by
# about lr, and its sign can flip where a moment is near zero
FWD_TOL, LOSS_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
CASES = {"yi": ("yi-34b", 16)}
RUNS = [("yi", "2x2", 4), ("yi", "1x2", 2)]
TP, B = 2, 4


def _weights(arch: str, seq: int, seed: int, cuts=None):
    """The reference's f32 weights at tp 2 (key `seed`) of the reduced
    config with `cuts` (`mesh_workers.config`), and a batch (with
    frames for an encoder)."""
    jcfg = mesh_workers.config(jregistry.reduced_config(arch), cuts)
    params = jit(lambda k: jbackbone.init_params(jcfg, k, tp=TP,
                                                 dtype=jnp.float32))(
        jax.random.PRNGKey(seed))
    case = {"arch": arch, "cuts": cuts,
            "params": jax.tree.map(np.asarray, params),
            "tokens": tokens(seed + 1, B, seq, jcfg.vocab_size)}
    if jcfg.encoder_layers:
        case["frames"] = x(seed + 2, B, jcfg.encoder_seq, jcfg.d_model)
    return case


def _reference(case: dict) -> dict:
    """What the reference's train step gives from `case`'s weights and
    batch: logits, loss (with the aux loss), grad norm and the new
    parameters."""
    jcfg = mesh_workers.config(jregistry.reduced_config(case["arch"]),
                               case["cuts"])

    def step(params, toks, frames):
        def loss_fn(p):
            logits, aux = jbackbone.forward(p, toks, jcfg, TP, None,
                                            impl="dense", remat=False,
                                            frames=frames)
            return jbackbone.lm_loss(logits, toks) + aux, logits
        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        new, _, stats = jopt.adam_update(
            grads, jopt.init_opt_state(params),
            JAdamCfg(**mesh_workers.ADAM), jnp.float32)
        return {"logits": logits, "loss": loss,
                "grad_norm": stats["grad_norm"],
                "params": jax.tree.leaves(new)}

    frames = case.get("frames")
    return jit(step)(jax.tree.map(jnp.asarray, case["params"]),
                     jnp.asarray(case["tokens"]),
                     None if frames is None else jnp.asarray(frames))


def spawn_parity(tmp, cases: dict, runs: list):
    """Every rank's findings (by world size and rank) and the reference's
    results (by case) for `runs`; the ranks start while the reference
    builds."""
    worlds = sorted({w for _, _, w in runs}, reverse=True)
    ctx = mesh_workers.start(mesh_workers.parity, tmp, worlds[0])
    try:
        inputs = {name: _weights(*spec[:2], 3 + i, *spec[2:])
                  for i, (name, spec) in enumerate(cases.items())}
        part = tmp / "inputs.part"
        with open(part, "wb") as f:
            pickle.dump(dict(inputs, runs=[r[:2] for r in runs]), f)
        part.rename(tmp / "inputs.pkl")
        want = {name: _reference(case) for name, case in inputs.items()}
    finally:
        got = mesh_workers.finish(ctx, tmp, worlds)
    return got, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh"), CASES, RUNS)


def check_parity(ranks, name, mesh, world):
    got, want = ranks
    out, ref = got[world, 0][f"{name} {mesh}"], want[name]
    close(out["logits"], ref["logits"], FWD_TOL)
    for r in range(world):
        case = got[world, r][f"{name} {mesh}"]
        close(case["loss"], ref["loss"], LOSS_TOL)
        close(case["grad_norm"], ref["grad_norm"], LOSS_TOL)
    assert len(out["params"]) == len(ref["params"])
    for g, w in zip(out["params"], ref["params"]):
        assert g.shape == w.shape
        close(g, w, PARAM_TOL)


def check_blocks(ranks, name, mesh, world):
    """Every parameter and Adam leaf of every rank has the block shape
    its sharding gives on that mesh: nothing was replicated whole (but
    the parameters where the mesh has one `model` rank)."""
    got, _ = ranks
    whole_params = mesh.endswith("x1")
    for r in range(world):
        for part, (same, local, whole) in \
                got[world, r][f"{name} {mesh}"]["blocks"].items():
            assert same, (r, part)
            if part == "params" and whole_params:
                assert local == whole, (r, part, local, whole)
            else:
                assert local < whole, (r, part, local, whole)


@pytest.mark.parametrize("name,mesh,world", RUNS,
                         ids=[f"{n}-{m}" for n, m, _ in RUNS])
def test_forward_and_train_step_match_jax(ranks, name, mesh, world):
    check_parity(ranks, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS,
                         ids=[f"{n}-{m}" for n, m, _ in RUNS])
def test_each_rank_holds_only_its_blocks(ranks, name, mesh, world):
    check_blocks(ranks, name, mesh, world)
