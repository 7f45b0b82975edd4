"""Serving under meshes, held against the JAX package at the same tp with
no mesh: `init_cache(..., mesh=)` allocates only the rank's block, and
the split `make_serve_step` (the global batch's tokens, the rank's
rows decoded) gives the reference's `decode_step` token by token, the
logits and the whole cache tree (every rank's blocks gathered), and
`make_prefill_step` its forward's logits. The ranks run
`mesh_workers.serve` on gloo process groups, spawned once for each
module (tests/test_torch_mesh_serve_{moe,rec,whisper}.py hold the other
decoder block types with these helpers).

Here: reduced Yi (`attn`; 7 q heads on one kv head, padded to 8 on 2
kv slots at tp 2) with a vocab of 255, which tp 2 pads to 256 and masks
on the last vocab rank, on (2, 2) and (1, 2); reduced StableLM with a
bf16 cache on (2, 1). And, on fake meshes (pure functions, as
tests/test_torch_shardings.py builds them), `cache_specs` and
`cache_shardings` against the reference's leaf by leaf for every
architecture, the mLSTM's state the one named difference, and
`init_cache`'s blocks against them.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_workers
from decode_helpers import close, jit, one_torch_thread, tokens, x
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import shardings as jshard
from repro.train import step as jstep
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import backbone, blocks, registry
from repro_torch.models.tp_padding import plan_heads
from repro_torch.train import step
from repro_torch.tree import tree_leaves
from test_torch_shardings import (MESHES, MLSTM_CACHE_AXES, FakeMesh,
                                  _mesh, port_cache_axes)

# the serving tests' tolerances (tests/test_torch_decode_step.py): f32,
# the same products summed in other orders (here also over `model`); a
# bf16 cache holds both sides' f32 keys and values rounded to 8 bits
F32_TOL, BF16_CACHE_TOL = 1e-5, 1e-2
B = 4
CASES = {"yi": dict(arch="yi-34b", tp=2, steps=5, max_len=8,
                    cuts={"vocab_size": 255}),
         "lm16": dict(arch="stablelm-1.6b", tp=1, steps=5, max_len=8,
                      cache_dtype="bfloat16")}
RUNS = [("yi", "2x2", 4), ("yi", "1x2", 2), ("lm16", "2x1", 2)]


def jax_config(case: dict):
    """The reference's reduced config of `case`, with its cuts."""
    return mesh_workers.config(jregistry.reduced_config(case["arch"]),
                               case.get("cuts"))


def _inputs(case: dict, seed: int) -> dict:
    """The reference's f32 weights at the case's tp (key `seed`), the
    global batch's tokens and, for an encoder, frames."""
    jcfg = jax_config(case)
    params = jit(lambda k: jbackbone.init_params(jcfg, k, tp=case["tp"],
                                                 dtype=jnp.float32))(
        jax.random.PRNGKey(seed))
    out = dict(case, params=jax.tree.map(np.asarray, params),
               tokens=tokens(seed + 1, B, case["steps"], jcfg.vocab_size))
    out.setdefault("cache_dtype", "float32")
    if jcfg.encoder_layers:
        out["frames"] = x(seed + 2, B, jcfg.encoder_seq, jcfg.d_model)
    return out


def _reference(case: dict) -> dict:
    """The reference's serving of `case` at its tp with no mesh: the
    cache after setup_cross_cache (an encoder), the logits and cache
    leaves after each decode_step, and the forward's logits."""
    jcfg, tp = jax_config(case), case["tp"]
    jp = jax.tree.map(jnp.asarray, case["params"])
    jc = jbackbone.init_cache(jcfg, B, case["max_len"], tp=tp,
                              dtype=jnp.dtype(case["cache_dtype"]))
    frames = case.get("frames")
    out = {}
    if frames is not None:
        frames = jnp.asarray(frames)
        jc = jit(lambda p, c, f: jbackbone.setup_cross_cache(
            p, c, f, jcfg, tp))(jp, jc, frames)
        out["cross"] = jax.tree.leaves(jc)
    decode = jit(lambda p, c, t: jbackbone.decode_step(p, c, t, jcfg, tp))
    logits, caches = [], []
    for t in range(case["steps"]):
        lg, jc = decode(jp, jc, jnp.asarray(case["tokens"][:, t:t + 1]))
        logits.append(np.asarray(lg))
        caches.append(jax.tree.leaves(jc))
    fwd = jit(lambda p, t, f: jbackbone.forward(
        p, t, jcfg, tp, None, impl="dense", remat=False, frames=f)[0])
    out.update(logits=np.concatenate(logits, 1), caches=caches,
               prefill=fwd(jp, jnp.asarray(case["tokens"]), frames))
    return out


def spawn_serve(tmp, cases: dict, runs: list):
    """Every rank's findings (by world size and rank) and the reference's
    (by case) for `runs`; the ranks start while the reference builds."""
    worlds = sorted({w for _, _, w in runs}, reverse=True)
    ctx = mesh_workers.start(mesh_workers.serve, tmp, worlds[0])
    try:
        inputs = {name: _inputs(case, 11 + i)
                  for i, (name, case) in enumerate(cases.items())}
        part = tmp / "inputs.part"
        with open(part, "wb") as f:
            pickle.dump(dict(inputs, runs=[r[:2] for r in runs]), f)
        part.rename(tmp / "inputs.pkl")
        want = {name: _reference(case) for name, case in inputs.items()}
    finally:
        got = mesh_workers.finish(ctx, tmp, worlds)
    return got, want, inputs


def _tol(case: dict) -> float:
    return F32_TOL if case["cache_dtype"] == "float32" else BF16_CACHE_TOL


def logits_close(got, want, vocab: int, tol: float):
    """The logits of the vocab within `tol` (decode_helpers.close), and
    the padded rows past it masked alike (-1e30 on both sides, which
    would swamp `close`'s scale)."""
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    close(got[..., :vocab], want[..., :vocab], tol)
    np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])


def leaves_close(got: list, want: list, tol: float):
    """Cache leaves in the reference's order: the same shapes, int leaves
    (pos) equal, float leaves within `tol`."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if jnp.issubdtype(b.dtype, jnp.integer):
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            close(a, b, tol)


def check_decode(served, name, mesh, world):
    """Every rank's gathered logits after each token, and rank 0's
    gathered cache tree, against the reference's."""
    got, want, inputs = served
    case, ref = inputs[name], want[name]
    vocab = jax_config(case).vocab_size
    for r in range(world):
        out = got[world, r][f"{name} {mesh}"]
        logits_close(out["logits"], ref["logits"], vocab, _tol(case))
    for g, w in zip(got[world, 0][f"{name} {mesh}"]["caches"],
                    ref["caches"]):
        leaves_close(g, w, _tol(case))


def check_prefill(served, name, mesh, world):
    got, want, inputs = served
    vocab = jax_config(inputs[name]).vocab_size
    for r in range(world):
        logits_close(got[world, r][f"{name} {mesh}"]["prefill"],
                     want[name]["prefill"], vocab, F32_TOL)


def check_cache_blocks(served, name, mesh, world):
    """Each rank's cache is its block of cache_specs' whole as
    cache_shardings splits it: smaller than the whole, but for MLA's
    latent cache on one data rank (whole on every `model` rank)."""
    got, _, inputs = served
    latent = set(jax_config(inputs[name]).block_pattern) == {"mla_moe"}
    for r in range(world):
        out = got[world, r][f"{name} {mesh}"]
        assert out["blocks"], r
        if latent and mesh.startswith("1x"):
            assert out["local"] == out["whole"], r
        else:
            assert out["local"] < out["whole"], (r, out["local"],
                                                 out["whole"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn_serve(tmp_path_factory.mktemp("mesh_serve"), CASES, RUNS)


IDS = [f"{n}-{m}" for n, m, _ in RUNS]


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_decode_matches_jax(served, name, mesh, world):
    check_decode(served, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_prefill_matches_jax(served, name, mesh, world):
    check_prefill(served, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_each_rank_holds_only_its_cache_block(served, name, mesh, world):
    check_cache_blocks(served, name, mesh, world)


# the (q heads, kv heads) of every architecture, and the tp extents
HEADS = sorted({(c.num_heads, c.num_kv_heads) for c in map(
    registry.get_config, registry.ARCH_IDS)} | {(7, 1), (2, 1)})


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_q_mask_is_the_plans_on_every_rank(tp):
    """The padded q slots' mask that each `model` rank builds on the
    device is its block of the head plan's (`HeadPlan.q_mask`)."""
    for n_q, n_kv in HEADS:
        plan = plan_heads(n_q, n_kv, tp)
        n = plan.n_q_phys // tp
        for rank in range(tp):
            mesh = FakeMesh((1, tp), ("data", "model"), (0, rank))
            got = blocks._q_mask(plan, torch.float32, "cpu", mesh)
            np.testing.assert_array_equal(
                got.numpy(), plan.q_mask[rank * n:(rank + 1) * n])


# ------------------------------------------- cache specs and shardings
def _splits(arch: str, name: str) -> bool:
    try:
        backbone.check_mesh(registry.reduced_config(arch),
                            MESHES[name][0][-1], _mesh(name))
    except ValueError:
        return False
    return True


# every architecture on every fake mesh whose model extent its blocks
# split over (the reduced xLSTM's 2 heads not over 4)
ARCH_MESHES = [(a, m) for a in registry.ARCH_IDS for m in MESHES
               if _splits(a, m)]
SHAPE = dict(name="decode", kind="decode", seq_len=12, global_batch=8)



@pytest.mark.parametrize("arch,name", ARCH_MESHES,
                         ids=[f"{a}-{m}" for a, m in ARCH_MESHES])
def test_cache_specs_and_shardings_match_jax(arch, name, monkeypatch):
    """cache_specs (the whole cache in the mesh's tp layout, f32 and
    bf16) are the reference's shapes and dtypes, and cache_shardings'
    specs its `resolve` of stack_cache_axes, leaf by leaf; they differ
    only at the mLSTM's C, n and m (ROADMAP Queue 3); init_cache under
    the mesh allocates each leaf's block of them."""
    mesh = _mesh(name)
    tp = jshard.axis_size(mesh, "heads")
    cfg, jcfg = registry.reduced_config(arch), jregistry.reduced_config(arch)
    specs = lambda leaves: [(tuple(s.shape), str(s.dtype).split(".")[-1])
                            for s in leaves]
    got = tree_leaves(step.cache_specs(cfg, ShapeCfg(**SHAPE), mesh))
    assert specs(got) == specs(jax.tree.leaves(
        jstep.cache_specs(jcfg, JShapeCfg(**SHAPE), mesh)))
    f32 = tree_leaves(step.cache_specs(cfg, ShapeCfg(**SHAPE), mesh,
                                       torch.float32))
    assert specs(f32) == specs(jax.tree.leaves(jax.eval_shape(
        lambda: jbackbone.init_cache(jcfg, 8, 12, tp=tp,
                                     dtype=jnp.float32))))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 jbackbone.stack_cache_axes(jcfg),
                 is_leaf=jstep._axes_leaf)[0]]
    resolve = lambda: [tuple(jshard.resolve(ax, mesh)) for ax in
                       jax.tree.leaves(jbackbone.stack_cache_axes(jcfg),
                                       is_leaf=jstep._axes_leaf)]
    reference = resolve()
    monkeypatch.setattr(jblocks, "block_cache_axes", port_cache_axes)
    mine = [s.spec for s in tree_leaves(step.cache_shardings(cfg, mesh))]
    assert mine == resolve()
    differ = {p.split("'")[-2] for p, a, b in zip(paths, mine, reference)
              if a != b}
    assert differ == (set(MLSTM_CACHE_AXES) if "mlstm" in cfg.block_pattern
                      else set())
    cache = backbone.init_cache(cfg, 8, 12, tp, device="meta", mesh=mesh)
    assert [tuple(t.shape) for t in tree_leaves(cache)] == [
        s.local_shape(p.shape) for s, p in zip(
            tree_leaves(step.cache_shardings(cfg, mesh)), got)]
