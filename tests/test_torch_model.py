"""The port's model path held against the JAX package, with the JAX
package's own weights carried over by convert.params_from_numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt import tiny_gpt as jtiny_gpt
from repro.core import engine as jengine
from repro.models import attention as jatt
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import engine
from repro_torch.models import attention as att
from repro_torch.models import backbone, blocks
from repro_torch.tree import tree_flatten

TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jtiny_gpt(layers=4, d=64, heads=4, vocab=256)
    cfg = tiny_gpt(layers=4, d=64, heads=4, vocab=256)
    jp = jbackbone.init_params(jcfg, jax.random.PRNGKey(3), tp=1,
                               dtype=jnp.float32)
    npt = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, npt, params_from_numpy(npt, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pos():
    return np.ascontiguousarray(np.broadcast_to(np.arange(S)[None], (B, S)))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_rmsnorm_and_rope_match(model):
    x, g = _x(0, B, S, 64), _x(1, 64)
    _close(blocks.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
           jblocks.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    h = _x(2, B, S, 4, 16)
    _close(att.rope(torch.from_numpy(h), torch.from_numpy(_pos()), 1e4),
           jatt.rope(jnp.asarray(h), jnp.asarray(_pos()), 1e4))


def test_mlp_and_block_match(model):
    jcfg, cfg, jp, npt, tp = model
    x = _x(4, B, S, 64)
    jl = _layer(jp["stack"]["scan"][0], 1)
    tl = params_from_numpy(_layer(npt["stack"]["scan"][0], 1), "cpu")
    _close(blocks.apply_mlp(tl["mlp"], torch.from_numpy(x)),
           jblocks.apply_mlp(jl["mlp"], jnp.asarray(x)))
    got, _ = blocks.apply_block("attn", tl, torch.from_numpy(x), cfg, 1,
                                positions=torch.from_numpy(_pos()),
                                impl="dense")
    want, _ = jblocks.apply_block("attn", jl, jnp.asarray(x), jcfg, 1,
                                  positions=jnp.asarray(_pos()),
                                  impl="dense")
    _close(got, want)


def test_stack_and_loss_match(model):
    jcfg, cfg, jp, npt, tp = model
    x = _x(5, B, S, 64)
    got, _ = backbone.apply_stack(tp["stack"], torch.from_numpy(x), cfg, 1,
                                  positions=torch.from_numpy(_pos()),
                                  impl="dense")
    want, _ = jbackbone.apply_stack(jp["stack"], jnp.asarray(x), jcfg, 1,
                                    None, positions=jnp.asarray(_pos()),
                                    impl="dense", remat=False)
    _close(got, want)
    logits = _x(6, B, S, 256) * 3
    tok = np.random.default_rng(7).integers(0, 256, (B, S)).astype(np.int32)
    _close(backbone.lm_loss(torch.from_numpy(logits), torch.from_numpy(tok)),
           jbackbone.lm_loss(jnp.asarray(logits), jnp.asarray(tok)))


def _compare_trees(got, want, tol):
    gl, gtd = tree_flatten(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_gradients_match_jax(model, stage):
    jcfg, cfg, jp, npt, tp = model
    pp = 2
    jsp = jengine.split_stage_params(jp, stage, pp, jcfg)
    tsp = engine.split_stage_params(tp, stage, pp, cfg)
    jfns = jengine.make_stage_fns(jcfg, stage, pp)
    fns = engine.make_stage_fns(cfg, stage, pp)
    tok = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    ttok = torch.from_numpy(tok).long()
    if stage == 0:
        xin, txin = jnp.asarray(tok), ttok
    else:
        x = _x(9, B, S, 64)
        xin, txin = jnp.asarray(x), torch.from_numpy(x)
    _close(fns["fwd"](tsp, txin), jfns["fwd"](jsp, xin))
    if stage == pp - 1:
        jl, jdp, jdx = jax.jit(jfns["last_bwd"])(jsp, xin, jnp.asarray(tok))
        loss, dp_, dx = fns["last_bwd"](tsp, txin, ttok)
        _close(loss, jl)
    else:
        # a loss gradient's scale (unit-variance dy gives |grad| ~ 2e3,
        # where f32 summation order alone moves the last digits by 1e-3)
        dy = _x(10, B, S, 64) * 1e-3
        jdp, jdx = jax.jit(jfns["mid_bwd"])(jsp, xin, jnp.asarray(dy))
        dp_, dx = fns["mid_bwd"](tsp, txin, torch.from_numpy(dy))
    _compare_trees(dp_, jdp, GRAD_TOL)
    if stage > 0:
        _close(dx, jdx, GRAD_TOL)
    else:
        assert dx is None


def test_params_round_trip_bitwise(model):
    jcfg, cfg, jp, npt, tp = model
    back = params_to_numpy(params_from_numpy(npt, "cpu"))
    for a, b in zip(jax.tree.leaves(npt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert jax.tree.structure(npt) == jax.tree.structure(back)


def test_torch_init_keeps_the_reference_tree(model):
    jcfg, cfg, jp, npt, tp = model
    mine = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    leaves, _ = tree_flatten(mine)
    want = jax.tree.leaves(jp)
    assert [tuple(l.shape) for l in leaves] == [w.shape for w in want]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths[:3] == ["['embed']", "['final_ln']", "['head']"]
