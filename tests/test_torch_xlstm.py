"""The port's xLSTM slice held against the JAX package: `apply_mlstm`
and `apply_slstm` with their gradients (f32 and bf16, S not a multiple
of the chunk, and shorter than one), the refusal of a decode state, the
init's leaves, `backbone.forward` and `make_train_step` on the reduced config
with two (mlstm, slstm) periods, convert, the registry's count, and the
launcher on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_350m as jxc
from repro.models import backbone as jbackbone
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.train import step as jstep
from repro.train.optimizer import AdamCfg as JAdamCfg
from repro_torch.configs import xlstm_350m as xc
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch
from repro_torch.models import backbone, registry, xlstm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import tree_flatten, tree_leaves

# max |got - want| over max |want|. f32: sums in other orders;
# gradients also through the stabilizers' terms that cancel to rounding
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16 rounds every intermediate to 8 bits in both frameworks, at other
# places (jnp's weak scalars, XLA's fusions); a gradient summed over
# B * S positions carries a few such steps of its largest terms
BF16_OUT_TOL, BF16_GRAD_TOL = 2e-2, 4e-2
# the model at f32: after two Adam steps the parameters move by
# lr-sized steps whose sign can flip where a moment is near zero
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
BF16_LOSS_TOL, BF16_PARAM_TOL = 2e-2, 2e-2
B, S = 2, 80                 # chunk min(64, 80) = 64: S pads to 128
ADAM = dict(lr=1e-3, warmup_steps=2)


def _jit(fn):
    """jax.jit with XLA's CPU backend at its lowest optimisation level:
    the reference programs here compile faster, and small shapes lose
    nothing by it."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain little from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    want = _f32(want)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _tokens(seed, b=B, s=S, v=256):
    return np.random.default_rng(seed).integers(0, v, (b, s)) \
        .astype(np.int32)


CELLS = {"mlstm": (jxlstm.init_mlstm, jxlstm.apply_mlstm,
                   xlstm.apply_mlstm),
         "slstm": (jxlstm.init_slstm, jxlstm.apply_slstm,
                   xlstm.apply_slstm)}


# --------------------------------------------------------- the cells
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_and_gradients_match_jax_vjp(cell, dtype):
    jinit, japply, apply = CELLS[cell]
    jcfg, cfg = jxc.reduced(), xc.reduced()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jinit(jax.random.PRNGKey(3), jcfg, jd)
    x = jnp.asarray(_x(1, B, S, cfg.d_model)).astype(jd)
    dy = jnp.asarray(_x(2, B, S, cfg.d_model)).astype(jd)

    @_jit
    def fwd_vjp(p, xx, g):
        out, pull = jax.vjp(lambda p, xx: japply(p, xx, jcfg)[0], p, xx)
        return out, pull(g)

    want, (want_dp, want_dx) = fwd_vjp(jp, x, dy)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(_f32(x)).to(td).requires_grad_(True)
    got, state = apply(leaves, tx, cfg)
    assert state is None and got.dtype == td
    f32 = dtype == "float32"
    assert _rel(got, want) <= (OUT_TOL if f32 else BF16_OUT_TOL)
    got.backward(torch.from_numpy(_f32(dy)).to(td))
    tol = GRAD_TOL if f32 else BF16_GRAD_TOL
    assert _rel(tx.grad, want_dx) <= tol
    for k in sorted(leaves):
        assert leaves[k].grad.dtype == leaves[k].dtype
        assert _rel(leaves[k].grad, want_dp[k]) <= tol, k


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_decode_state_is_refused(cell):
    """A carried state was refused until decoding was ported; it is now
    taken, and the cell returns the next state in the reference's keys,
    shapes and dtypes (its values are held against the reference in
    tests/test_torch_decode_xlstm.py)."""
    jinit, _, apply = CELLS[cell]
    jcfg, cfg = jxc.reduced(), xc.reduced()
    init = {"mlstm": jxlstm.init_mlstm_state,
            "slstm": jxlstm.init_slstm_state}[cell]
    tp = params_from_numpy(jax.tree.map(
        np.asarray, jinit(jax.random.PRNGKey(4), jcfg, jnp.float32)), "cpu")
    want = init(jcfg, B)
    st = params_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    y, new = apply(tp, torch.from_numpy(_x(10, B, 1, cfg.d_model)), cfg, st)
    assert y.shape == (B, 1, cfg.d_model) and sorted(new) == sorted(want)
    for k in new:
        assert tuple(new[k].shape) == want[k].shape, k
        assert new[k].dtype == torch.float32, k


def test_mlstm_shorter_than_a_chunk_matches_jax():
    """S below 64: the cell runs one chunk of length S (min(64, S)), with
    no padding, f32."""
    jcfg, cfg = jxc.reduced(), xc.reduced()
    jp = jxlstm.init_mlstm(jax.random.PRNGKey(5), jcfg, jnp.float32)
    x = _x(6, B, 24, cfg.d_model)
    want, _ = _jit(lambda p, xx: jxlstm.apply_mlstm(p, xx, jcfg))(
        jp, jnp.asarray(x))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got, _ = xlstm.apply_mlstm(tp, torch.from_numpy(x), cfg)
    assert _rel(got, want) <= OUT_TOL


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_init_keeps_the_reference_leaves_and_dtypes(cell):
    jinit = CELLS[cell][0]
    mine = getattr(xlstm, f"init_{cell}")(None, xc.CONFIG, torch.bfloat16,
                                          device="meta")
    ref = jax.eval_shape(functools.partial(jinit, cfg=jxc.CONFIG,
                                           dtype=jnp.bfloat16),
                         jax.random.PRNGKey(0))
    assert sorted(mine) == sorted(ref)
    for k in mine:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype)[6:] == str(ref[k].dtype), k


# ------------------------------------------------------- model + step
def _cfgs(layers):
    return (xc.reduced().replace(num_layers=layers),
            jxc.reduced().replace(num_layers=layers))


def test_forward_and_prefill_match_jax():
    """Two (mlstm, slstm) periods, remat on and off."""
    cfg, jcfg = _cfgs(4)
    jp = _jit(functools.partial(jbackbone.init_params, jcfg, tp=1,
                                dtype=jnp.float32))(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(3)
    want, _ = _jit(lambda p, t: jbackbone.forward(
        p, t, jcfg, remat=False))(jp, jnp.asarray(tok))
    for remat in (True, False):
        got, aux = backbone.forward(tp, torch.from_numpy(tok).long(), cfg,
                                    remat=remat)
        assert got.dtype == torch.float32 and float(aux) == 0.0
        assert _rel(got, want) <= OUT_TOL
    prefill = step.make_prefill_step(cfg, step.RunCfg(), device="cpu")
    assert _rel(prefill(tp, {"tokens": tok}), want) <= OUT_TOL


@pytest.fixture(scope="module")
def jax_runs():
    """Two JAX train steps per dtype from one init, without remat (the
    same math, cheaper to compile; the port keeps its default, remat
    on), at grad_accum 1 only: two half batches' gradients accumulated
    in f32 are the same math as one batch, so one compiled step per
    dtype holds both of the port's settings."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jd = jnp.dtype(dt)
        state = _jit(functools.partial(
            jstep.init_state, _cfgs(4)[1], jstep.RunCfg(param_dtype=jd)))(
                jax.random.PRNGKey(4))
        start = jax.tree.map(np.asarray, state["params"])
        run = jstep.RunCfg(adam=JAdamCfg(**ADAM), param_dtype=jd,
                           remat=False)
        fn = _jit(jstep.make_train_step(_cfgs(4)[1], run, None))
        stats = []
        for i in range(2):
            state, st = fn(state, {"tokens": jnp.asarray(_tokens(i))})
            stats.append((float(st["loss"]), float(st["grad_norm"])))
        out[dt] = (start, stats, jax.tree.map(np.asarray, state["params"]))
    return out


@pytest.mark.parametrize("dtype,grad_accum", [("float32", 1),
                                              ("float32", 2),
                                              ("bfloat16", 1),
                                              ("bfloat16", 2)])
def test_train_step_matches_jax(jax_runs, dtype, grad_accum):
    """The second step runs on the leaves the first update cast: the
    f32 gate leaves come back in the parameters' dtype, as the
    reference's Adam returns them."""
    start, want_stats, want_params = jax_runs[dtype]
    cfg = _cfgs(4)[0]
    run = step.RunCfg(adam=AdamCfg(**ADAM),
                      param_dtype=getattr(torch, dtype),
                      grad_accum=grad_accum)
    params = params_from_numpy(start, "cpu")
    state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    fn = step.make_train_step(cfg, run, device="cpu")
    f32 = dtype == "float32"
    for i, (loss, gnorm) in enumerate(want_stats):
        state, st = fn(state, {"tokens": _tokens(i)})
        tol = LOSS_TOL if f32 else BF16_LOSS_TOL
        np.testing.assert_allclose(float(st["loss"]), loss, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(float(st["grad_norm"]), gnorm,
                                   rtol=tol, atol=tol)
    got = tree_leaves(state["params"])
    want = jax.tree.leaves(want_params)
    assert len(got) == len(want)
    tol = PARAM_TOL if f32 else BF16_PARAM_TOL
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(), _f32(w), rtol=tol,
                                   atol=tol)


# ------------------------------------------- convert, registry, launch
def test_convert_carries_the_mixed_tree_in_the_port_layout():
    """The reference's tree in bf16 (f32 w_i, b_i, w_f, b_f, w_zifo,
    r_zifo and b_zifo among bf16 leaves), its leaves seeded normals:
    same leaf order, shapes, dtypes and bytes as the port's own init,
    and back to numpy byte for byte."""
    cfg, jcfg = _cfgs(4)
    shapes = jax.eval_shape(functools.partial(
        jbackbone.init_params, jcfg, tp=1, dtype=jnp.bfloat16),
        jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    npt = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    tp = params_from_numpy(npt, "cpu")
    assert {str(l.dtype) for l in tree_leaves(tp)} == {"torch.bfloat16",
                                                       "torch.float32"}
    mine = backbone.init_params(cfg, None, dtype=torch.bfloat16,
                                device="meta")
    assert tree_flatten(mine)[1] == tree_flatten(tp)[1]
    for a, b in zip(tree_leaves(mine), tree_leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(npt)
    for a, b in zip(jax.tree.leaves(npt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_count_params_matches_reference():
    assert registry.count_params(registry.get_config("xlstm-350m")) == \
        430_634_080
    assert registry.count_params(registry.reduced_config("xlstm-350m")) \
        == jregistry.count_params(jregistry.reduced_config("xlstm-350m"))


def test_launcher_trains_the_reduced_config_on_the_cpu(capsys):
    hist = launch.main(["--arch", "xlstm-350m", "--reduced", "--device",
                        "cpu", "--steps", "4", "--batch", "2", "--seq",
                        "160", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=xlstm-350m params=" in out and "TRAINING DONE" in out
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
