"""The port's RecurrentGemma slice held against the JAX package:
windowed attention at head dim 256, `backbone.forward`, the train step
(f32 and bf16, with and without gradient accumulation), the in-place
Adam update, the registry, checkpoints, and the launcher with a resume.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_2b as jrg
from repro.models import attention as jatt
from repro.models import backbone as jbackbone
from repro.models import registry as jregistry
from repro.train import step as jstep
from repro.train.optimizer import AdamCfg as JAdamCfg
from repro_torch.configs import recurrentgemma_2b as rg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as launch
from repro_torch.models import attention as att
from repro_torch.models import backbone, registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

F32_TOL, GRAD_TOL = 2e-5, 1e-4
# the model at f32: forward 1e-5 in the logits; after two Adam steps the
# parameters move by lr-sized steps whose sign can flip where a moment is
# near zero, hence the looser bound on them
FWD_TOL, LOSS_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
# bf16 parameters and activations round to 8 bits at other places in the
# two frameworks (jnp's weak scalars, XLA's fusions)
BF16_LOSS_TOL, BF16_PARAM_TOL = 2e-2, 2e-2
B, S = 2, 32
ADAM = dict(lr=1e-3, warmup_steps=2)


def _jit(fn):
    """jax.jit with XLA's CPU backend at its lowest optimisation level:
    the reference programs here compile about twice as fast, and tiny
    shapes lose nothing by it."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _tokens(seed, b=B, s=S, v=256):
    return np.random.default_rng(seed).integers(0, v, (b, s)) \
        .astype(np.int32)


# ------------------------------------------- windowed attention, d=256
@pytest.mark.parametrize("s,window,causal", [(48, 20, True),
                                             (40, 7, False)])
def test_windowed_attention_d256_matches_dense(s, window, causal):
    bh, d = 2, 256
    q, k, v, do = (_x(s + i, bh, s, d) for i in range(4))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (bh, s))

    @jax.jit
    def dense_vjp(a, b, c, g):
        fn = lambda a, b, c: jatt.dense_attention(
            a[:, :, None, None], b[:, :, None], c[:, :, None], pos, pos,
            causal=causal, window=window)[:, :, 0, 0]
        out, pull = jax.vjp(fn, a, b, c)
        return out, pull(g)

    want, want_grads = dense_vjp(*(jnp.asarray(t) for t in (q, k, v, do)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = fa.flash_attention(*leaves, causal=causal, window=window)
    _close(got, want, F32_TOL)
    got.backward(torch.from_numpy(do))
    for g, w in zip(leaves, want_grads):
        _close(g.grad, w, GRAD_TOL)


def test_attend_local_window_and_mqa_match_dense():
    """The local_attn layout: 4 q heads on one kv head, window below S."""
    b, s, g, d, window = 2, 40, 4, 256, 9
    q, k, v = _x(1, b, s, 1, g, d), _x(2, b, s, 1, d), _x(3, b, s, 1, d)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s)[None], (b, s)))
    want = jatt.dense_attention(*(jnp.asarray(t) for t in (q, k, v, pos,
                                                          pos)),
                                window=window)
    tpos = torch.from_numpy(pos)
    got = att.attend(*(torch.from_numpy(t) for t in (q, k, v)), tpos, tpos,
                     window=window)
    _close(got, want, F32_TOL)


# ------------------------------------------------------- model + step
def _cfgs(layers):
    return (rg.reduced().replace(num_layers=layers),
            jrg.reduced().replace(num_layers=layers))


def test_forward_matches_jax():
    """One period plus a two-layer rglru tail, window 16 below S=32."""
    cfg, jcfg = _cfgs(5)
    jp = _jit(functools.partial(jbackbone.init_params, jcfg, tp=1,
                                dtype=jnp.float32))(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(3)
    want, _ = _jit(lambda p, t: jbackbone.forward(
        p, t, jcfg, impl="dense", remat=False))(jp, jnp.asarray(tok))
    for remat in (True, False):
        got, aux = backbone.forward(tp, torch.from_numpy(tok).long(), cfg,
                                    remat=remat)
        assert got.dtype == torch.float32 and float(aux) == 0.0
        _close(got, want, FWD_TOL)
    prefill = step.make_prefill_step(cfg, step.RunCfg(), device="cpu")
    _close(prefill(tp, {"tokens": tok}), want, FWD_TOL)
    # the tree: one stacked subtree per period position, unstacked tail
    leaves, _ = tree_flatten(tp)
    assert [tuple(l.shape) for l in leaves] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert len(tp["stack"]["tail"]) == 2 and "head" not in tp


@pytest.fixture(scope="module")
def jax_runs():
    """Two JAX train steps per dtype, from one init. The reference runs
    its plain dense attention without remat, the cheapest program to
    compile with the same math (the port keeps its defaults: remat on,
    and the attention kernel's path). It runs at grad_accum 1 only:
    accumulating two half batches' gradients in f32 is the same math as
    one batch (JAX's own grad_accum 2 agrees with its grad_accum 1 to
    rounding), so one compiled step per dtype holds both of the port's
    settings."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jd = jnp.dtype(dt)
        state = _jit(functools.partial(
            jstep.init_state, _cfgs(3)[1], jstep.RunCfg(param_dtype=jd)))(
                jax.random.PRNGKey(4))
        start = jax.tree.map(np.asarray, state["params"])
        run = jstep.RunCfg(adam=JAdamCfg(**ADAM), param_dtype=jd,
                           attention_impl="dense", remat=False)
        fn = _jit(jstep.make_train_step(_cfgs(3)[1], run, None))
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
    start, want_stats, want_params = jax_runs[dtype]
    cfg = _cfgs(3)[0]
    td = getattr(torch, dtype)
    run = step.RunCfg(adam=AdamCfg(**ADAM), param_dtype=td,
                      grad_accum=grad_accum)
    params = params_from_numpy(start, "cpu")
    state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    fn = step.make_train_step(cfg, run, device="cpu")
    f32 = dtype == "float32"
    for i, (loss, gnorm) in enumerate(want_stats):
        state, st = fn(state, {"tokens": _tokens(i)})
        tol = LOSS_TOL if f32 else BF16_LOSS_TOL
        _close(st["loss"], loss, tol)
        _close(st["grad_norm"], gnorm, tol * max(1.0, gnorm))
    got = tree_leaves(state["params"])
    want = jax.tree.leaves(want_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w.astype(np.float32), PARAM_TOL if f32 else BF16_PARAM_TOL)


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, None])
def test_inplace_update_is_bitwise_adam_update(param_dtype):
    """adam_update_ writes what adam_update returns, bit for bit, over a
    mixed tree (bf16 weights, f32 gates, a None subtree), with slices
    smaller than a leaf."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen) \
        .to(dt)
    params = {"w": rnd(33, 7), "lam": rnd(7, dt=torch.float32),
              "stack": {"scan": (None, {"x": rnd(3, 5)}), "tail": ()}}
    opt = opt_mod.init_opt_state(params)
    cfg = AdamCfg(lr=1e-2, warmup_steps=1)
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(p.dtype), params)
        want_p, want_opt, want_st = opt_mod.adam_update(
            grads, opt, cfg, param_dtype)
        grads = tree_leaves(grads)
        old = opt_mod.INPLACE_CHUNK
        opt_mod.INPLACE_CHUNK = 16
        try:
            params, st = opt_mod.adam_update_(params, grads, opt, cfg,
                                              param_dtype)
        finally:
            opt_mod.INPLACE_CHUNK = old
        for got, want in zip(tree_leaves((params, opt, st)),
                             tree_leaves((want_p, want_opt, want_st))):
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_state_is_updated_in_place():
    cfg = _cfgs(3)[0]
    run = step.RunCfg(adam=AdamCfg(**ADAM), param_dtype=torch.float32)
    state = step.init_state(cfg, run, device="cpu")
    before = [t.data_ptr() for t in tree_leaves(state) if t.dim()]
    fn = step.make_train_step(cfg, run, device="cpu")
    state, _ = fn(state, {"tokens": _tokens(0)})
    assert [t.data_ptr() for t in tree_leaves(state) if t.dim()] == before


# ----------------------------------------------------------- registry
def test_registry_matches_reference():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert list(registry.all_cells()) == list(jregistry.all_cells())
    for a in registry.ARCH_IDS + ("gpt-medium",):
        for mine, ref in ((registry.get_config(a), jregistry.get_config(a)),
                          (registry.reduced_config(a),
                           jregistry.reduced_config(a))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    ported = {"recurrentgemma-2b": 2_894_574_080,
              "qwen2-moe-a2.7b": 14_315_587_584,
              "stablelm-1.6b": 1_644_267_520,
              "xlstm-350m": 430_634_080,
              "deepseek-v2-lite-16b": 16_210_324_992,
              "whisper-medium": 1_012_314_112}
    for a, n in ported.items():
        assert registry.count_params(registry.get_config(a)) == n
    for a in ported:
        cfg = jregistry.reduced_config(a)
        assert registry.count_params(registry.reduced_config(a)) == \
            jregistry.count_params(cfg)


# ------------------------------------------------- convert, checkpoint
def _mixed_tree(layers):
    """The reference's RecurrentGemma tree in bf16 (f32 lam, b_a and b_x
    among bf16 leaves; with 2 layers the scan is all None), its leaves
    seeded normals in their own dtypes."""
    shapes = jax.eval_shape(functools.partial(
        jbackbone.init_params, _cfgs(layers)[1], tp=1, dtype=jnp.bfloat16),
        jax.random.PRNGKey(6))
    rng = np.random.default_rng(layers)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)


@pytest.mark.parametrize("layers", [2, 5])
def test_convert_carries_the_mixed_tree(layers):
    npt = _mixed_tree(layers)
    tp = params_from_numpy(npt, "cpu")
    if layers == 2:
        assert tp["stack"]["scan"] == (None, None, None)
    dts = {str(l.dtype) for l in tree_leaves(tp)}
    assert dts == {"torch.bfloat16", "torch.float32"}
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(npt)
    for a, b in zip(jax.tree.leaves(npt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_checkpoint_round_trip(tmp_path):
    tp = params_from_numpy(_mixed_tree(5), "cpu")
    state = {"params": tp, "opt": opt_mod.init_opt_state(tp)}
    path = str(tmp_path / "c" / "rg-0000007.pkl")
    nbytes = ckpt.save(path, state, 7)
    assert nbytes == ckpt.tree_bytes(state)
    back, step_ = ckpt.load(path)
    assert step_ == 7
    assert tree_flatten(back)[1] == tree_flatten(state)[1]
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert list(tmp_path.glob("c/*")) == [tmp_path / "c" / "rg-0000007.pkl"]


# ------------------------------------------------------------ launcher
def test_launcher_resume_matches_unbroken_run(tmp_path, capsys):
    common = ["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--log-every", "1"]
    whole = launch.main(common + ["--steps", "4", "--ckpt-every", "50",
                                  "--ckpt-dir", str(tmp_path / "a")])
    first = launch.main(common + ["--steps", "2", "--ckpt-every", "2",
                                  "--ckpt-dir", str(tmp_path / "b")])
    rest = launch.main(common + ["--steps", "4", "--ckpt-every", "2",
                                 "--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-2b params=" in out
    assert "resumed from" in out and out.count("TRAINING DONE") == 3
    assert [h["step"] for h in rest] == [3, 4]
    pick = lambda hs: [(h["loss"], h["grad_norm"], h["lr"]) for h in hs]
    assert pick(first + rest) == pick(whole)
    assert all(np.isfinite(h["loss"]) for h in whole)
