"""Whisper-medium's training path held against the JAX package at the
reduced config (2 encoder + 2 decoder layers, d 64, encoder_seq 32):
the `enc_attn` and `attn_cross` blocks, the parameter tree with its
encoder stack and `convert`, `backbone.forward` with f32 and bf16
frames (the encoder runs in the dtype the frames and weights promote
to), one `make_train_step` step against `jax.jit(make_train_step)`,
and the launcher. Decode is in tests/test_torch_whisper_decode.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import close, jit, one_torch_thread, to_port, tokens, x
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.train import step as jstep
from repro.train.optimizer import AdamCfg as JAdamCfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch
from repro_torch.models import backbone, blocks, registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.train.optimizer import AdamCfg
from repro_torch.tree import tree_leaves

ARCH = "whisper-medium"
# f32: the same products summed in other orders over a few layers; bf16:
# activations rounded to 8 bits at every op on both sides; after one Adam
# step a parameter moves by about lr, and its sign can flip where a
# moment is near zero
F32_TOL, BF16_TOL, PARAM_TOL = 1e-5, 2e-2, 1e-4
B, S = 2, 16
ADAM = dict(lr=1e-3, warmup_steps=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs():
    return registry.reduced_config(ARCH), jregistry.reduced_config(ARCH)


def _frames(cfg, seed, dtype="float32"):
    """Frame embeddings (B, encoder_seq, D) at the scale train/data.py
    draws them, as numpy in `dtype` (ml_dtypes' bfloat16 for bf16)."""
    f = x(seed, B, cfg.encoder_seq, cfg.d_model, scale=0.02)
    return f.astype(jnp.dtype(dtype))


def _paths(tree, prefix=()):
    """(path, leaf) in the reference's leaf order: dict keys sorted,
    tuples by index, None an empty subtree."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, t in enumerate(tree) for pl in _paths(t,
                                                               prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def _jpaths(tree):
    def key(k):
        return getattr(k, "key", getattr(k, "idx", None))
    return [(tuple(key(k) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------- blocks
@pytest.mark.parametrize("btype,dtype,enc_dtype", [
    ("enc_attn", "float32", None), ("enc_attn", "bfloat16", None),
    ("attn_cross", "float32", "float32"),
    ("attn_cross", "bfloat16", "float32"),
    ("attn_cross", "bfloat16", "bfloat16")])
def test_block_matches_jax(btype, dtype, enc_dtype):
    """apply_block against the reference's (attention impl="dense") on
    the same weights and inputs: the encoder's block non-causal over 32
    frames; the decoder's causal self-attention, then the cross-attention
    over a 32-frame encoder output, which in the launcher's case is f32
    beside a bf16 decoder (bf16, f32)."""
    cfg, jcfg = _cfgs()
    jdt, tdt = DTYPES[dtype]
    s = cfg.encoder_seq if btype == "enc_attn" else S
    jp = jblocks.init_block(jax.random.PRNGKey(1), btype, jcfg, 1, jdt)
    xin = x(2, B, s, cfg.d_model).astype(jdt)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (B, s))
    kw, jkw = {}, {}
    if enc_dtype:
        enc = x(3, B, cfg.encoder_seq, cfg.d_model).astype(
            jnp.dtype(enc_dtype))
        epos = np.broadcast_to(
            np.arange(cfg.encoder_seq, dtype=np.int32)[None],
            (B, cfg.encoder_seq))
        jkw = dict(enc_out=jnp.asarray(enc), enc_positions=jnp.asarray(epos))
        kw = dict(enc_out=params_from_numpy(enc, "cpu"),
                  enc_positions=torch.from_numpy(epos.copy()))
    want, _ = jit(lambda p, xx, pp, kk: jblocks.apply_block(
        btype, p, xx, jcfg, 1, positions=pp, impl="dense", **kk))(
        jp, jnp.asarray(xin), jnp.asarray(pos), jkw)
    got, aux = blocks.apply_block(btype, to_port(jp),
                                  params_from_numpy(xin, "cpu"), cfg, 1,
                                  positions=torch.from_numpy(pos.copy()),
                                  **kw)
    assert got.dtype == tdt and str(want.dtype) == dtype and \
        float(aux) == 0.0
    close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# ------------------------------------------------------ parameter tree
def test_init_tree_and_convert_match_jax():
    """init_params' tree, the encoder stack and enc_final_ln among the
    reference's leaves, path for path with its shapes and dtypes (f32
    and bf16), count_params at the full config and the reduced one; and
    convert carries the reference's tree both ways with the same
    bytes."""
    cfg, jcfg = _cfgs()
    for dt in ("float32", "bfloat16"):
        want = _jpaths(jax.eval_shape(lambda: jbackbone.init_params(
            jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.dtype(dt))))
        got = _paths(backbone.init_params(cfg, None, dtype=getattr(torch, dt),
                                          device="meta"))
        assert [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in got] == \
            [(p, l.shape, str(l.dtype)) for p, l in want]
    assert {p[0] for p, _ in got} == {"embed", "enc_final_ln", "enc_stack",
                                      "final_ln", "head", "stack"}
    assert registry.count_params(registry.get_config(ARCH)) == 1_012_314_112
    assert registry.count_params(cfg) == jregistry.count_params(jcfg)
    jp = jbackbone.init_params(jcfg, jax.random.PRNGKey(4), tp=1)
    back = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("weights,frames", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_forward_matches_jax(weights, frames):
    """backbone.forward from the reference's weights against its forward
    (impl="dense"), and the encoder's dtype: f32 frames beside bf16
    weights (the launcher's frames) run the encoder in f32, bf16 frames
    (the reference's input_specs) in bf16, as jnp promotes."""
    cfg, jcfg = _cfgs()
    jp = jbackbone.init_params(jcfg, jax.random.PRNGKey(5), tp=1,
                               dtype=jnp.dtype(weights))
    tok, fr = tokens(6, B, S, cfg.vocab_size), _frames(cfg, 7, frames)
    want = jit(lambda p, t, f: jbackbone.forward(
        p, t, jcfg, impl="dense", remat=False, frames=f)[0])(
        jp, jnp.asarray(tok), jnp.asarray(fr))
    params, tfr = to_port(jp), params_from_numpy(fr, "cpu")
    got, aux = backbone.forward(params, torch.from_numpy(tok).long(), cfg,
                                frames=tfr)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    close(got, want, F32_TOL if weights == "float32" else BF16_TOL)
    enc, _ = backbone.encode(params, tfr, cfg)
    assert str(enc.dtype)[6:] == frames
    with pytest.raises(ValueError, match="frames"):
        backbone.forward(params, torch.from_numpy(tok).long(), cfg)


# ---------------------------------------------------------- train step
def test_train_step_matches_jax():
    """One make_train_step step (remat: the encoder's and the decoder's
    periods recomputed in the backward) against jax.jit(make_train_step)
    from the same f32 weights and batch, f32 frames: loss and grad norm,
    then every parameter, the encoder's among them."""
    cfg, jcfg = _cfgs()
    run = jstep.RunCfg(adam=JAdamCfg(**ADAM), param_dtype=jnp.float32,
                       attention_impl="dense", remat=False)
    batch = {"tokens": tokens(8, B, S, cfg.vocab_size),
             "frames": _frames(cfg, 9)}
    train_step = jstep.make_train_step(jcfg, run, None)

    def reference(key, batch):
        state = jstep.init_state(jcfg, run, key)
        new, stats = train_step(state, batch)
        return state["params"], new["params"], stats

    start, jnew, jst = jit(reference)(
        jax.random.PRNGKey(10), {k: jnp.asarray(v) for k, v in batch.items()})
    params = to_port(start)
    state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    fn = step.make_train_step(cfg, step.RunCfg(
        adam=AdamCfg(**ADAM), param_dtype=torch.float32), device="cpu")
    state, st = fn(state, batch)
    close(st["loss"], jst["loss"], F32_TOL)
    close(st["grad_norm"], jst["grad_norm"], F32_TOL)
    got, want = tree_leaves(state["params"]), jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, PARAM_TOL)


@pytest.mark.parametrize("layers", [None, 1])
def test_launcher_trains_whisper(capsys, layers):
    """The launcher (--mesh none) trains the reduced config on the CPU
    from train/data.py's stream, which draws f32 frames; the losses are
    finite and the parameter count is the reference's, also with the
    decoder cut to one layer by --layers (the encoder keeps its own)."""
    jcfg = _cfgs()[1]
    cut = [] if layers is None else ["--layers", str(layers)]
    hist = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--log-every", "1", "--ckpt-every", "100"] + cut)
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    want = jregistry.count_params(
        jcfg if layers is None else jcfg.replace(num_layers=layers))
    assert "TRAINING DONE" in out and f"params={want:,}" in out
