"""Whisper-medium's serving path held against the JAX package at the
reduced config (2 encoder + 2 decoder layers, d 64, encoder_seq 32):
the decode cache tree with its cross K/V, `setup_cross_cache` (the
encoder run once, each layer's cross K/V written in place),
`decode_step` token by token (logits and the whole cache tree),
decode against the port's own forward at the reference's tolerance
(tests/test_archs_smoke.py), and `make_serve_step`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import (decode_against_jax, jit, one_torch_thread,
                            to_port, tokens, trees_close, x)
from repro.models import backbone as jbackbone
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import backbone, registry
from repro_torch.train import step
from repro_torch.tree import tree_leaves

ARCH = "whisper-medium"
# f32: sums in other orders over a few layers; a bf16 cache holds both
# sides' f32 keys and values rounded to 8 bits (a value within an f32
# rounding of a bf16 midpoint can round either way); bf16 weights and
# frames: every activation rounded to 8 bits on both sides
F32_TOL, BF16_CACHE_TOL, BF16_TOL = 1e-5, 1e-2, 2e-2
# decode against the forward at bf16 weights and caches: the reference's
# own bound (tests/test_archs_smoke.py:86-87)
REF_RTOL = REF_ATOL = 0.05
B = 2


def _cfgs():
    return registry.reduced_config(ARCH), jregistry.reduced_config(ARCH)


def _frames(cfg, seed, dtype="float32"):
    return x(seed, B, cfg.encoder_seq, cfg.d_model, scale=0.02).astype(
        jnp.dtype(dtype))


def test_cache_tree_and_convert_match_jax():
    """init_cache's tree is the reference's leaf for leaf (each layer's
    {"self": KV cache, "cross_k", "cross_v"} stacked, the int32 pos per
    layer) in f32 and bf16, zeros until setup; convert carries a filled
    cache both ways with the same bytes."""
    cfg, jcfg = _cfgs()
    for dt in ("float32", "bfloat16"):
        jc = jax.eval_shape(lambda: jbackbone.init_cache(
            jcfg, B, 12, tp=1, dtype=jnp.dtype(dt)))
        mine = backbone.init_cache(cfg, B, 12, dtype=getattr(torch, dt),
                                   device="cpu")
        got, want = tree_leaves(mine), jax.tree.leaves(jc)
        assert [(tuple(a.shape), str(a.dtype)[6:]) for a in got] == \
            [(b.shape, str(b.dtype)) for b in want]
        assert not any(t.any() for t in got)
    assert sorted(mine["scan"][0]) == ["cross_k", "cross_v", "self"]
    assert tuple(mine["scan"][0]["cross_k"].shape) == \
        (cfg.num_layers, B, cfg.encoder_seq, 4, 16)
    jc = jax.tree.map(lambda a: a + 1, jbackbone.init_cache(jcfg, B, 12))
    back = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jc),
                                             "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("weights,frames,cache,tol", [
    ("float32", "float32", "float32", F32_TOL),
    ("bfloat16", "float32", "float32", F32_TOL),
    ("bfloat16", "bfloat16", "bfloat16", BF16_TOL)])
def test_setup_cross_cache_matches_jax(weights, frames, cache, tol):
    """setup_cross_cache against the reference's: the whole cache tree
    after it (each decoder layer's cross K/V from the encoder's output,
    no RoPE, cast to the cache's dtype; the self caches untouched). f32
    frames beside bf16 weights run the encoder in f32, as the launcher
    and the reference do. The cache is written in place: the same tree
    and the same buffers come back, and nothing else is allocated for
    them."""
    cfg, jcfg = _cfgs()
    jp = jbackbone.init_params(jcfg, jax.random.PRNGKey(11), tp=1,
                               dtype=jnp.dtype(weights))
    fr = _frames(cfg, 12, frames)
    jc = jbackbone.init_cache(jcfg, B, 8, tp=1, dtype=jnp.dtype(cache))
    want = jit(lambda p, c, f: jbackbone.setup_cross_cache(p, c, f, jcfg))(
        jp, jc, jnp.asarray(fr))
    mine = to_port(jc)
    ptrs = [t.data_ptr() for t in tree_leaves(mine)]
    got = backbone.setup_cross_cache(to_port(jp), mine,
                                     params_from_numpy(fr, "cpu"), cfg)
    assert got is mine and [t.data_ptr() for t in tree_leaves(got)] == ptrs
    assert all(bool(t.any()) for t in (got["scan"][0]["cross_k"],
                                       got["scan"][0]["cross_v"]))
    trees_close(got, want, tol)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(cache_dtype):
    """Token by token from empty self caches after each side's
    setup_cross_cache, the reference's f32 weights and f32 frames: the
    cross cache, then the logits and the whole cache tree after each of
    10 tokens."""
    cfg, jcfg = _cfgs()
    tol = F32_TOL if cache_dtype == "float32" else BF16_CACHE_TOL
    decode_against_jax(cfg, jcfg, 13, B, 10, 12, cache_dtype, tol,
                       frames=_frames(cfg, 14))


def test_decode_matches_forward():
    """The reference's test on the port alone: bf16 weights, a bf16
    cache and bf16 frames, B 2, decode token by token after
    setup_cross_cache against the full forward at rtol = atol = 0.05."""
    cfg = registry.reduced_config(ARCH)
    S = 16
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(tokens(15, B, S, cfg.vocab_size)).long()
    fr = params_from_numpy(_frames(cfg, 16, "bfloat16"), "cpu")
    full, _ = backbone.forward(params, tok, cfg, frames=fr, remat=False)
    cache = backbone.setup_cross_cache(
        params, backbone.init_cache(cfg, B, S, device="cpu"), fr, cfg)
    serve = step.make_serve_step(cfg, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = serve(params, cache, tok[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=REF_RTOL, atol=REF_ATOL)


def test_make_serve_step_matches_decode_step():
    """make_serve_step on the CPU is decode_step without gradients: the
    same logits and caches bit for bit from numpy tokens, and no graph
    even when the weights require gradients; setup_cross_cache builds
    none either."""
    cfg = registry.reduced_config(ARCH)
    params = backbone.init_params(cfg, torch.Generator().manual_seed(1),
                                  dtype=torch.float32)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    fr = torch.from_numpy(_frames(cfg, 17))
    caches = [backbone.setup_cross_cache(
        params, backbone.init_cache(cfg, B, 6, dtype=torch.float32,
                                    device="cpu"), fr, cfg)
        for _ in "ab"]
    assert not any(t.requires_grad for t in tree_leaves(caches[0]))
    serve = step.make_serve_step(cfg, device="cpu")
    for t in range(4):
        tok = tokens(18 + t, B, 1, cfg.vocab_size)
        got, caches[0] = serve(params, caches[0], tok)
        with torch.no_grad():
            want, caches[1] = backbone.decode_step(
                params, caches[1], torch.from_numpy(tok).long(), cfg)
        assert not got.requires_grad and torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(caches[0]), tree_leaves(caches[1])))
    assert int(caches[0]["scan"][0]["self"]["pos"][0]) == 4
