"""Shared pieces of the port's decode tests against the JAX package
(imported by tests/test_torch_decode*.py; it holds no tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_jax_engine import LOW_OPT
from repro.models import backbone as jbackbone
from repro_torch.convert import params_from_numpy
from repro_torch.models import backbone
from repro_torch.tree import tree_leaves


def jit(fn, **kw):
    """jax.jit at XLA's lowest CPU optimisation level: the reference's
    programs build about twice as fast, and tiny shapes lose nothing."""
    return jax.jit(fn, compiler_options=LOW_OPT, **kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def tokens(seed, b, s, v=256):
    return np.random.default_rng(seed).integers(0, v, (b, s)) \
        .astype(np.int32)


def to_port(tree):
    """A JAX tree (params, cache) as the port's tensors on the CPU."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|): sums of many products
    round with their size."""
    want = f32(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(f32(got) / scale, want / scale, rtol=tol,
                               atol=tol)


def trees_close(got, want, tol):
    """Leaf by leaf in the reference's order: the same shapes, int leaves
    (pos) equal, float leaves within `tol` (see `close`)."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        if jnp.issubdtype(b.dtype, jnp.integer):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b, tol)


def decode_against_jax(cfg, jcfg, seed, b, steps, max_len, cache_dtype, tol,
                       serve=None, frames=None):
    """The reference's f32 weights (key `seed`) through both decode_steps
    for `steps` tokens from empty caches of `max_len` slots in
    `cache_dtype`: the logits and the whole cache tree after every
    token. `serve` (port) defaults to backbone.decode_step. With
    `frames` (numpy), each side's setup_cross_cache first fills the
    cross K/V from its own encoder, and the trees are compared then."""
    jp = jit(lambda k: jbackbone.init_params(jcfg, k, tp=1,
                                             dtype=jnp.float32))(
        jax.random.PRNGKey(seed))
    jc = jbackbone.init_cache(jcfg, b, max_len, tp=1,
                              dtype=jnp.dtype(cache_dtype))
    params, cache = to_port(jp), to_port(jc)
    assert [t.dtype for t in tree_leaves(cache)] == \
        [getattr(torch, str(l.dtype)) for l in jax.tree.leaves(jc)]
    if frames is not None:
        jc = jit(lambda p, c, f: jbackbone.setup_cross_cache(p, c, f, jcfg))(
            jp, jc, jnp.asarray(frames))
        assert backbone.setup_cross_cache(
            params, cache, params_from_numpy(frames, "cpu"), cfg) is cache
        trees_close(cache, jc, tol)
    serve = serve or (lambda p, c, t: backbone.decode_step(p, c, t, cfg))
    jstep = jit(lambda p, c, t: jbackbone.decode_step(p, c, t, jcfg))
    tok = tokens(seed + 1, b, steps, cfg.vocab_size)
    for t in range(steps):
        want, jc = jstep(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        got, cache = serve(params, cache, torch.from_numpy(
            tok[:, t:t + 1]).long())
        assert got.shape == want.shape and got.dtype == torch.float32
        close(got, want, tol)
        trees_close(cache, jc, tol)
    return cache
