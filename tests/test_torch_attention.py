"""The port's attention (kernel wrappers on CPU tensors, i.e. their plain
versions) held against the JAX package on the same seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import attention as att

F32_TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# test_kernels.py's four shapes with S cut to <= 256; the last case runs
# d=64, the GPT-medium head dim, in place of its d=256 (which
# tests/test_torch_recurrentgemma.py holds against dense_attention with
# a window).
@pytest.mark.parametrize("bh,s,d,causal,dtype", [
    (2, 256, 128, True, "float32"),
    (1, 256, 128, False, "float32"),
    (4, 128, 128, True, "bfloat16"),
    (1, 256, 64, True, "float32"),
])
def test_flash_attention_matches_jax(bh, s, d, causal, dtype):
    q, k, v = _inputs(bh * s + d, *[(bh, 1, s, d)] * 3)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal,
                                       interpret=True)
    want_ref = jref.attention(jq[:, 0], jk[:, 0], jv[:, 0], causal=causal)
    got = ops.flash_attention(_t(q, td), _t(k, td), _t(v, td),
                              causal=causal)
    assert got.dtype == td and got.shape == (bh, 1, s, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:, 0], np.asarray(want_ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("g", [1, 2])
def test_attend_matches_dense_attention(g):
    B, S, N, K = 2, 32, 2, 16
    q, k, v = _inputs(g, (B, S, N, g, K), (B, S, N, K), (B, S, N, K))
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want = jatt.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                jnp.asarray(pos))
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    got = att.attend(_t(q), _t(k), _t(v), tpos, tpos, impl="dense")
    plain = att.dense_attention(_t(q), _t(k), _t(v), tpos, tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_attend_refuses_windowed_attention():
    """attend refuses a window it cannot mean (a negative one); a window
    of 0 or more goes to the kernel, as the local_attn tests of
    test_torch_recurrentgemma.py show."""
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="window"):
        att.attend(q, k, k, pos, pos, window=-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_backward_matches_autograd_and_jax_vjp(causal, d):
    bh, s = 3, 48
    q, k, v, do = _inputs(d + causal, *[(bh, s, d)] * 4)
    scale = d ** -0.5
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = fa.attention_fwd_ref(tq, tk, tv, causal, scale)
    got = fa.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, scale)

    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ref.attention(*leaves, causal=causal).backward(tdo)
    via_autograd = [t.grad for t in leaves]

    # dense_attention over (B=bh, S, N=1, G=1, K)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (bh, s))
    fn = lambda a, b, c: jatt.dense_attention(
        a[:, :, None, None], b[:, :, None], c[:, :, None], pos, pos,
        causal=causal)[:, :, 0, 0]
    _, pull = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    via_jax = pull(jnp.asarray(do))

    fn_grads = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fa.FlashAttentionFn.apply(*fn_grads, causal, scale).backward(tdo)
    for g, a, j, f in zip(got, via_autograd, via_jax, fn_grads):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        assert torch.equal(f.grad, g)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_returns_the_row_sums_of_do_times_o(causal):
    """flash_bwd's fourth output, delta = rowsum(dO * O), which the dq
    kernel writes and the dkdv kernel reads in place of O, against the
    JAX package's attention output; its gradients are the plain
    version's."""
    bh, s, d = 2, 40, 32
    q, k, v, do = _inputs(11 + causal, *[(bh, s, d)] * 4)
    scale = d ** -0.5
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = fa.flash_fwd(tq, tk, tv, causal, scale)
    *grads, delta = fa.flash_bwd(tq, tk, tv, o, lse, tdo, causal, scale)
    for g, r in zip(grads, fa.attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                                causal, scale)):
        assert torch.equal(g, r)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (bh, s))
    jo = jatt.dense_attention(
        jnp.asarray(q)[:, :, None, None], jnp.asarray(k)[:, :, None],
        jnp.asarray(v)[:, :, None], pos, pos, causal=causal)[:, :, 0, 0]
    np.testing.assert_allclose(delta.numpy(),
                               np.sum(do * np.asarray(jo), -1),
                               rtol=F32_TOL, atol=F32_TOL)


def test_forward_lse_is_the_log_normalizer():
    q, k, v = _inputs(7, *[(2, 40, 32)] * 3)
    o, lse = fa.attention_fwd_ref(_t(q), _t(k), _t(v), True, 32 ** -0.5)
    s = torch.einsum("bsk,btk->bst", _t(q), _t(k)) * 32 ** -0.5
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=F32_TOL,
                               atol=F32_TOL)
    torch.testing.assert_close(o, ref.attention(_t(q), _t(k), _t(v)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("d", [48, 512])
def test_unsupported_head_dim_raises(d):
    q = torch.zeros(1, 64, d)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[None], q[None], q[None])


def test_cpu_tensors_never_count_kernel_launches():
    fa.reset_launches()
    q = torch.randn(1, 64, 16, requires_grad=True)
    fa.flash_attention(q, q, q).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                           "flash_bwd_dq": 0}
