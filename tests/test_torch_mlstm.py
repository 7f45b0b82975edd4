"""The port's chunkwise mLSTM held against the JAX package: the plain
version against the Pallas kernel in interpret mode and the reference's
stepwise and model-level oracles, and the autograd.Function's backward
(the plain backward, on the CPU) against jax.vjp of the reference's
model-level function, and the plain versions of the kernels' passes
against both."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import xlstm as jxlstm
from repro_torch.kernels import mlstm as ml
from repro_torch.kernels import ops, ref

# f32 forward: the chunked and stepwise algebra round differently (as in
# tests/test_kernels.py); gradients: max |got - want| over max |want|,
# the stabilizers' terms that jax.vjp carries cancelling to rounding
FWD_TOL, GRAD_TOL = 1e-4, 1e-4
BF16_TOL = 1e-2              # bf16 outputs round to 8 bits


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


def _inputs(seed, bh, s, kd, scale=0.3, li_sd=0.5, li_mean=0.0):
    """q, k, v ~ scale N(0, 1), log_i ~ li_mean + li_sd N(0, 1), log_f =
    log_sigmoid(N(0, 1) + 2), as tests/test_kernels.py draws them."""
    q, k, v = (_x(seed + i, bh, s, kd, scale=scale) for i in range(3))
    li = _x(seed + 3, bh, s, scale=li_sd) + np.float32(li_mean)
    lf = -np.logaddexp(0.0, -(_x(seed + 4, bh, s) + 2.0)).astype(np.float32)
    return q, k, v, li, lf


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("s,kd,chunk", [(256, 128, 64), (128, 128, 32),
                                        (192, 64, 64)])
def test_plain_matches_pallas_interpret_and_stepwise(s, kd, chunk):
    ins = _inputs(s + kd, 2, s, kd)
    j = [jnp.asarray(a) for a in ins]
    pallas = jops.mlstm_chunkwise(*j, chunk=chunk, interpret=True)
    stepwise = jref.mlstm_stepwise(*j)
    t = [torch.from_numpy(a) for a in ins]
    for got in (ref.mlstm_chunkwise(*t, chunk=chunk),
                ml.mlstm_fwd(*t, chunk)[0],
                ops.mlstm_chunkwise(*t, chunk=chunk)):
        assert got.dtype == torch.float32 and got.shape == (2, s, kd)
        _close(got, pallas, FWD_TOL)
        _close(got, stepwise, FWD_TOL)
    _close(ref.mlstm_stepwise(*t), stepwise, FWD_TOL)


def test_head_dim_512_matches_model_function():
    """The path's head dim (2 * 1024 / 4) at a short sequence."""
    ins = _inputs(5, 2, 128, 512)
    j = [jnp.asarray(a)[:, None] for a in ins]
    want, _ = jxlstm.mlstm_chunkwise(*j, None, chunk=64)
    got = ops.mlstm_chunkwise(*(torch.from_numpy(a) for a in ins), chunk=64)
    _close(got, want[:, 0], FWD_TOL)


@jax.jit
def _model_vjp(q, k, v, li, lf, dh):
    chunk = q.shape[1] // 3
    fn = lambda *a: jxlstm.mlstm_chunkwise(
        *(x[:, None] for x in a), None, chunk=chunk)[0][:, 0]
    return jax.vjp(fn, q, k, v, li, lf)[1](dh)


# three chunks each; log_i around +1..+2 with unit q, k makes the
# exp(-m_loc) floor win on some rows and |den| on the others
@pytest.mark.parametrize("bh,s,kd,li_sd,li_mean", [(2, 192, 64, 1.0, 1.0),
                                                   (3, 96, 128, 2.0, 2.0)])
def test_backward_matches_jax_vjp(bh, s, kd, li_sd, li_mean):
    chunk = s // 3
    ins = _inputs(bh + s, bh, s, kd, scale=1.0, li_sd=li_sd,
                  li_mean=li_mean)
    dh = _x(9, bh, s, kd)
    want = _model_vjp(*(jnp.asarray(a) for a in ins), jnp.asarray(dh))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ops.mlstm_chunkwise(*leaves, chunk=chunk).backward(torch.from_numpy(dh))
    for name, g, w in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), leaves,
                          want):
        assert _rel(g.grad, w) <= GRAD_TOL, name

    # the floor wins on some rows but not all
    _, (_, _, _, m_loc, den) = ml.mlstm_fwd_ref(*(torch.from_numpy(a)
                                                  for a in ins), chunk)
    floor = den.abs() < torch.exp(-m_loc)
    assert 0 < int(floor.sum()) < floor.numel()


def test_plain_backward_is_autograd_of_the_plain_forward():
    """The kernels' backward algebra against torch's own gradient of the
    chunked forward (stabilizers differentiated and all)."""
    bh, s, kd, chunk = 2, 96, 64, 32
    ins = _inputs(21, bh, s, kd, scale=1.0, li_sd=1.0, li_mean=1.0)
    dh = torch.from_numpy(_x(22, bh, s, kd))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ref.mlstm_chunkwise(*leaves, chunk=chunk).backward(dh)
    t = [torch.from_numpy(a) for a in ins]
    h, aux = ml.mlstm_fwd(*t, chunk)
    got = ml.mlstm_bwd(*t, h, dh, aux, chunk)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32
        assert _rel(g, leaf.grad.numpy()) <= GRAD_TOL


def test_bf16_inputs_keep_their_dtype_through_the_function():
    bh, s, kd, chunk = 2, 64, 64, 16
    ins = _inputs(31, bh, s, kd)
    f32 = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    bf = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in ins]
    dh = torch.from_numpy(_x(32, bh, s, kd))
    out32, out16 = (ops.mlstm_chunkwise(*x, chunk=chunk) for x in (f32, bf))
    assert out16.dtype == torch.bfloat16
    assert _rel(out16, out32.detach().numpy()) <= BF16_TOL
    out32.backward(dh)
    out16.backward(dh.to(torch.bfloat16))
    for a, b in zip(f32, bf):
        assert b.grad.dtype == torch.bfloat16
        assert _rel(b.grad, a.grad.numpy()) <= 3 * BF16_TOL


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.rand(2, 64, 64)
    g = torch.rand(2, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        ml.mlstm_fwd(q[..., :32], q[..., :32], q[..., :32], g, g, 16)
    big = torch.rand(1, 8, 576)
    with pytest.raises(ValueError, match="up to 512"):
        ml.mlstm_fwd(big, big, big, g[:1, :8], g[:1, :8], 8)
    with pytest.raises(ValueError, match="divide"):
        ml.mlstm_fwd(q, q, q, g, g, 24)
    with pytest.raises(ValueError, match=r"\[1, 64\]"):
        ml.mlstm_fwd(torch.rand(1, 130, 64), torch.rand(1, 130, 64),
                     torch.rand(1, 130, 64), g[:1, :1].expand(1, 130),
                     g[:1, :1].expand(1, 130), 65)
    with pytest.raises(ValueError, match="one dtype"):
        ml.mlstm_fwd(q, q.bfloat16(), q, g, g, 16)
    with pytest.raises(ValueError, match="log gates"):
        ml.mlstm_fwd(q, q, q, g[:, :32], g, 16)


def test_cpu_tensors_never_count_kernel_launches():
    ml.reset_launches()
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in _inputs(41, 1, 32, 64)]
    ops.mlstm_chunkwise(*ins, chunk=16).sum().backward()
    assert ml.LAUNCHES == {"mlstm_fwd": 0, "mlstm_bwd_dqdk": 0,
                           "mlstm_bwd_dv": 0}


# the kernels' passes, composed, against the Pallas kernel, jax.vjp and
# the one-pass plain versions: K 64 and 192, chunks 16 and 20, three or
# four chunks so that the state carries, f32 and bf16
PASS_CASES = [(64, 16, 48, torch.float32), (192, 20, 60, torch.float32),
              (64, 20, 80, torch.bfloat16), (192, 16, 48, torch.bfloat16)]


@functools.partial(jax.jit, static_argnames="chunk")
def _vjp_at(q, k, v, li, lf, dh, chunk):
    fn = lambda *a: jxlstm.mlstm_chunkwise(
        *(x[:, None] for x in a), None, chunk=chunk)[0][:, 0]
    return jax.vjp(fn, q, k, v, li, lf)[1](dh)


@functools.lru_cache(maxsize=None)
def _pass_case(kd, chunk, s, dtype):
    """Seeded inputs (q, k, v, dh rounded to `dtype`) and the JAX
    package's h (Pallas, interpret mode) and dq, dk (jax.vjp of the
    model-level function) on them, computed once per case."""
    ins = _inputs(kd + chunk, 2, s, kd, scale=1.0, li_sd=1.0, li_mean=1.0)
    dh = _x(kd + 7, 2, s, kd)
    t = [torch.from_numpy(a) for a in ins]
    t[:3] = [x.to(dtype) for x in t[:3]]
    dht = torch.from_numpy(dh).to(dtype)
    j = [jnp.asarray(x.float().numpy()) for x in t]
    pallas = jops.mlstm_chunkwise(*j, chunk=chunk, interpret=True)
    dq, dk = _vjp_at(*j, jnp.asarray(dht.float().numpy()), chunk=chunk)[:2]
    return t, dht, np.asarray(pallas), np.asarray(dq), np.asarray(dk)


@pytest.mark.parametrize("kd,chunk,s,dtype", PASS_CASES)
def test_forward_passes_match_pallas_and_the_one_pass_forward(kd, chunk, s,
                                                              dtype):
    t, _, pallas, _, _ = _pass_case(kd, chunk, s, dtype)
    C, n, m = ml.mlstm_fwd_states_ref(t[1], t[2], t[3], t[4], chunk)
    h, m_loc, den = ml.mlstm_fwd_out_ref(*t, C, n, m, chunk)
    assert h.dtype == dtype and h.shape == (2, s, kd)
    if dtype == torch.float32:
        _close(h, pallas, FWD_TOL)
    else:
        assert _rel(h, pallas) <= BF16_TOL
    want_h, want_aux = ml.mlstm_fwd_ref(*t, chunk)
    assert _rel(h, want_h.float().numpy()) <= FWD_TOL
    for got, want in zip((C, n, m[:, 1:], m_loc, den),
                         (*want_aux[:2], want_aux[2][:, 1:], *want_aux[3:])):
        assert _rel(got, want.numpy()) <= FWD_TOL
    assert torch.equal(m[:, 0], want_aux[2][:, 0])   # -1e30 both


@pytest.mark.parametrize("kd,chunk,s,dtype", PASS_CASES)
def test_backward_passes_match_jax_vjp_and_the_one_pass_backward(kd, chunk,
                                                                 s, dtype):
    t, dh, _, jdq, jdk = _pass_case(kd, chunk, s, dtype)
    h, aux = ml.mlstm_fwd_ref(*t, chunk)
    dC, dn = ml.mlstm_bwd_dC_ref(t[0], t[3], t[4], h, dh, aux, chunk)
    nc = s // chunk
    assert dC.shape == (2, nc, kd, kd) and dn.shape == (2, nc, kd)
    # nothing follows the last chunk
    assert not dC[:, -1].any() and not dn[:, -1].any()
    dq, dk = ml.mlstm_bwd_dqdk_ref(*t, h, dh, aux, dC, dn, chunk)
    # the JAX side keeps h in f32 where bf16 rounds it (dh.h in dden)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(dq, jdq) <= tol and _rel(dk, jdk) <= tol
    want = ml.mlstm_bwd_ref(*t, h, dh, aux, chunk)
    assert _rel(dq, want[0].numpy()) <= GRAD_TOL
    assert _rel(dk, want[1].numpy()) <= GRAD_TOL
    # the dq/dk wrapper on CPU tensors runs these passes
    got = ml.mlstm_bwd_dqdk(*t, h, dh, aux, chunk)
    for g, w in zip(got, (dq, dk, dC, dn)):
        assert torch.equal(g, w)
