"""The port's RG-LRU held against the JAX package: the scan's plain
version against the Pallas kernel in interpret mode and the reference's
oracle, its backward against jax.vjp, and `apply_rglru` (forward and
gradients) with the reference's own weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_2b as jrg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro_torch.configs import recurrentgemma_2b as rg
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as scan
from repro_torch.models import rglru

# f32: the oracle adds in associative_scan's tree order, the plain
# version in time order; both carry f32, so they agree to rounding.
SCAN_TOL = 1e-5
BF16_TOL = 2e-2              # bf16 outputs round to 8 bits
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn):
    """jax.jit with XLA's CPU backend at its lowest optimisation level:
    the reference programs here compile faster, and tiny shapes lose
    nothing by it."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _gates(seed, b, s, d):
    """a in (0, 1) (a sigmoid, as the model's gates) and x ~ 0.1 N(0,1),
    as tests/test_kernels.py draws them."""
    a = 1.0 / (1.0 + np.exp(-_x(seed, b, s, d)))
    return a.astype(np.float32), _x(seed + 1, b, s, d, scale=0.1)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (B, S, D) and Pallas blocks (s, d) that divide them; the port has no
# tile along S or D, so the odd sizes are its ragged cases
@pytest.mark.parametrize("b,s,d,blk,dtype", [
    (2, 37, 50, (37, 50), "float32"),
    (3, 40, 24, (20, 8), "bfloat16"),
])
def test_plain_scan_matches_pallas_interpret(b, s, d, blk, dtype):
    a, x = _gates(s + d, b, s, d)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ja, jx = jnp.asarray(a).astype(jd), jnp.asarray(x).astype(jd)
    pallas = jops.rglru_scan(ja, jx, block_s=blk[0], block_d=blk[1],
                             interpret=True)
    oracle = jref.rglru_scan(ja, jx)
    ta, tx = torch.from_numpy(a).to(td), torch.from_numpy(x).to(td)
    tol = SCAN_TOL if dtype == "float32" else BF16_TOL
    for got in (scan.rglru_fwd(ta, tx), ref.rglru_scan(ta, tx),
                ops.rglru_scan(ta, tx)):
        assert got.dtype == td and got.shape == (b, s, d)
        _close(got, pallas, tol)
        _close(got, oracle, tol)


@_jit
def _scan_vjp(a, x, g):
    return jax.vjp(jref.rglru_scan, a, x)[1](g)


@pytest.mark.parametrize("b,s,d", [(1, 1, 3), (3, 37, 50), (2, 130, 65)])
def test_scan_backward_matches_jax_vjp(b, s, d):
    a, x = _gates(b * s + d, b, s, d)
    g = _x(7, b, s, d)
    want_da, want_dx = _scan_vjp(jnp.asarray(a), jnp.asarray(x),
                                 jnp.asarray(g))

    ta, tx = (torch.from_numpy(t).requires_grad_(True) for t in (a, x))
    ops.rglru_scan(ta, tx).backward(torch.from_numpy(g))
    _close(ta.grad, want_da, GRAD_TOL)
    _close(tx.grad, want_dx, GRAD_TOL)

    # the kernel's formula is autograd of the plain forward, bit for bit
    ra, rx = (torch.from_numpy(t).requires_grad_(True) for t in (a, x))
    ref.rglru_scan(ra, rx).backward(torch.from_numpy(g))
    da, dx = scan.rglru_bwd(torch.from_numpy(a), ops.rglru_scan(
        torch.from_numpy(a), torch.from_numpy(x)), torch.from_numpy(g))
    assert torch.equal(dx, rx.grad) and torch.equal(da, ra.grad)
    assert torch.equal(ta.grad, da) and torch.equal(tx.grad, dx)


# the kernels' three passes at the chunk edges, chunk length 8: S < L,
# S = L, S = L + 1 and S = 3L + 2; B 1 and 3; odd D; f32, bf16 and mixed
CHUNK = 8
f32, bf16 = "float32", "bfloat16"


@pytest.mark.parametrize("b,s,d,adt,xdt", [
    (1, 5, 7, f32, f32),
    (3, 8, 5, bf16, bf16),
    (3, 9, 7, f32, bf16),
    (1, 9, 7, bf16, f32),
    (1, 26, 9, bf16, f32),
    (3, 26, 33, f32, f32),
])
def test_scan_passes_match_jax_at_chunk_edges(b, s, d, adt, xdt):
    a, x = _gates(3 * s + d, b, s, d)
    g = _x(s + 5, b, s, d)
    ja, jx = jnp.asarray(a).astype(adt), jnp.asarray(x).astype(xdt)
    jg = jnp.asarray(g).astype(xdt)
    ta, tx = torch.from_numpy(a).to(getattr(torch, adt)), \
        torch.from_numpy(x).to(getattr(torch, xdt))
    tg = torch.from_numpy(g).to(tx.dtype)
    tol = SCAN_TOL if adt == xdt == f32 else BF16_TOL

    @_jit
    def jax_refs(ja, jx, jg):
        """The Pallas kernel in interpret mode, the oracle and its vjp,
        compiled as one program."""
        pallas = jops.rglru_scan(ja, jx, block_s=s, block_d=d,
                                 interpret=True)
        oracle, pull = jax.vjp(jref.rglru_scan, ja, jx)
        return pallas, oracle, pull(jg)

    pallas, oracle, (want_da, want_dx) = jax_refs(ja, jx, jg)
    h = scan.rglru_fwd_passes_ref(ta, tx, CHUNK)
    assert h.dtype == tx.dtype and h.shape == (b, s, d)
    _close(h, pallas, tol)
    _close(h, oracle, tol)
    _close(h, scan.rglru_fwd_ref(ta, tx).float(), tol)

    # each chunk's carry is h at the previous chunk's last row
    A, X = scan.rglru_fwd_reduce_ref(ta, tx, CHUNK)
    carry = scan.rglru_carry_ref(A, X)
    nc = -(-s // CHUNK)
    assert carry.shape == (b, nc, d) and carry.dtype == torch.float32
    assert not carry[:, 0].any()
    want = scan.rglru_fwd_ref(ta, tx.float())
    _close(carry[:, 1:], want[:, CHUNK - 1:(nc - 1) * CHUNK:CHUNK], SCAN_TOL)

    da, dx = scan.rglru_bwd_passes_ref(ta, h, tg, CHUNK)
    assert da.dtype == ta.dtype and dx.dtype == tx.dtype
    _close(da, want_da, GRAD_TOL if tol == SCAN_TOL else tol)
    _close(dx, want_dx, GRAD_TOL if tol == SCAN_TOL else tol)
    one_da, one_dx = scan.rglru_bwd_ref(ta, h, tg)
    _close(da, one_da.float(), tol)
    _close(dx, one_dx.float(), tol)

    # each chunk's backward carry is delta at the next chunk's first row
    P, G = scan.rglru_bwd_reduce_ref(ta, tg, CHUNK)
    dcarry = scan.rglru_carry_ref(P, G, reverse=True)
    assert not dcarry[:, -1].any()
    delta = scan.rglru_bwd_ref(ta.float(), h.float(), tg.float())[1]
    _close(dcarry[:, :-1], delta[:, CHUNK:nc * CHUNK:CHUNK], SCAN_TOL)


def test_chunk_len_fills_a_wave_at_the_path_shape():
    # RecurrentGemma-2B's scans: B 1, S 4096, D 2560
    b, s, d = 1, 4096, 2560
    L = scan.chunk_len(b, s, d)
    assert L == scan.chunk_len(b, s, d)
    assert L & (L - 1) == 0 and scan.MIN_CHUNK <= L <= s
    assert b * d * -(-s // L) >= scan.WAVE
    # one step longer would leave the card short of a wave
    assert b * d * -(-s // (2 * L)) < scan.WAVE
    # a wider B * D gets longer chunks, up to one chunk a row; a narrow
    # one the shortest; S shorter than the shortest is one chunk
    widths = [scan.chunk_len(bb, s, d) for bb in (1, 2, 8, 64, 128, 512)]
    assert widths == sorted(widths) and widths[-1] == s
    assert scan.chunk_len(1, s, 8) == scan.MIN_CHUNK
    assert scan.chunk_len(1, 5, 7) >= 5


def test_scan_wrappers_refuse_what_the_kernel_does_not_take():
    a = torch.rand(2, 5, 4)
    with pytest.raises(ValueError, match="shape"):
        scan.rglru_fwd(a, torch.rand(2, 5, 3))
    with pytest.raises(ValueError, match="dtype"):
        scan.rglru_fwd(a, a.half())
    with pytest.raises(ValueError, match="non-empty"):
        scan.rglru_fwd(a[:, :0], a[:, :0])


def test_cpu_tensors_never_count_kernel_launches():
    scan.reset_launches()
    a = torch.rand(1, 9, 4, requires_grad=True)
    ops.rglru_scan(a, a).sum().backward()
    assert scan.LAUNCHES == {"rglru_fwd": 0, "rglru_bwd": 0}


@pytest.fixture(scope="module")
def block():
    cfg = rg.reduced()
    jp = jrglru.init_rglru(jax.random.PRNGKey(5), jrg.reduced(),
                           jnp.float32)
    npt = jax.tree.map(np.asarray, jp)
    return cfg, jp, npt


def test_h0_path_matches_reference(block):
    a, x = _gates(11, B, S, 16)
    h0 = _x(12, B, 16)
    want = _jit(jrglru.rglru_scan)(jnp.asarray(a), jnp.asarray(x),
                                      jnp.asarray(h0))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(x),
                           torch.from_numpy(h0))
    _close(got, want, SCAN_TOL)


def test_apply_rglru_and_gradients_match_jax_vjp(block):
    cfg, jp, npt = block
    x = _x(13, B, S, cfg.d_model)
    dy = _x(14, B, S, cfg.d_model)
    jfn = lambda p, xx: jrglru.apply_rglru(p, xx, jrg.reduced())[0]

    @_jit
    def fwd_vjp(p, xx, g):
        out, pull = jax.vjp(jfn, p, xx)
        return out, pull(g)

    want, (want_dp, want_dx) = fwd_vjp(jp, jnp.asarray(x), jnp.asarray(dy))

    tp = params_from_numpy(npt, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got, state = rglru.apply_rglru(leaves, tx, cfg)
    assert state is None
    _close(got, want, OUT_TOL)
    got.backward(torch.from_numpy(dy))
    _close(tx.grad, want_dx, GRAD_TOL)
    for k in sorted(leaves):
        _close(leaves[k].grad, want_dp[k], GRAD_TOL)


def test_decode_step_matches_reference(block):
    cfg, jp, npt = block
    tp = params_from_numpy(npt, "cpu")
    st = rglru.init_rglru_state(cfg, B)
    jst = jrglru.init_rglru_state(jrg.reduced(), B)
    for t in range(3):
        x = _x(20 + t, B, 1, cfg.d_model)
        got, st = rglru.apply_rglru(tp, torch.from_numpy(x), cfg, st)
        want, jst = jrglru.apply_rglru(jp, jnp.asarray(x), jrg.reduced(),
                                       state=jst)
        _close(got, want, OUT_TOL)
        _close(st["h"], jst["h"], OUT_TOL)
        _close(st["conv"], jst["conv"], OUT_TOL)


def test_init_keeps_the_reference_leaves_and_dtypes(block):
    cfg, jp, npt = block
    mine = rglru.init_rglru(torch.Generator().manual_seed(0), cfg,
                            torch.bfloat16)
    jbf = jrglru.init_rglru(jax.random.PRNGKey(0), jrg.reduced(),
                            jnp.bfloat16)
    assert sorted(mine) == sorted(jbf)
    for k in mine:
        assert tuple(mine[k].shape) == jbf[k].shape
        assert str(mine[k].dtype)[6:] == str(jbf[k].dtype)
    # softplus(lam) * 8 = -log(u) with u in [0.9, 0.999]
    u = torch.exp(-8.0 * torch.nn.functional.softplus(mine["lam"]))
    assert bool(((u >= 0.9 - 1e-6) & (u <= 0.999 + 1e-6)).all())
