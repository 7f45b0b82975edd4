"""The port's DeepSeek-V2-Lite slice held against the JAX package: the
attention at multi-head latent attention's width pair (q.k 192, v 128),
`apply_mla` and its gradients, the `mla_moe` block, the init tree and
`PipelineEngine` at dp=1 x pp=2.

The reference's reduced config has MLA widths of 16 + 8 and 16, which the
attention kernels do not take (and the CPU path refuses what they
refuse), so every test here runs the reduced config with the full
model's MLA widths: kv_lora_rank 32, q.k 128 + 64, v 128."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_jax_engine import LOW_OPT, fast_jax_engine
from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs import deepseek_v2_lite_16b as jds
from repro.configs.base import MLACfg as JMLACfg
from repro.core.engine import PipelineEngine as JEngine
from repro.core.sandbox import CommHooks as JCommHooks
from repro.models import attention as jatt
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro.models import registry as jregistry
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs import deepseek_v2_lite_16b as ds
from repro_torch.configs.base import MLACfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import backbone, blocks, mla, registry
from repro_torch.tree import tree_flatten

# f32: sums over up to 192 products and 32 keys in other orders; bf16:
# both round the same f32 values to 8 bits, and the block's products and
# norms round again in bf16 at other places (one bf16 step at 4 is 2^-5)
F32_TOL, BF16_TOL = 1e-5, 2e-2
LOSS_TOL = 1e-5
B, S = 2, 16
WIDE = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=128,
            qk_rope_dim=64, v_head_dim=128)


def _cfgs(q_lora_rank=0):
    """(port, reference) reduced DeepSeek-V2-Lite at the full MLA
    widths."""
    w = dict(WIDE, q_lora_rank=q_lora_rank)
    return (ds.reduced().replace(mla=MLACfg(**w)),
            jds.reduced().replace(mla=JMLACfg(**w)))


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
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol):
    """_close on got and want divided by max(1, max |want|): the MLA
    output and every gradient sum hundreds of products whose rounding
    grows with their size (outputs near 30 at the reference's init)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    _close(got.detach().float() / scale, want / scale, tol)


def _pos(b, s):
    return np.ascontiguousarray(np.broadcast_to(np.arange(s)[None], (b, s)))


def test_configs_match_the_reference():
    assert repr(ds.CONFIG) == repr(jds.CONFIG)
    assert repr(ds.reduced()) == repr(jds.reduced())
    assert repr(_cfgs()[0]) == repr(_cfgs()[1])
    cfg, jcfg = _cfgs()
    assert registry.count_params(cfg) == jregistry.count_params(jcfg)


# ------------------------------------------------- attention (192, 128)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_the_mla_widths_matches_jax(causal):
    """The wrappers' plain versions (what a CPU tensor runs), forward and
    backward, at q.k 192 and v 128 against the JAX dense_attention over
    (B=bh, S, N=1, G=1, K) and its vjp."""
    bh, s = 3, 40
    q, k, v, do = _x(1, bh, s, 192), _x(2, bh, s, 192), _x(3, bh, s, 128), \
        _x(4, bh, s, 128)
    scale = 192 ** -0.5
    pos = jnp.asarray(_pos(bh, s))
    fn = lambda a, b_, c: jatt.dense_attention(
        a[:, :, None, None], b_[:, :, None], c[:, :, None], pos, pos,
        causal=causal, scale=scale)[:, :, 0, 0]
    want, pull = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = pull(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    assert out.shape == (bh, s, 128)
    _close(out, want, F32_TOL)
    out.backward(torch.from_numpy(do))
    for t, j in zip(leaves, jgrads):
        assert t.grad.shape == t.shape
        _close(t.grad, j, 1e-4)
    # the plain versions take the two widths through their einsums
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.attention_fwd_ref(tq, tk, tv, causal, scale)
    *grads, delta = fa.flash_bwd(tq, tk, tv, o, lse, tdo, causal, scale)
    _close(o, want, F32_TOL)
    for g, t in zip(grads, leaves):
        assert torch.equal(g, t.grad)
    _close(delta, (do * o.numpy()).sum(-1), F32_TOL)


def test_plain_attention_at_the_mla_widths_bf16():
    bh, s = 2, 24
    q, k, v = _x(5, bh, 1, s, 192), _x(6, bh, 1, s, 192), _x(7, bh, 1, s, 128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pos = jnp.asarray(_pos(bh, s))
    want = jatt.dense_attention(jq.transpose(0, 2, 1, 3)[:, :, :, None],
                                jk.transpose(0, 2, 1, 3),
                                jv.transpose(0, 2, 1, 3), pos, pos)
    got = ops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == (bh, 1, s, 128)
    _close(got.transpose(1, 2), np.asarray(want[:, :, :, 0], np.float32),
           BF16_TOL)


@pytest.mark.parametrize("dk,dv", [(192, 64), (128, 192), (24, 16)])
def test_wrappers_refuse_width_pairs_without_a_kernel(dk, dv):
    q, v = torch.zeros(1, 32, dk), torch.zeros(1, 32, dv)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, v, True, 1.0)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[None], q[None], v[None])


def test_wrappers_refuse_operands_of_other_widths():
    q, v = torch.zeros(1, 32, 192), torch.zeros(1, 32, 128)
    with pytest.raises(ValueError, match="share dtype"):
        fa.flash_attention(q, v, v)          # k at v's width
    o, lse = fa.flash_fwd(q, q, v, True, 1.0)
    assert o.shape == v.shape
    with pytest.raises(ValueError, match="share dtype"):
        fa.flash_bwd(q, q, v, o, lse, q, True, 1.0)     # dO at q's width


# ---------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla_params():
    """{(q_lora_rank, dtype): (cfg, jcfg, reference params, port params)}:
    the reference's own weights, the port's converted from them."""
    out = {}
    for rank in (0, 16):
        cfg, jcfg = _cfgs(rank)
        for dtype in ("float32", "bfloat16"):
            jp = jmla.init_mla(jax.random.PRNGKey(rank), jcfg,
                               dtype=jnp.dtype(dtype))
            out[rank, dtype] = (cfg, jcfg, jp, params_from_numpy(
                jax.tree.map(np.asarray, jp), "cpu"))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [0, 16])
def test_apply_mla_and_its_gradients_match_jax_vjp(mla_params, rank, dtype):
    """Output and the gradients of every weight and of x, for both query
    routes (w_q; w_dq, q_ln, w_uq), against jax.vjp of the reference's
    apply_mla at impl="dense"."""
    cfg, jcfg, jp, tp = mla_params[rank, dtype]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x, dy = _x(8 + rank, B, S, cfg.d_model), _x(9, B, S, cfg.d_model)
    pos = _pos(B, S)
    fn = lambda p, xx: jmla.apply_mla(p, xx, jnp.asarray(pos), jcfg,
                                      impl="dense")
    want, jdp, jdx = jax.jit(
        lambda p, xx, ct: (fn(p, xx), *jax.vjp(fn, p, xx)[1](ct)),
        compiler_options=LOW_OPT)(jp, jnp.asarray(x, jd),
                                  jnp.asarray(dy, jd))

    leaves, td_ = tree_flatten(tp)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    y = mla.apply_mla(td_.unflatten(leaves), tx, torch.from_numpy(pos), cfg)
    assert y.dtype == td and y.shape == (B, S, cfg.d_model)
    grads = torch.autograd.grad(y, leaves + [tx],
                                torch.from_numpy(dy).to(td))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close_scaled(y, want.astype(jnp.float32), tol)
    _close_scaled(grads[-1], jdx.astype(jnp.float32), tol)
    want_g = jax.tree.leaves(jdp)
    assert len(want_g) == len(leaves)
    for g, w in zip(grads[:-1], want_g):
        assert tuple(g.shape) == w.shape
        _close_scaled(g, w.astype(jnp.float32), tol)


def test_mla_rmsnorm_rounds_before_the_gain():
    """MLA's RMSNorm rounds the normalised product to x's dtype and then
    multiplies by g; blocks.rmsnorm multiplies in x's dtype. In bf16 the
    two differ, and the port's follows the reference's."""
    x = _x(10, 4, 32)
    g = 1.0 + _x(11, 32)
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    tx, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
    got = mla._rmsnorm(tx, tg)
    want = np.asarray(jmla._rmsnorm(jx, jg).astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    assert not torch.equal(blocks.rmsnorm(tx, tg), got)


def test_mla_moe_block_matches_jax():
    cfg, jcfg = _cfgs()
    jp = jblocks.init_block(jax.random.PRNGKey(2), "mla_moe", jcfg, 1,
                            jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x, pos = _x(12, B, S, cfg.d_model), _pos(B, S)
    want, jaux = jax.jit(lambda p, xx, ps: jblocks.apply_block(
        "mla_moe", p, xx, jcfg, 1, positions=ps, impl="dense"),
        compiler_options=LOW_OPT)(jp, jnp.asarray(x), jnp.asarray(pos))
    got, aux = blocks.apply_block("mla_moe", tp, torch.from_numpy(x), cfg,
                                  1, positions=torch.from_numpy(pos),
                                  impl="dense")
    _close(got, want, F32_TOL)
    _close(aux, jaux, F32_TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_convert_keep_the_reference_tree(rank, dtype):
    """The port's init has the reference tree's paths, shapes and dtypes
    (the router f32 whatever the dtype), and the reference's weights go
    through params_from_numpy and back unchanged."""
    cfg, jcfg = _cfgs(rank)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax.jit(lambda k: jbackbone.init_params(jcfg, k, tp=1, dtype=jd),
                  compiler_options=LOW_OPT)(jax.random.PRNGKey(3))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert "['stack']['scan'][0]['mla']['w_uk']" in paths
    assert ("['stack']['scan'][0]['mla']['w_uq']" in paths) == bool(rank)
    want = [(w.shape, torch.float32 if w.dtype == jnp.float32 else td)
            for w in jax.tree.leaves(ref)]
    mine = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                dtype=td)
    meta = backbone.init_params(cfg, None, dtype=td, device="meta")
    for tree in (mine, meta):
        leaves, _ = tree_flatten(tree)
        assert [(tuple(l.shape), l.dtype) for l in leaves] == want
    ref_np = jax.tree.map(np.asarray, ref)
    back = jax.tree.leaves(params_to_numpy(params_from_numpy(ref_np,
                                                             "cpu")))
    assert len(back) == len(jax.tree.leaves(ref_np))
    for a, b in zip(back, jax.tree.leaves(ref_np)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------- engine
SEQ, BATCH, ITERS = 32, 4, 2


def _run_port(full_np, flat=True):
    clock = SimClock()
    comm = CommHooks(clock)
    eng = PipelineEngine(_cfgs()[0], 1, 2, BATCH, SEQ, Cluster(4), clock,
                         comm, use_flat_buffers=flat,
                         sim_compile_seconds=1.0, device="cpu")
    eng.setup([0, 1], full_params=params_from_numpy(full_np, "cpu"))
    tape = eng.record_iteration()
    for _ in range(ITERS):
        eng.train_iteration()
    return eng, clock, comm, tape


@pytest.fixture(scope="module")
def engine_run():
    jcfg = _cfgs()[1]
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.float32))
    clock = JSimClock()
    comm = JCommHooks(clock)
    with fast_jax_engine():
        jeng = JEngine(jcfg, 1, 2, BATCH, SEQ, JCluster(4), clock, comm,
                       sim_compile_seconds=1.0)
        jeng.setup([0, 1])
        jtape = jeng.record_iteration()
        for _ in range(ITERS):
            jeng.train_iteration()
    return (jeng, clock, comm, jtape), _run_port(full_np), full_np


def test_mla_engine_losses_match_jax(engine_run):
    (jeng, *_), (eng, *_), _ = engine_run
    assert len(eng.losses) == len(jeng.losses) == ITERS + 1
    assert all(np.isfinite(eng.losses))
    np.testing.assert_allclose(eng.losses, jeng.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


def test_mla_engine_ledgers_and_state_identical(engine_run):
    (jeng, jclock, jcomm, jtape), (eng, clock, comm, tape), _ = engine_run
    phases = lambda c: [(p.name, p.lane, p.duration) for p in c.phases]
    assert phases(clock) == phases(jclock)
    assert comm.op_counts == jcomm.op_counts
    assert (comm.record_bytes, comm.replay_bytes) == \
        (jcomm.record_bytes, jcomm.replay_bytes)
    assert set(tape.entries) == set(jtape.entries)
    assert {k: v.nbytes for k, v in tape.entries.items()} == \
        {k: v.nbytes for k, v in jtape.entries.items()}
    for s in range(2):
        assert eng.state_spec(s).nbytes == jeng.state_spec(s).nbytes
    for mid in eng.grid.values():
        assert eng.state_bytes(mid) == jeng.state_bytes(mid)
        assert eng.cluster[mid].device.peak == jeng.cluster[mid].device.peak


def test_mla_engine_flat_and_per_leaf_losses_bitwise_equal(engine_run):
    _, (eng, *_), full_np = engine_run
    assert _run_port(full_np, flat=False)[0].losses == eng.losses
