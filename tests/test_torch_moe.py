"""The port's MoE slice held against the JAX package: the grouped expert
matmul (its plain version against the Pallas kernel in interpret mode,
its backward against autograd and jax.vjp), `apply_moe` and the
`attn_moe` block with the reference's own weights, and PipelineEngine
on the reduced Qwen1.5-MoE config against the JAX engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.core.engine import PipelineEngine as JEngine
from repro.core.sandbox import CommHooks as JCommHooks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.models import registry
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs import qwen2_moe_a2_7b as qwen
from repro_torch.configs.base import MoECfg
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks
from repro_torch.kernels import moe_gmm, ops, ref
from repro_torch.models import backbone, blocks, moe
from repro_torch.tree import tree_flatten

GMM_TOL = 1e-4               # f32, sums of up to 64 products
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
LOSS_TOL = 1e-5
B, S = 2, 16


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


# ------------------------------------------------------ grouped matmul
# (E, C, D, F) and Pallas blocks (c, f, d) that divide them, with more
# than one block along every axis, as tests/test_kernels.py picks them;
# the last two at the edges of the CUDA kernel's tiles: the path's token
# count cut to 2 x 11, D and F no multiple of its 32-deep R tile, F no
# multiple of 8
@pytest.mark.parametrize("e,c,d,f,blk", [
    (1, 16, 64, 32, (8, 16, 32)),
    (3, 32, 48, 24, (16, 8, 16)),
    (2, 24, 128, 40, (8, 8, 64)),
    (2, 22, 40, 24, (11, 8, 20)),
    (1, 22, 36, 20, (11, 10, 12)),
])
def test_plain_gmm_matches_pallas_interpret(e, c, d, f, blk):
    x, w = _x(e, e, c, d), _x(e + 10, e, d, f, scale=0.05)
    bc, bf, bd = blk
    pallas = jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                 block_c=bc, block_f=bf, block_d=bd,
                                 interpret=True)
    oracle = jref.grouped_matmul(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for got in (moe_gmm.gmm_fwd(tx, tw), ref.grouped_matmul(tx, tw),
                ops.grouped_matmul(tx, tw)):
        assert got.dtype == torch.float32 and got.shape == (e, c, f)
        _close(got, pallas, GMM_TOL)
        _close(got, oracle, GMM_TOL)


def test_plain_gmm_bf16_matches_reference_oracle():
    x, w = _x(1, 2, 8, 32), _x(2, 2, 32, 16, scale=0.1)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    got = moe_gmm.gmm_fwd(tx, tw)
    assert got.dtype == torch.bfloat16
    # both round the same f32 sum to bf16: one bf16 ulp at most
    _close(got, jref.grouped_matmul(jx, jw).astype(jnp.float32), 2e-2)


# ragged shapes (no power-of-two tile divides them), as the kernel takes;
# the last three cut the CUDA kernel's 128-row tile, its 32-deep R tile
# and (N 20) its n8 column tiles
@pytest.mark.parametrize("e,m,k,n", [(3, 5, 33, 17), (2, 42, 16, 24),
                                     (1, 1, 7, 3), (2, 22, 40, 20),
                                     (1, 130, 36, 12), (2, 150, 48, 20)])
def test_gmm_backward_matches_autograd_and_vjp(e, m, k, n):
    x, w, dy = _x(1, e, m, k), _x(2, e, k, n), _x(3, e, m, n)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = moe_gmm.grouped_matmul(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    py = torch.einsum("ecd,edf->ecf", px, pw)
    pdx, pdw = torch.autograd.grad(py, (px, pw), torch.from_numpy(dy))
    _, pull = jax.vjp(jref.grouped_matmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = pull(jnp.asarray(dy))
    for got, plain, want in ((dx, pdx, jdx), (dw, pdw, jdw)):
        _close(got, plain.numpy(), GMM_TOL)
        _close(got, want, GMM_TOL)


@pytest.mark.parametrize("needs", [(True, False), (False, True)])
def test_gmm_backward_runs_only_the_needed_gradient(monkeypatch, needs):
    calls = []
    for name in ("gmm_bwd_dx", "gmm_bwd_dw"):
        fn = getattr(moe_gmm, name)
        monkeypatch.setattr(moe_gmm, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    tx = torch.from_numpy(_x(1, 2, 5, 8)).requires_grad_(needs[0])
    tw = torch.from_numpy(_x(2, 2, 8, 3)).requires_grad_(needs[1])
    moe_gmm.grouped_matmul(tx, tw).sum().backward()
    assert calls == (["gmm_bwd_dx"] if needs[0] else ["gmm_bwd_dw"])
    assert (tx.grad is not None, tw.grad is not None) == needs


def test_gmm_wrappers_reject_what_the_kernels_do_not_take():
    x, w = torch.zeros(2, 5, 8), torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="do not agree"):
        moe_gmm.gmm_fwd(x, torch.zeros(2, 7, 3))
    with pytest.raises(ValueError, match="do not agree"):
        moe_gmm.gmm_fwd(x, torch.zeros(3, 8, 3))
    with pytest.raises(ValueError, match="share dtype"):
        moe_gmm.gmm_fwd(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        moe_gmm.gmm_fwd(x.double(), w.double())
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        moe_gmm.gmm_fwd(x[0], w)
    # `meta` tensors (the dry-run's) get the kernel's output unwritten
    # and launch nothing
    moe_gmm.reset_launches()
    out = moe_gmm.gmm_fwd(x.to("meta"), w.to("meta"))
    assert (out.shape, out.dtype, out.device.type) == ((2, 5, 3),
                                                       torch.float32, "meta")
    assert not any(moe_gmm.LAUNCHES.values())
    # the public wrapper promotes mixed f32/bf16 operands, as jnp does
    assert ops.grouped_matmul(x, w.to(torch.bfloat16)).dtype == \
        torch.float32


# ---------------------------------------------------------------- MoE
def test_config_and_moecfg_match_the_reference():
    # every field, capacity_factor and router_aux_weight included
    assert repr(qwen.CONFIG) == repr(jqwen.CONFIG)
    assert repr(qwen.reduced()) == repr(jqwen.reduced())
    assert repr(MoECfg(8, 2)) == repr(jmoe.MoECfg(8, 2))


@pytest.fixture(scope="module")
def moe_params():
    jcfg = registry.reduced_config("qwen2-moe-a2.7b")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, ep=1,
                       dtype=jnp.float32)
    npt = jax.tree.map(np.asarray, jp)
    return jcfg, qwen.reduced(), jp, params_from_numpy(npt, "cpu")


def _jax_dispatch(monkeypatch, jp, x, jcfg, capacity):
    """The reference's (y, aux, dispatch, combine): its `shard` calls are
    no-ops without a mesh, so a stand-in that records what it is handed
    shows the dispatch and combine tensors."""
    seen = []

    def record(t, logical, mesh=None):
        seen.append((tuple(logical), t))
        return t
    monkeypatch.setattr(jmoe, "shard", record)
    y, aux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity=capacity)
    monkeypatch.undo()
    dc = [t for spec, t in seen if spec == ("batch", None, "experts",
                                           None)]
    assert len(dc) == 2
    return y, aux, dc[0], dc[1]


@pytest.mark.parametrize("capacity", [None, 1])
def test_apply_moe_and_dispatch_match_jax(monkeypatch, moe_params,
                                          capacity):
    jcfg, cfg, jp, tp = moe_params
    x = _x(4, B, S, cfg.d_model)
    jy, jaux, jdispatch, jcombine = _jax_dispatch(monkeypatch, jp, x, jcfg,
                                                  capacity)
    cap = capacity or max(4, int(np.ceil(S * cfg.moe.top_k /
                                         cfg.moe.num_experts *
                                         cfg.moe.capacity_factor)))
    _, _, dispatch, combine = moe.route(tp, torch.from_numpy(x), cfg, cap)
    assert np.array_equal(dispatch.numpy(), np.asarray(jdispatch))
    _close(combine, jcombine, OUT_TOL)
    y, aux = moe.apply_moe(tp, torch.from_numpy(x), cfg, capacity=capacity)
    _close(y, jy, OUT_TOL)
    _close(aux, jaux, OUT_TOL)
    if capacity == 1:          # tokens drop: fewer than S*k are routed
        assert 0 < dispatch.sum().item() < B * S * cfg.moe.top_k


@pytest.mark.parametrize("capacity", [None, 1])
def test_apply_moe_gradients_match_vjp(moe_params, capacity):
    jcfg, cfg, jp, tp = moe_params
    x, dy = _x(5, B, S, cfg.d_model), _x(6, B, S, cfg.d_model)

    def jfn(p, xx):
        y, aux = jmoe.apply_moe(p, xx, jcfg, capacity=capacity)
        return y, aux
    jdp, jdx = jax.jit(lambda p, xx, ct: jax.vjp(jfn, p, xx)[1](ct))(
        jp, jnp.asarray(x), (jnp.asarray(dy), jnp.float32(3.0)))

    leaves, td = tree_flatten(tp)
    leaves = [l.clone().requires_grad_(True) for l in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(td.unflatten(leaves), tx, cfg, capacity=capacity)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + 3 * aux,
                                leaves + [tx])
    _close(grads[-1], jdx, GRAD_TOL)
    want = jax.tree.leaves(jdp)
    assert len(want) == len(leaves)
    for g, w in zip(grads[:-1], want):
        assert tuple(g.shape) == w.shape
        _close(g, w, GRAD_TOL)


def test_attn_moe_block_matches_jax():
    jcfg = registry.reduced_config("qwen2-moe-a2.7b")
    jp = jblocks.init_block(jax.random.PRNGKey(2), "attn_moe", jcfg, 1,
                            jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _x(7, B, S, jcfg.d_model)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(S)[None], (B, S)))
    want, jaux = jax.jit(lambda p, xx, ps: jblocks.apply_block(
        "attn_moe", p, xx, jcfg, 1, positions=ps, impl="dense"))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got, aux = blocks.apply_block("attn_moe", tp, torch.from_numpy(x),
                                  qwen.reduced(), 1,
                                  positions=torch.from_numpy(pos),
                                  impl="dense")
    _close(got, want, OUT_TOL)
    _close(aux, jaux, OUT_TOL)
    assert float(aux) > 0


def test_torch_init_keeps_the_reference_moe_tree():
    jcfg = registry.reduced_config("qwen2-moe-a2.7b")
    want = jax.eval_shape(lambda k: jbackbone.init_params(
        jcfg, k, tp=1, dtype=jnp.float32), jax.random.PRNGKey(0))
    mine = backbone.init_params(qwen.reduced(),
                                torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    meta = backbone.init_params(qwen.reduced(), None, dtype=torch.float32,
                                device="meta")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert "['stack']['scan'][0]['moe']['w_gate']" in paths
    for tree in (mine, meta):
        leaves, _ = tree_flatten(tree)
        assert [(tuple(l.shape), l.dtype) for l in leaves] == \
            [(w.shape, torch.float32) for w in jax.tree.leaves(want)]


# ------------------------------------------------------------- engine
SEQ, BATCH, ITERS = 32, 4, 2


def _run_port(dp, full_np, flat=True):
    clock = SimClock()
    comm = CommHooks(clock)
    eng = PipelineEngine(qwen.reduced(), dp, 2, BATCH, SEQ,
                         Cluster(dp * 2 + 2), clock, comm,
                         use_flat_buffers=flat, sim_compile_seconds=1.0,
                         device="cpu")
    eng.setup(list(range(dp * 2)),
              full_params=params_from_numpy(full_np, "cpu"))
    tape = eng.record_iteration()
    for _ in range(ITERS):
        eng.train_iteration()
    return eng, clock, comm, tape


@pytest.fixture(scope="module")
def engine_runs():
    jcfg = registry.reduced_config("qwen2-moe-a2.7b")
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.float32))
    runs = {}
    for dp in (1, 2):
        clock = JSimClock()
        comm = JCommHooks(clock)
        jeng = JEngine(jcfg, dp, 2, BATCH, SEQ, JCluster(dp * 2 + 2),
                       clock, comm, sim_compile_seconds=1.0)
        jeng.setup(list(range(dp * 2)))
        jtape = jeng.record_iteration()
        for _ in range(ITERS):
            jeng.train_iteration()
        runs[dp] = ((jeng, clock, comm, jtape), _run_port(dp, full_np))
    return runs, full_np


@pytest.mark.parametrize("dp", [1, 2])
def test_moe_engine_losses_match_jax(engine_runs, dp):
    (jeng, *_), (eng, *_) = engine_runs[0][dp]
    assert len(eng.losses) == len(jeng.losses) == ITERS + 1
    assert all(np.isfinite(eng.losses))
    np.testing.assert_allclose(eng.losses, jeng.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("dp", [1, 2])
def test_moe_engine_ledgers_and_state_identical(engine_runs, dp):
    (jeng, jclock, jcomm, jtape), (eng, clock, comm, tape) = \
        engine_runs[0][dp]
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


def test_moe_engine_flat_and_per_leaf_losses_bitwise_equal(engine_runs):
    runs, full_np = engine_runs
    eng = runs[2][1][0]
    assert _run_port(2, full_np, flat=False)[0].losses == eng.losses
