"""Flat buffers and Adam: the port's layouts equal the reference's byte
for byte, its flat Adam matches JAX, and flat equals per-leaf bitwise
inside torch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs.gpt import tiny_gpt as jtiny_gpt
from repro.core import flatbuf as jflatbuf
from repro.core.engine import PipelineEngine as JEngine
from repro.core.sandbox import CommHooks as JCommHooks
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.convert import params_from_numpy
from repro_torch.core import flatbuf
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_flatten, tree_map

# the campaign's tiny GPT (core/campaign.py CampaignCfg defaults)
LAYERS, D, HEADS, VOCAB, PP = 4, 64, 4, 256, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(flat, dtype):
    jc, tc = JSimClock(), SimClock()
    je = JEngine(jtiny_gpt(LAYERS, D, HEADS, VOCAB), 2, PP, 8, 32,
                 JCluster(4), jc, JCommHooks(jc), use_flat_buffers=flat,
                 param_dtype=getattr(jnp, dtype))
    te = PipelineEngine(tiny_gpt(LAYERS, D, HEADS, VOCAB), 2, PP, 8, 32,
                        Cluster(4), tc, CommHooks(tc), use_flat_buffers=flat,
                        param_dtype=getattr(torch, dtype), device="cpu")
    return je, te


def _name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", range(PP))
def test_segmented_spec_equals_reference(stage, dtype):
    je, te = _engines(True, dtype)
    js, ts = je.flat_spec(stage), te.flat_spec(stage)
    assert [(s.size, str(s.dtype)) for s in js.segments] == \
        [(s.size, _name(s.dtype)) for s in ts.segments]
    assert ts.leaf_views() == js.leaf_views()
    assert ts.segment_bounds() == js.segment_bounds()
    assert (ts.size, ts.nbytes) == (js.size, js.nbytes)
    assert [_name(d) for d in ts.dtypes] == [str(d) for d in js.dtypes]


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", range(PP))
def test_byte_specs_equal_reference(stage, dtype, flat):
    je, te = _engines(flat, dtype)
    js, ts = je.state_spec(stage), te.state_spec(stage)
    assert (ts.nbytes, ts.offsets, ts.nbytes_leaf, ts.shapes) == \
        (js.nbytes, js.offsets, js.nbytes_leaf, js.shapes)
    assert te.grad_buffer_bytes(stage) == je.grad_buffer_bytes(stage)


def _stage_tree(seed):
    """A stage-shaped tree of numpy leaves (JAX leaf order)."""
    je, _ = _engines(True, "float32")
    spec = je._stage_param_spec(0)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), spec)


def test_byte_pack_round_trips_bitwise():
    tree = params_from_numpy(_stage_tree(1), "cpu")
    tree["step"] = torch.tensor(7, dtype=torch.int32)
    tree["half"] = torch.randn(3, 5).to(torch.bfloat16)
    spec = flatbuf.ByteSpec.from_tree(tree)
    back = spec.unpack(spec.pack(tree))
    for a, b in zip(tree_flatten(tree)[0], tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError):
        spec.pack(dict(tree, step=torch.tensor(7, dtype=torch.int64)))


def test_flat_adam_matches_jax():
    params_np = _stage_tree(2)
    grads_np = jax.tree.map(lambda a: a * 0.01, _stage_tree(3))
    cfg = jopt.AdamCfg(lr=1e-3, warmup_steps=10)
    tcfg = opt.AdamCfg(lr=1e-3, warmup_steps=10)

    jp = jax.tree.map(jnp.asarray, params_np)
    jspec = jflatbuf.SegmentedSpec.from_tree(jp)
    jstate = jopt.init_flat_opt_state(jspec, jp)
    tp = params_from_numpy(params_np, "cpu")
    tspec = flatbuf.SegmentedSpec.from_tree(tp)
    tstate = opt.init_flat_opt_state(tspec, tp)
    for _ in range(3):
        jsegs, jstate, jstats = jopt.adam_update_flat(
            jspec, jspec.flatten(jax.tree.map(jnp.asarray, grads_np)),
            jstate, cfg)
        tsegs, tstate, tstats = opt.adam_update_flat(
            tspec, tspec.flatten(params_from_numpy(grads_np, "cpu")),
            tstate, tcfg)
    for k in ("m", "v", "master"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsegs[0].numpy(), np.asarray(jsegs[0]),
                               rtol=1e-6, atol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)


@given(seed=st.integers(0, 2 ** 16), steps=st.integers(1, 3),
       clip=st.sampled_from([0.0, 1.0, 1e-3]))
@settings(max_examples=6, deadline=None)
def test_flat_adam_equals_per_leaf_bitwise(seed, steps, clip):
    gen = torch.Generator().manual_seed(seed)
    params = {"b": {"w": torch.randn(4, 6, generator=gen)},
              "a": torch.randn(5, generator=gen).to(torch.bfloat16),
              "c": (torch.randn(3, 2, generator=gen),)}
    cfg = opt.AdamCfg(lr=1e-2, warmup_steps=2, grad_clip=clip)
    spec = flatbuf.SegmentedSpec.from_tree(params)
    leaf_state = opt.init_opt_state(params)
    flat_state = opt.init_flat_opt_state(spec, params)
    for _ in range(steps):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(p.dtype), params)
        leaf_p, leaf_state, _ = opt.adam_update(grads, leaf_state, cfg,
                                                param_dtype=None)
        segs, flat_state, _ = opt.adam_update_flat(
            spec, spec.flatten(grads), flat_state, cfg)
    for a, b in zip(tree_flatten(leaf_p)[0],
                    tree_flatten(spec.unflatten(segs))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cat = lambda tree: torch.cat([t.reshape(-1)
                                  for t in tree_flatten(tree)[0]])
    for k in ("m", "v", "master"):
        assert torch.equal(cat(leaf_state[k]),
                           cat(spec.unflatten_master(flat_state[k])))


def test_tree_bytes_and_in_memory_checkpoint_match_reference():
    tree_np = _stage_tree(4)
    jstate = {"params": tree_np, "step": 0}
    tstate = {"params": params_from_numpy(tree_np, "cpu"), "step": 0}
    assert ckpt.tree_bytes(tstate) == jckpt.tree_bytes(jstate)
    ring = [10, 11, 12]
    mine, ref = ckpt.InMemoryCheckpoint(), jckpt.InMemoryCheckpoint()
    for node in ring:
        mine.put(node, 3, tstate, ring)
        ref.put(node, 3, jstate, ring)
    for c in (mine, ref):
        c.drop_node(11)
    for node in ring:
        assert mine.bytes_for(node) == ref.bytes_for(node)
        assert (mine.get(node) is None) == (ref.get(node) is None)
    step, host = mine.get(11)                 # served by the replica
    assert step == 3 and all(t.device.type == "cpu" for t in
                             tree_flatten(host["params"])[0])


def test_flat_spec_matches_reference_and_round_trips():
    tree_np = _stage_tree(5)
    js = jflatbuf.FlatSpec.from_tree(jax.tree.map(jnp.asarray, tree_np))
    tree = params_from_numpy(tree_np, "cpu")
    ts = flatbuf.FlatSpec.from_tree(tree)
    assert (ts.offsets, ts.sizes, ts.shapes, ts.size, ts.nbytes) == \
        (js.offsets, js.sizes, js.shapes, js.size, js.nbytes)
    buf = ts.flatten(tree)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(js.flatten(
        jax.tree.map(jnp.asarray, tree_np))))
    for a, b in zip(tree_flatten(tree)[0],
                    tree_flatten(ts.unflatten(buf))[0]):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        flatbuf.FlatSpec.from_tree(dict(tree, half=torch.zeros(
            2, dtype=torch.bfloat16)))
