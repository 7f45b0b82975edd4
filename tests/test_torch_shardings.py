"""The port's logical-axis rules, axes trees and ZeRO-1 shardings held
against the JAX package on fake meshes of shape (2, 2), (1, 4), (2, 1)
and (2, 2, 2) with `pod` (pure functions: no process group), as
tests/test_substrate.py builds its `_FakeMesh`; and the parameter
layouts of tp 2 and 4 (padded heads and vocab) against
`jax.eval_shape` of the reference's init, for every architecture, and
the reference's weights at tp 4 carried over with `convert` into the
port's one-process forward in that layout."""
import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from decode_helpers import close, jit, one_torch_thread, to_port, tokens
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import shardings as jshard
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import backbone, blocks, registry, shardings
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.tree import tree_leaves

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = registry.ARCH_IDS


class FakeMesh:
    """What both packages' pure functions read of a mesh: the JAX
    package's `axis_names`, `devices.shape` and `empty`, the port's
    `mesh_dim_names`, `shape` and `get_coordinate()`."""

    def __init__(self, shape, axes, coord=None):
        self.axis_names = self.mesh_dim_names = axes
        self.shape = shape
        self.devices = types.SimpleNamespace(shape=shape)
        self.empty = False
        self._coord = coord or (0,) * len(shape)

    def get_coordinate(self):
        return self._coord


def _mesh(name):
    return FakeMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_specs(arch: str, tp: int):
    """The reference's parameter shapes and dtypes at tp (its leaves)."""
    cfg = jregistry.reduced_config(arch)
    return jax.tree.leaves(jax.eval_shape(
        functools.partial(jbackbone.init_params, cfg, tp=tp),
        jax.random.PRNGKey(0)))


def _jax_axes(tree):
    return jax.tree.leaves(tree, is_leaf=jstep._axes_leaf)


def _logicals():
    """Every axes leaf of every architecture's trees, and a few more."""
    seen = {("batch", "seq_sp", None), ("batch", None, "vocab"),
            ("experts", "batch", None, None), ("fsdp", None), ("null",),
            ("d_model", "seq"), jshard.SCALAR}
    for arch in ARCHS:
        cfg = jregistry.reduced_config(arch)
        seen.update(_jax_axes(jbackbone.param_axes(cfg)))
        seen.update(_jax_axes(jbackbone.stack_cache_axes(cfg)))
    return sorted(seen, key=repr)


@pytest.mark.parametrize("name", MESHES)
def test_resolve_and_axis_size_match_jax(name):
    mesh = _mesh(name)
    for logical in _logicals():
        assert shardings.resolve(logical, mesh) == \
            tuple(jshard.resolve(logical, mesh)), logical
    for logical in jshard.RULES:
        assert shardings.axis_size(mesh, logical) == \
            jshard.axis_size(mesh, logical), logical
    assert shardings.axis_size(None, "heads") == 1
    assert shardings.RULES == jshard.RULES
    assert shardings.SCALAR == jshard.SCALAR


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_jax(arch):
    """param_axes, stack_cache_axes and every block type's trees (which
    hold moe_axes, mla_axes, rglru_axes, mlstm_axes and slstm_axes)."""
    cfg, jcfg = registry.reduced_config(arch), jregistry.reduced_config(arch)
    assert backbone.param_axes(cfg) == jbackbone.param_axes(jcfg)
    assert backbone.stack_cache_axes(cfg) == \
        jbackbone.stack_cache_axes(jcfg)
    types_ = set(cfg.block_pattern)
    for btype in types_ | ({"enc_attn"} if cfg.encoder_layers else set()):
        assert blocks.block_axes(btype, cfg) == \
            jblocks.block_axes(btype, jcfg), btype
    for btype in types_:
        assert blocks.block_cache_axes(btype, cfg) == \
            jblocks.block_cache_axes(btype, jcfg), btype
    assert blocks.ATTN_AXES == jblocks.ATTN_AXES
    assert blocks.MLP_AXES == jblocks.MLP_AXES


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_match_jax(arch, name):
    """Every leaf's parameter spec (TP, and FSDP's), ZeRO-1 spec
    (zero1_pspec through opt_shardings) and the batch's, against the
    reference's rules on the same mesh."""
    mesh = _mesh(name)
    cfg, jcfg = registry.reduced_config(arch), jregistry.reduced_config(arch)
    tp = jshard.axis_size(mesh, "heads")
    shapes = _jax_specs(arch, tp)
    jp = [jshard.resolve(a, mesh)
          for a in _jax_axes(jbackbone.param_axes(jcfg))]
    jz = [tuple(jopt.zero1_pspec(p, s.shape, mesh))
          for p, s in zip(jp, shapes)]
    sh = step.state_shardings(cfg, mesh)
    got = lambda tree: [s.spec for s in tree_leaves(tree)]
    assert got(sh["params"]) == [tuple(p) for p in jp]
    for part in ("m", "v", "master"):
        assert got(sh["opt"][part]) == jz
    assert sh["opt"]["step"].spec == ()
    assert got(step.param_shardings(cfg, mesh, fsdp=True)) == jz
    specs = step.state_specs(cfg, step.RunCfg(), mesh)
    assert [s.shape for s in tree_leaves(specs["params"])] == \
        [s.shape for s in shapes]
    assert {s.dtype for s in tree_leaves(specs["opt"]["m"])} == \
        {torch.float32}
    batch = step.batch_shardings(cfg, None, mesh)
    assert batch["tokens"].spec == tuple(jshard.resolve(("batch", None),
                                                        mesh))
    for key in set(batch) - {"tokens"}:
        assert batch[key].spec == tuple(jshard.resolve(
            ("batch", None, None), mesh))


def test_zero1_pspec_rule():
    """The reference's own cases (tests/test_substrate.py) and the pod
    fallback: full DP where it divides, else `data` alone."""
    mesh = FakeMesh((16, 16), ("data", "model"))
    for pspec, shape in (((None, "model", None), (60, 7168, 128)),
                         ((), (7,)), ((None,), (32,)),
                         (("data", None), (32, 4))):
        assert opt_mod.zero1_pspec(pspec, shape, mesh) == \
            tuple(jopt.zero1_pspec(P(*pspec), shape, mesh))
    pod = _mesh("2x2x2")
    for shape in ((8, 3), (6, 3), (3, 3)):
        assert opt_mod.zero1_pspec((None, None), shape, pod) == \
            tuple(jopt.zero1_pspec(P(None, None), shape, pod))
    assert opt_mod.zero1_pspec((None, None), (6, 3), pod) == ("data", None)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layouts_match_jax(arch, tp):
    """Shapes and dtypes of the port's init at tp against the
    reference's (padded q and kv heads, the vocab padded to 128)."""
    cfg = registry.reduced_config(arch)
    got = tree_leaves(backbone.init_params(cfg, None, tp=tp, device="meta"))
    want = _jax_specs(arch, tp)
    assert [tuple(t.shape) for t in got] == [s.shape for s in want]
    assert [str(t.dtype).split(".")[1] for t in got] == \
        [str(s.dtype) for s in want]


def test_padded_layouts():
    """Reduced Yi's 7 q / 1 kv heads pad to 8 / 2 slots at tp 2, reduced
    RecurrentGemma's 2 / 1 to 4 / 4 at tp 4; the vocab pads to a
    multiple of 128 only where tp > 1."""
    yi = backbone.init_params(registry.reduced_config("yi-34b"), None, tp=2,
                              device="meta")
    attn = yi["stack"]["scan"][0]["attn"]
    assert attn["wq"].shape[2] == 8 and attn["wk"].shape[2] == 2
    rg = backbone.init_params(registry.reduced_config("recurrentgemma-2b"),
                              None, tp=4, device="meta")
    assert rg["stack"]["scan"][2]["attn"]["wq"].shape[2] == 4
    assert rg["stack"]["scan"][2]["attn"]["wk"].shape[2] == 4
    odd = registry.reduced_config("stablelm-1.6b").replace(vocab_size=300)
    for tp, rows in ((1, 300), (2, 384)):
        assert backbone.init_params(odd, None, tp=tp, device="meta")[
            "embed"].shape[0] == rows


def test_local_blocks_and_placements():
    """A rank's block along a split dimension (a tuple of axes splits
    major to minor), its shape, and the DTensor placements of a spec."""
    from torch.distributed.tensor import Replicate, Shard
    spec = (("pod", "data"), None, "model")
    x = torch.arange(8 * 3 * 4).reshape(8, 3, 4)
    for coord in ((0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 0)):
        mesh = FakeMesh((2, 2, 2), ("pod", "data", "model"), coord)
        row = 2 * coord[0] + coord[1]
        want = x[2 * row:2 * row + 2, :, 2 * coord[2]:2 * coord[2] + 2]
        assert torch.equal(shardings.local_block(x, spec, mesh), want)
        assert shardings.local_shape(x.shape, spec, mesh) == (2, 3, 2)
    assert shardings.placements(spec, mesh) == [Shard(0), Shard(0),
                                                Shard(2)]
    assert shardings.placements((None, "model"), _mesh("2x2")) == \
        [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="does not split"):
        shardings.local_shape((6, 3), (None, "model"), _mesh("1x4"))
    with pytest.raises(ValueError, match="does not split"):
        shardings.local_block(torch.zeros(3, 8), ("data", None),
                              FakeMesh((2, 1), ("data", "model"), (1, 0)))
    assert shardings.shard(x, ("batch", None, None), None) is x


def test_mesh_names():
    assert parse_mesh("2x2") == ((2, 2), ("data", "model"))
    assert parse_mesh("16x16") == ((16, 16), ("data", "model"))
    assert parse_mesh("2x16x16") == ((2, 16, 16), ("pod", "data", "model"))
    for bad in ("none", "4", "2x", "0x2", "2x2x2x2", "axb"):
        with pytest.raises(ValueError, match="DxT"):
            parse_mesh(bad)


def test_tp4_layout_forward_matches_jax():
    """Reduced RecurrentGemma at tp 4 (2 q / 1 kv heads padded to 4 / 4
    slots) with no mesh: the port's forward from the reference's weights
    against the reference's, to 1e-5 in f32."""
    cfg = registry.reduced_config("recurrentgemma-2b")
    jcfg = jregistry.reduced_config("recurrentgemma-2b")
    toks = tokens(7, 2, 32, cfg.vocab_size)

    def reference(key, toks):
        params = jbackbone.init_params(jcfg, key, tp=4, dtype=jnp.float32)
        return params, jbackbone.forward(params, toks, jcfg, 4, None,
                                         impl="dense", remat=False)[0]

    params, want = jit(reference)(jax.random.PRNGKey(5), jnp.asarray(toks))
    got, _ = backbone.forward(to_port(params), torch.from_numpy(toks).long(),
                              cfg, 4)
    close(got, want, 1e-5)
