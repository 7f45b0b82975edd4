"""The dry-run's abstract inputs (`repro_torch.launch.specs`) against the
JAX package's (`repro.launch.specs`): every leaf of `input_specs` (whole
shapes and dtypes) equals the reference's for every architecture x
shape, the reference's specs through `jax.eval_shape` in-process on a
fake 16x16 mesh (the pure functions read only axis names and extents);
and `fit_sharding` drops the mesh axes of a dimension they do not
divide. Rank 0's blocks are tests/test_torch_dryrun.py's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.models import registry as jregistry
from repro.train import step as jstep
from repro_torch.configs.base import SHAPES
from repro_torch.launch.specs import fit_sharding, input_specs
from repro_torch.models import registry
from repro_torch.models.shardings import NamedSharding
from repro_torch.train import step as step_mod
from repro_torch.tree import ShapeDtype, tree_leaves
from test_torch_shardings import FakeMesh

PROD = {"16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jdtype(x) -> str:
    return str(np.dtype(x.dtype))


def _reference_args(arch: str, shape: str, mesh) -> tuple:
    """The reference input_specs' args, without its shardings."""
    cfg, sh = jregistry.get_config(arch), JSHAPES[shape]
    run = jstep.default_run_cfg()
    if sh.kind == "train":
        return (jstep.state_specs(cfg, run, mesh), jstep.batch_specs(cfg, sh))
    params = jstep.param_specs(cfg, mesh)
    if sh.kind == "prefill":
        return (params, jstep.batch_specs(cfg, sh))
    return (params, jstep.cache_specs(cfg, sh, mesh),
            jax.ShapeDtypeStruct((sh.global_batch, 1), np.int32))


@pytest.fixture(scope="module")
def once_per_arch():
    """Both packages' param_specs drawn once per (config, tp): each
    cell's specs call them once or twice, and a whole model's init
    takes a second on either side."""
    patch = pytest.MonkeyPatch()
    for mod, tp_of in ((jstep, jstep._tp), (step_mod, step_mod._tp)):
        fn, memo = mod.param_specs, {}

        def cached(cfg, mesh=None, _fn=fn, _memo=memo, _tp=tp_of):
            key = (cfg, _tp(mesh))
            if key not in _memo:
                _memo[key] = _fn(cfg, mesh)
            return _memo[key]
        patch.setattr(mod, "param_specs", cached)
    yield
    patch.undo()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_leaves_are_the_references(once_per_arch, arch):
    mesh = FakeMesh(*PROD["16x16"])
    for shape in SHAPES:
        spec = input_specs(arch, shape, mesh)
        ref = _reference_args(arch, shape, mesh)
        assert spec["kind"] == JSHAPES[shape].kind
        assert spec["consumed"] == {"train": (0,), "prefill": (),
                                    "decode": (1,)}[spec["kind"]]
        assert len(spec["args"]) == len(ref)
        for got, want in zip(spec["args"], ref):
            got, want = tree_leaves(got), jax.tree.leaves(want)
            assert [(s.shape, str(s.dtype)[6:]) for s in got] == \
                [(tuple(w.shape), _jdtype(w)) for w in want], shape


def test_fit_sharding_drops_axes_that_do_not_divide():
    mesh = FakeMesh(*PROD["2x16x16"])
    sh = NamedSharding(mesh, (("pod", "data"), "model"))
    assert fit_sharding(ShapeDtype((1, 32), torch.int32), sh).spec == \
        (None, "model")
    assert fit_sharding(ShapeDtype((64, 48), torch.int32), sh) is sh
    assert fit_sharding(ShapeDtype((64, 24), torch.int32), sh).spec == \
        (("pod", "data"), None)
