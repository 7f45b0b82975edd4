"""The port stands alone: no JAX, nothing of `repro`, and it runs on the
card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "repro" or
             m.startswith("repro."))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20
    for mod in ("repro_torch.kernels.mlstm", "repro_torch.models.xlstm",
                "repro_torch.kernels.rglru_scan", "repro_torch.launch.train"):
        assert mod in names, mod


# an import of jax or of the JAX package at any indent: the import test
# above executes only module-level imports, never one inside a function
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def _imports(path):
    return [l for l in path.read_text().splitlines() if IMPORT_RE.match(l)]


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py",
                                       ROOT / "examples/torch_quickstart.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    hits = _imports(path)
    assert not hits, hits


def test_import_scan_sees_function_local_imports():
    """The scan flags the reference Controller's imports inside method
    bodies, which a port module copied without change would keep."""
    hits = _imports(ROOT / "src" / "repro" / "core" / "controller.py")
    local = [l for l in hits if l.startswith(" ")]
    assert "        from repro.models.registry import count_params" in local
    assert len(local) == 2


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.cluster.node import Cluster
    from repro_torch.cluster.simclock import SimClock
    from repro_torch.configs.gpt import tiny_gpt
    from repro_torch.core.engine import PipelineEngine
    from repro_torch.core.sandbox import CommHooks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clock = SimClock()
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineEngine(tiny_gpt(layers=2, d=64, heads=4, vocab=256), 1, 2,
                       4, 16, Cluster(2), clock, CommHooks(clock))


@pytest.mark.parametrize("entry", ["init_state", "make_train_step",
                                   "make_prefill_step", "launcher"])
def test_train_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, entry):
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.launch import train as launch
    from repro_torch.train import step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, run = recurrentgemma_2b.reduced(), step.RunCfg()
    calls = {
        "init_state": lambda: step.init_state(cfg, run),
        "make_train_step": lambda: step.make_train_step(cfg, run),
        "make_prefill_step": lambda: step.make_prefill_step(cfg, run),
        "launcher": lambda: launch.main(["--arch", "recurrentgemma-2b",
                                         "--reduced", "--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
