"""The port's counterparts of the reference's rolling-maintenance and
failure-storm examples, run in this process on the CPU: each ends with
its reference example's OK line, after that example's assertions."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,line", [
    ("torch_rolling_maintenance", "ROLLING MAINTENANCE OK"),
    ("torch_failure_storm", "FAILURE STORM OK")])
def test_example_runs_on_the_cpu(capsys, name, line):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mod.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert capsys.readouterr().out.splitlines()[-1] == line
