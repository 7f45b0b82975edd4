"""The port's static invariant linter (`repro_torch.analysis`) against
the reference's (`repro.analysis`).

- Every fixture of `tests/test_analysis.py` (each source it lints, read
  out of that file's syntax tree) goes through every pass of both
  linters, under each path those fixtures use: the findings (file,
  line, pass, message) must be identical, the port's pointer to its own
  `SURFACES` read as the reference's. So must the mutation pins on the
  reference's controller and both real trees.
- The determinism pass's rule for torch's global generator has cases of
  its own: flagged by the port, not by the reference.
- `python -m repro_torch.analysis --baseline` exits 0 over the port's
  roots, and every baseline entry carries a reason.
"""
import ast
import json
import textwrap
from pathlib import Path

import pytest

from repro import analysis as ref_an
from repro.analysis import charge_pass as rcp, determinism_pass as rdp, \
    journal_pass as rjp, kinds_pass as rkp, steps_pass as rsp
from repro_torch import analysis as port_an
from repro_torch.analysis import charge_pass as pcp, \
    determinism_pass as pdp, journal_pass as pjp, kinds_pass as pkp, \
    steps_pass as psp
from repro_torch.analysis.__main__ import main as port_cli

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "test_analysis.py"
REF_PASSES = (rjp.JournalPass, rcp.ChargePass, rdp.DeterminismPass,
              rkp.KindsPass, rsp.StepsPass)
PORT_PASSES = (pjp.JournalPass, pcp.ChargePass, pdp.DeterminismPass,
               pkp.KindsPass, psp.StepsPass)
CONTROLLER = "src/repro/core/controller.py"


def _fixtures():
    """(source, rel) of every module the reference's tests lint: each
    string literal, or module-level string plus literal, that the file
    passes around, paired with every `rel=` the file names."""
    tree = ast.parse(FIXTURES.read_text())
    names = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            names[node.targets[0].id] = node.value.value
    sources, rels = [], {names["CONTROLLER_REL"]}
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "rel" and \
                isinstance(node.value, ast.Constant):
            rels.add(node.value.value)
        expr = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            expr = node.value
        elif isinstance(node, ast.BinOp) and isinstance(node.left, ast.Name) \
                and node.left.id in names and \
                isinstance(node.right, ast.Constant):
            expr = names[node.left.id] + node.right.value
        if expr and ("def " in expr or "class " in expr) and \
                expr not in sources:
            sources.append(expr)
    return sources, sorted(rels), names["GROUPS_OK"]


SOURCES, RELS, GROUPS_OK = _fixtures()


def _norm(findings):
    return [(f.file, f.line, f.pass_id, f.severity,
             f.message.replace("repro_torch.analysis", "repro.analysis"))
            for f in findings]


def _both(modules_of):
    """Findings of every pass of each linter over modules_of(Module)."""
    ref = [f for p in REF_PASSES
           for f in p().run_project(modules_of(ref_an.Module))]
    port = [f for p in PORT_PASSES
            for f in p().run_project(modules_of(port_an.Module))]
    return _norm(ref), _norm(port)


def test_fixtures_found():
    """The extraction sees the reference's fixtures: every pass has
    sources, and every path its tests use."""
    assert len(SOURCES) >= 40
    assert {"src/repro/core/groups.py", "src/repro/core/two_phase.py",
            "src/repro/core/state_sync.py", "src/repro/core/engine.py",
            "src/repro/core/migration.py", CONTROLLER} <= set(RELS)


@pytest.mark.parametrize("i", range(len(SOURCES)))
def test_fixture_findings_identical(i):
    """One fixture source under every path, alone and beside the kinds
    fixtures' groups.py: both linters give the same findings."""
    src = textwrap.dedent(SOURCES[i])
    seen = 0
    for rel in RELS:
        ref, port = _both(lambda M: [M(rel, src)])
        assert port == ref, rel
        seen += len(ref)
        if rel != "src/repro/core/groups.py":
            ref, port = _both(lambda M: [
                M("src/repro/core/groups.py", textwrap.dedent(GROUPS_OK)),
                M(rel, src)])
            assert port == ref, rel
            seen += len(ref)
    assert seen or "def " in src


@pytest.mark.parametrize("snippet", [
    "self._journal_standbys()", "self._journal_topology()",
    "self._journal_epoch()", "self._journal_storage_index()",
    "self._journal_policy(decision)", "charge=False)"])
def test_mutation_pins_identical(snippet):
    """The reference's acceptance pins: one journal call, or the
    `charge=` thread, taken out of the real controller; both linters
    fire, alike."""
    src = (ROOT / CONTROLLER).read_text()
    assert snippet in src
    mutated = src.replace(snippet, "pass" if "journal" in snippet else ")",
                          1)
    ref, port = _both(lambda M: [M(CONTROLLER, mutated)])
    assert ref and port == ref


@pytest.mark.parametrize("paths", [("src/repro/core", "src/repro/cluster",
                                    "src/repro/train"),
                                   ("src/repro_torch/core",
                                    "src/repro_torch/cluster",
                                    "src/repro_torch/train")])
def test_real_trees_identical(paths):
    """Both linters over the reference's roots and over the port's."""
    ref = ref_an.run_passes(ref_an.load_modules(root=ROOT, paths=paths))
    port = port_an.run_passes(port_an.load_modules(root=ROOT, paths=paths))
    assert _norm(port) == _norm(ref)


TORCH_RNG = [
    ("torch.manual_seed(0)", True),
    ("torch.rand(3)", True),
    ("torch.randn(3, 4)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.randperm(8)", True),
    ("torch.normal(0.0, 1.0, (3,))", True),
    ("torch.bernoulli(p)", True),
    ("torch.multinomial(p, 2)", True),
    ("torch.randn(3, generator=gen)", False),
    ("torch.randint(0, 5, (3,), generator=gen)", False),
    ("torch.multinomial(p, 2, generator=gen)", False),
    ("torch.Generator().manual_seed(0)", False),
    ("gen.manual_seed(0)", False),
    ("torch.zeros(3)", False),
    ("torch.randn_like(p)", False),
]


@pytest.mark.parametrize("call,flagged", TORCH_RNG)
def test_torch_global_generator_rule(call, flagged):
    """The port's determinism pass flags torch's global generator; the
    reference's has no such rule. The pragma suppresses it."""
    src = f"import torch\ndef f(p, gen):\n    return {call}\n"
    mod = lambda M: [M("src/repro_torch/core/engine.py", src)]
    port = pdp.DeterminismPass().run_project(mod(port_an.Module))
    assert rdp.DeterminismPass().run_project(mod(ref_an.Module)) == []
    if not flagged:
        assert port == []
        return
    (f,) = port
    assert (f.line, f.pass_id) == (3, "determinism")
    assert "torch's global generator" in f.message
    allowed = src.replace(call, call + "  # repro: allow(determinism)")
    assert pdp.DeterminismPass().run_project(
        [port_an.Module("src/repro_torch/core/engine.py", allowed)]) == []


def test_port_is_clean_with_its_baseline(capsys):
    """`python -m repro_torch.analysis --baseline` over the port's roots
    exits 0; each baselined finding says why it stands."""
    path = ROOT / port_an.BASELINE_NAME
    assert path.name != ref_an.BASELINE_NAME
    entries = port_an.load_baseline(path)
    assert all(e.get("reason") for e in entries)
    assert port_cli(["--baseline"]) == port_an.EXIT_CLEAN
    assert "0 finding(s)" in capsys.readouterr().out
    assert port_an.run(baseline_path=path).exit_code == port_an.EXIT_CLEAN


def test_port_cli_flags_torch_rng(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f():\n    return torch.rand(2)\n")
    assert port_cli([str(bad), "--json"]) == port_an.EXIT_FINDINGS
    data = json.loads(capsys.readouterr().out)
    assert [f["pass"] for f in data["findings"]] == ["determinism"]
