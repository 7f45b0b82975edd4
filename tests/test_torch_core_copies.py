"""The port's copies of the JAX package's JAX-free core modules stay the
reference's code. Each copy is parsed, its `repro_torch.` imports read
as `repro.`, docstrings dropped from both sides and the copy's listed
edits undone; what is left must be the reference's syntax tree, so a fix
to either side that the other lacks fails here.

The listed edits (and nothing else) are allowed:
- controller: `count_params` is imported at module level, not inside
  two methods; `bootstrap_job` takes `full_params` and passes it to
  `engine.setup`;
- controller, state_sync: the reference's unused `import numpy as np`
  is left out;
- campaign: `CampaignCfg` has a `device` field, which `build_controller`
  passes to the engine.

The port's copy of the static invariant linter (`repro_torch/analysis`,
all nine modules) is held the same way. Its listed edits: the package
name and roots in its strings (`repro_torch` for `repro`: the CLI's
name, `DEFAULT_ROOTS`, the summary line, a finding's pointer to
`SURFACES`), its own baseline file (`analysis-baseline-torch.json`), and
the determinism pass's rule for torch's global generator (`TORCH_RANDOM`,
its branch in `_forbidden_calls` and the `call_keyword` it imports)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro" / "core", \
    ROOT / "src" / "repro_torch" / "core"
COPIES = ["two_phase", "migration", "journal", "metrics", "policy",
          "baselines", "state_sync", "standby", "controller", "campaign"]
COUNT_PARAMS = "from repro.models.registry import count_params"


class _Normalise(ast.NodeTransformer):
    """Docstrings out, `repro_torch` module paths read as `repro`, and
    the imports named in `drop` (by their unparsed text) removed at any
    depth."""

    def __init__(self, drop=()):
        self.drop = set(drop)

    def _body(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body = body[1:]
        node.body = body or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _body

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "repro_torch"
                            or node.module.startswith("repro_torch.")):
            node.module = "repro" + node.module[len("repro_torch"):]
        return None if ast.unparse(node) in self.drop else node

    def visit_Import(self, node):
        return None if ast.unparse(node) in self.drop else node


def _unused_numpy(tree) -> bool:
    return not any(isinstance(n, ast.Name) and n.id == "np"
                   for n in ast.walk(tree))


def _undo_full_params(tree) -> int:
    """Take `full_params` out of Controller.bootstrap_job: its argument
    (with its default) and the keyword it passes to engine.setup.
    Returns how many of the two were found."""
    found = 0
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == "bootstrap_job":
            names = [a.arg for a in fn.args.args]
            if "full_params" in names:
                i = names.index("full_params")
                k = i - (len(names) - len(fn.args.defaults))
                del fn.args.args[i], fn.args.defaults[k]
                found += 1
            for call in ast.walk(fn):
                if isinstance(call, ast.Call):
                    kept = [k for k in call.keywords
                            if k.arg != "full_params"]
                    found += len(call.keywords) - len(kept)
                    call.keywords = kept
    return found


def _undo_device(tree) -> int:
    """Take `device` out of campaign: CampaignCfg's field and the
    keyword build_controller passes to the engine. Returns how many of
    the two were found."""
    found = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "CampaignCfg":
            kept = [n for n in node.body if not (
                isinstance(n, ast.AnnAssign) and n.target.id == "device")]
            found += len(node.body) - len(kept)
            node.body = kept
        if isinstance(node, ast.FunctionDef) and \
                node.name == "build_controller":
            for call in ast.walk(node):
                if isinstance(call, ast.Call):
                    kept = [k for k in call.keywords if k.arg != "device"]
                    found += len(call.keywords) - len(kept)
                    call.keywords = kept
    return found


class _PortStrings(ast.NodeTransformer):
    """The linter copy's strings read as the reference's: `repro_torch`
    as `repro`, its baseline file as the reference's."""

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("repro_torch", "repro").replace(
                "analysis-baseline-torch.json", "analysis-baseline.json")
        return node


def _undo_torch_rng(tree) -> int:
    """Take the torch-generator rule out of the determinism pass: the
    TORCH_RANDOM set, the `elif` branch that reads it and the
    `call_keyword` import it needs. Returns how many of the three were
    found."""
    found = 0
    kept = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                ast.unparse(node.targets[0]) == "TORCH_RANDOM":
            found += 1
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "base":
            names = [a for a in node.names if a.name != "call_keyword"]
            found += len(node.names) - len(names)
            node.names = names
        kept.append(node)
    tree.body = kept
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and len(node.orelse) == 1 and \
                isinstance(node.orelse[0], ast.If) and \
                "torch.manual_seed" in ast.unparse(node.orelse[0].test):
            assert not node.orelse[0].orelse
            node.orelse = []
            found += 1
    return found


def _tree(path: Path, drop=()) -> ast.Module:
    return _Normalise(drop).visit(ast.parse(path.read_text()))


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_the_reference(name):
    ref_drop, port_drop = [], []
    ref = ast.parse((REF / f"{name}.py").read_text())
    if any(isinstance(n, ast.Import) and ast.unparse(n) ==
           "import numpy as np" for n in ref.body) and \
            name in ("controller", "state_sync"):
        assert _unused_numpy(ref), "the reference uses np now"
        ref_drop.append("import numpy as np")
    if name == "controller":
        ref_drop.append(COUNT_PARAMS)
        port_drop.append(COUNT_PARAMS)
    ref = _tree(REF / f"{name}.py", ref_drop)
    port = _tree(PORT / f"{name}.py", port_drop)
    if name == "controller":
        assert _undo_full_params(port) == 2
        # the port imports count_params once, at the top
        top = [ast.unparse(n) for n in
               ast.parse((PORT / "controller.py").read_text()).body]
        assert top.count(COUNT_PARAMS.replace("repro.", "repro_torch.")) \
            == 1
    if name == "campaign":
        assert _undo_device(port) == 2
    assert ast.dump(port) == ast.dump(ref)


ANALYSIS = ["__init__", "__main__", "base", "charge_pass",
            "determinism_pass", "journal_pass", "kinds_pass", "runner",
            "steps_pass"]


@pytest.mark.parametrize("name", ANALYSIS)
def test_linter_copy_is_the_reference(name):
    ref = _tree(ROOT / "src" / "repro" / "analysis" / f"{name}.py")
    port = _PortStrings().visit(
        _tree(ROOT / "src" / "repro_torch" / "analysis" / f"{name}.py"))
    if name == "determinism_pass":
        assert _undo_torch_rng(port) == 3
    assert ast.dump(port) == ast.dump(ref)
