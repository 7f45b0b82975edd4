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
  is left out."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro" / "core", \
    ROOT / "src" / "repro_torch" / "core"
COPIES = ["two_phase", "migration", "journal", "metrics", "policy",
          "baselines", "state_sync", "standby", "controller"]
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
    assert ast.dump(port) == ast.dump(ref)
