"""Shared infrastructure for the invariant linter.

The resilience contract this repo reproduces (TrainMover's ~20 s
downtime claim) rests on properties the tests only exercise
dynamically: every durable controller mutation is journaled, every
transfer charges the SimClock ledger, every charged path is a
deterministic function of config + CostModel. The passes in this
package prove those properties statically, over the AST, so a
violation fails CI before any scenario happens to hit it.

Vocabulary shared by every pass:

- `Finding`: one violation (file/line/pass/severity/message). Baseline
  identity is (file, pass, message) — line numbers shift too easily.
- pragma: `# repro: allow(<pass-id>[, <pass-id>...])` on the flagged
  line or the line directly above suppresses the finding. Pragmas are
  for invariants enforced at ANOTHER layer (e.g. a mutation journaled
  by the run-commit path), never for real violations.
- `Module`: a parsed source file with parent links and the pragma map.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Set

PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\(([a-z0-9_*,\s-]+)\)")

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    file: str          # repo-relative posix path
    line: int
    pass_id: str
    severity: str
    message: str

    def key(self):
        """Baseline identity: stable across unrelated line shifts."""
        return (self.file, self.pass_id, self.message)

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line,
                "pass": self.pass_id, "severity": self.severity,
                "message": self.message}

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.pass_id}] "
                f"{self.severity}: {self.message}")


class Module:
    """One parsed source file plus the lint-relevant derived state."""

    def __init__(self, rel: str, source: str):
        self.rel = rel.replace("\\", "/")
        self.name = Path(rel).name
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        self._allowed: Dict[int, Set[str]] = {}
        for i, ln in enumerate(source.splitlines(), 1):
            m = PRAGMA_RE.search(ln)
            if m:
                self._allowed[i] = {p.strip()
                                    for p in m.group(1).split(",") if p.strip()}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._repro_parent = node  # type: ignore[attr-defined]

    def allowed(self, line: int, pass_id: str) -> bool:
        """Pragma on the flagged line or the line directly above."""
        for ln in (line, line - 1):
            ids = self._allowed.get(ln)
            if ids and (pass_id in ids or "*" in ids):
                return True
        return False


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_repro_parent", None)


def dotted(node: ast.AST) -> str:
    """'self.engine.swap_machine' for nested attribute chains, '' when
    the chain bottoms out in anything but a Name (e.g. a call)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def terminal(node: ast.AST) -> str:
    """Last segment of a call target: Name id or Attribute attr."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every function/method at any nesting depth."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_scope(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes lexically inside `fn` but NOT inside a nested function,
    lambda or class — each nested def is its own accounting scope
    (its body runs at call time, not when the outer frame executes).
    The nested scope node itself IS yielded so callers can see it."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPE_NODES):
            continue
        stack.extend(ast.iter_child_nodes(node))


def enclosing_functions(node: ast.AST) -> List[ast.FunctionDef]:
    """Ancestor chain of function defs, innermost first."""
    out: List[ast.FunctionDef] = []
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = parent(cur)
    return out


def call_keyword(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def is_str(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


class AnalysisPass:
    """A single invariant pass. Most passes are per-module; a pass
    needing cross-module state (kind exhaustiveness) overrides
    `run_project` instead."""

    pass_id: str = ""

    def applies(self, module: Module) -> bool:
        return True

    def run_module(self, module: Module) -> List[Finding]:
        return []

    def run_project(self, modules: Iterable[Module]) -> List[Finding]:
        out: List[Finding] = []
        for m in modules:
            if self.applies(m):
                out.extend(self.run_module(m))
        return out

    def finding(self, module: Module, node, message: str,
                severity: str = SEVERITY_ERROR) -> Optional[Finding]:
        """Build a Finding unless a pragma suppresses it."""
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        if module.allowed(line, self.pass_id):
            return None
        return Finding(module.rel, line, self.pass_id, severity, message)
