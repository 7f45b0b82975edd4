"""step-names: journaled run step names come only from the step
builders, and interpolate only stable identifiers.

Crash adoption (`Controller._adopt_run`) rebuilds an in-flight run by
re-running the SAME builder (`_expected_steps`, `_failure_steps`,
`_dp_shrink_steps`, `_dp_grow_steps`, `_reshard_steps`) and asserting
the rebuilt step-name list matches the journaled one byte for byte.
A `Step` constructed outside a builder — or a step name interpolating
anything but plain identifiers (a counter, a clock read, a dict whose
order can shift) — breaks that equation in a way only a crash at the
right instant can reveal.

Rules (core/ modules, excluding migration.py where Step is defined):
- every `Step(...)` call is lexically inside a `_*_steps` builder;
- the name argument is a string literal, or an f-string whose
  interpolations are bare names/attributes or simple subscripts of
  them (e.g. f"switch:{g.gid}", f"warmup:{staff[s]}").
"""
from __future__ import annotations

import ast
import re
from typing import List

from .base import (AnalysisPass, Finding, Module, enclosing_functions)

PASS_ID = "step-names"

BUILDER_RE = re.compile(r"^_\w*_steps$")


def _stable(expr: ast.AST) -> bool:
    """Names, attribute chains, and subscripts of them by stable keys:
    the interpolations a journal-replay rebuild reproduces exactly."""
    if isinstance(expr, (ast.Name, ast.Attribute)):
        return True
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Subscript):
        return _stable(expr.value) and _stable(expr.slice)
    return False


class StepsPass(AnalysisPass):
    pass_id = PASS_ID

    def applies(self, module: Module) -> bool:
        return ("/core/" in module.rel
                and not module.rel.endswith("core/migration.py"))

    def run_module(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Step"):
                continue
            if not any(BUILDER_RE.match(fn.name)
                       for fn in enclosing_functions(node)):
                f = self.finding(
                    module, node,
                    "Step() constructed outside a `_*_steps` builder — "
                    "crash adoption rebuilds runs by re-running the "
                    "builders, so ad-hoc steps cannot be re-created")
                if f:
                    out.append(f)
            if node.args:
                f = self._check_name(module, node, node.args[0])
                if f:
                    out.append(f)
        return out

    def _check_name(self, module: Module, call: ast.Call, name: ast.AST):
        if isinstance(name, ast.Constant) and isinstance(name.value, str):
            return None
        if isinstance(name, ast.JoinedStr):
            for part in name.values:
                if isinstance(part, ast.Constant):
                    continue
                if isinstance(part, ast.FormattedValue) and \
                        _stable(part.value):
                    continue
                return self.finding(
                    module, call,
                    "step name interpolates a non-stable expression; "
                    "only literals and bare identifiers (f\"swap:{mid}\") "
                    "survive a journal-replay rebuild")
            return None
        return self.finding(
            module, call,
            "step name must be a string literal or an f-string of "
            "stable identifiers, not a computed value")
