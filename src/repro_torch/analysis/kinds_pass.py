"""delta-kinds: every DeltaPlan kind is handled on every dispatch
surface.

A migration delta flows through four layers — plan computation
(groups.py), the two-phase CCL switchover (two_phase.py), state
movement (state_sync.py), and the controller's step builders — and a
kind that half-lands (planned but not switchable, switchable but not
revertible) only explodes when a fault or a crash-adoption replays it.
This pass pins the kind universe to the literals in groups.py and
checks:

- every kind has a registered handler function on every surface, and
  that function actually exists there (a NEW kind fails on all four
  surfaces until each layer handles it);
- every `plan.kind` comparison uses a literal from the universe (typo
  guard);
- any function that dispatches on `plan.kind` mentions EVERY kind in
  the universe — the only sane way to satisfy this for a fallthrough
  `else` is an explicit `assert plan.kind == ...` guard, which is
  exactly the regression barrier we want.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .base import (AnalysisPass, Finding, Module, dotted, functions,
                   is_str, terminal, walk_scope)

PASS_ID = "delta-kinds"

# module basename -> kind -> handler function(s) that must exist there
SURFACES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "groups.py": {
        "replace": ("compute_delta_plan",),
        "reshard": ("compute_reshard_plan",),
        "dp_resize": ("compute_dp_resize_plan",),
    },
    "two_phase.py": {
        "replace": ("ccl_switchover",),
        "reshard": ("ccl_reshard_switchover",),
        "dp_resize": ("ccl_resize_switchover",),
    },
    "state_sync.py": {
        "replace": ("leaver_to_joiner",),
        "reshard": ("reshard_in_place",),
        "dp_resize": ("regrow_staff",),
    },
    "controller.py": {
        "replace": ("_expected_steps",),
        "reshard": ("_reshard_steps",),
        "dp_resize": ("_dp_shrink_steps", "_dp_grow_steps"),
    },
}

# receivers whose .kind is a DeltaPlan kind (campaign/migration reuse
# the attribute name for scenario and fault-point kinds)
PLAN_RECEIVERS = {"plan"}


class KindsPass(AnalysisPass):
    pass_id = PASS_ID

    def run_project(self, modules: Iterable[Module]) -> List[Finding]:
        modules = list(modules)
        by_name = {m.name: m for m in modules
                   if m.rel.endswith(f"core/{m.name}")}
        groups = by_name.get("groups.py")
        if groups is None:
            return []
        universe = self._universe(groups)
        out: List[Finding] = []
        for mod_name, table in SURFACES.items():
            mod = by_name.get(mod_name)
            if mod is None:
                continue
            defined = {f.name for f in functions(mod.tree)}
            for kind in sorted(universe):
                handlers = table.get(kind)
                if not handlers:
                    f = self.finding(
                        mod, 1,
                        f"DeltaPlan kind {kind!r} has no registered "
                        f"handler for surface {mod_name}; extend "
                        f"repro_torch.analysis.kinds_pass.SURFACES once the "
                        f"layer handles it")
                    if f:
                        out.append(f)
                    continue
                for h in handlers:
                    if h not in defined:
                        f = self.finding(
                            mod, 1,
                            f"registered handler {h}() for kind {kind!r} "
                            f"does not exist in {mod_name}")
                        if f:
                            out.append(f)
            out.extend(self._check_dispatch(mod, universe))
        return out

    # ------------------------------------------------------------------
    def _universe(self, groups: Module) -> Set[str]:
        """Kind literals in groups.py: the dataclass default plus every
        kind= keyword passed to a DeltaPlan construction."""
        kinds: Set[str] = set()
        for node in ast.walk(groups.tree):
            if isinstance(node, ast.ClassDef) and node.name == "DeltaPlan":
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)
                            and stmt.target.id == "kind"
                            and is_str(stmt.value)):
                        kinds.add(stmt.value.value)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "kind" and is_str(kw.value):
                        kinds.add(kw.value.value)
        return kinds

    def _kind_literals(self, fn) -> Tuple[List[Tuple[ast.AST, str]], bool]:
        """(literals compared against plan.kind, saw_if_dispatch)."""
        lits: List[Tuple[ast.AST, str]] = []
        dispatches = False

        def plan_kind(e) -> bool:
            return (isinstance(e, ast.Attribute) and e.attr == "kind"
                    and terminal(e.value) in PLAN_RECEIVERS)

        for node in walk_scope(fn):
            if isinstance(node, ast.Compare) and plan_kind(node.left):
                for comp in node.comparators:
                    if is_str(comp):
                        lits.append((node, comp.value))
                    elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                        for e in comp.elts:
                            if is_str(e):
                                lits.append((node, e.value))
            if isinstance(node, ast.If):
                test = node.test
                for sub in ast.walk(test):
                    if isinstance(sub, ast.Compare) and \
                            plan_kind(sub.left):
                        dispatches = True
        return lits, dispatches

    def _check_dispatch(self, mod: Module,
                        universe: Set[str]) -> List[Finding]:
        out: List[Finding] = []
        for fn in functions(mod.tree):
            lits, dispatches = self._kind_literals(fn)
            if not lits:
                continue
            for node, lit in lits:
                if lit not in universe:
                    f = self.finding(
                        mod, node,
                        f"comparison against unknown DeltaPlan kind "
                        f"{lit!r}; universe is {sorted(universe)}")
                    if f:
                        out.append(f)
            if dispatches:
                covered = {lit for _, lit in lits}
                missing = universe - covered
                if missing:
                    f = self.finding(
                        mod, fn,
                        f"`{fn.name}` dispatches on plan.kind but never "
                        f"mentions {sorted(missing)} — add explicit "
                        f"branches or an `assert plan.kind == ...` guard "
                        f"on the fallthrough")
                    if f:
                        out.append(f)
        return out
