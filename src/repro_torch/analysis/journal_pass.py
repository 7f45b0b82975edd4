"""journal-coverage: durable Controller mutations pair with a journal
write in the same function scope.

The self-healing control plane (write-ahead ControlJournal, crash
restart, run adoption) only works if EVERY mutation of durable state —
topology, the standby pool, the storage index, the epoch signature,
run step logs — reaches the journal before the next crash window. A
single unjournaled mutation silently breaks `Controller.restart()`
adoption; no unit test is guaranteed to hit the crash point that
exposes it.

The rule is lexical and per-scope: a trigger (mutation) inside a
function body requires one of its paired journal calls inside the SAME
function body (nested defs are their own scope — a closure runs at
step-execution time, not when the builder frame runs). Mutations
journaled by a different layer (e.g. the run-commit path in
`_drive_run`) carry a `# repro: allow(journal-coverage)` pragma naming
that layer.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .base import (AnalysisPass, Finding, Module, call_keyword, dotted,
                   functions, is_str, terminal, walk_scope)

PASS_ID = "journal-coverage"

# helper-call spellings counted as journal writes; "append:<rtype>"
# entries match `self.journal.append("<rtype>", ...)` literals
JOURNAL_HELPERS = {
    "_journal_topology", "_journal_standbys", "_journal_storage_index",
    "_journal_epoch", "_journal_run_begin", "_journal_run_meta",
    "_journal_policy",
}

LIST_MUTATORS = {"append", "remove", "pop", "clear", "extend", "insert"}
DICT_MUTATORS = {"pop", "update", "setdefault", "clear", "popitem"}
SET_MUTATORS = {"add", "discard", "remove", "update", "pop", "clear"}


class JournalPass(AnalysisPass):
    pass_id = PASS_ID

    def applies(self, module: Module) -> bool:
        return module.rel.endswith("core/controller.py")

    def run_module(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for fn in functions(module.tree):
            if fn.name == "__init__":
                # constructing the object establishes the empty
                # pre-bootstrap state; nothing durable exists until
                # bootstrap_job journals the first snapshot
                continue
            present = _journal_calls_in(fn)
            for node, required, desc in _triggers_in(fn):
                if present & required:
                    continue
                want = " or ".join(sorted(required))
                f = self.finding(
                    module, node,
                    f"durable mutation ({desc}) in `{fn.name}` has no "
                    f"paired journal write; expected {want} in the same "
                    f"function scope")
                if f:
                    out.append(f)
        return out


def _journal_calls_in(fn: ast.AST) -> Set[str]:
    """Journal writes present in this scope: helper names plus
    'append:<rtype>' for direct self.journal.append calls."""
    present: Set[str] = set()
    for node in walk_scope(fn):
        if not isinstance(node, ast.Call):
            continue
        t = terminal(node.func)
        if t in JOURNAL_HELPERS:
            present.add(t)
        elif t == "append" and dotted(node.func).endswith("journal.append"):
            if node.args and is_str(node.args[0]):
                present.add(f"append:{node.args[0].value}")
    return present


def _triggers_in(fn: ast.AST):
    """Yield (node, required_any_of, description) for every durable
    mutation in this scope."""
    for node in walk_scope(fn):
        if isinstance(node, ast.Call):
            yield from _call_triggers(node)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                yield from _store_triggers(node, t)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                yield from _store_triggers(node, t)


def _call_triggers(node: ast.Call):
    func = node.func
    t = terminal(func)
    recv = dotted(func.value) if isinstance(func, ast.Attribute) else ""

    # ---- standby pool
    if recv == "self.standbys" and t in LIST_MUTATORS:
        yield node, {"_journal_standbys"}, f"self.standbys.{t}()"
    if t == "replenish":
        passed = list(node.args) + [kw.value for kw in node.keywords]
        if any(dotted(a) == "self.standbys" for a in passed):
            yield node, {"_journal_standbys"}, "replenish(self.standbys)"

    # ---- topology (group membership / grid occupancy)
    if dotted(func) == "self.engine.setup":
        yield node, {"_journal_topology"}, "engine.setup()"
        yield node, {"_journal_epoch"}, "engine.setup() resets the epoch"
    if t == "swap_machine":
        yield node, {"_journal_topology"}, "engine.swap_machine()"
    if t == "establish_all":
        yield node, {"_journal_topology"}, "group.establish_all()"
    if dotted(func) == "run.rollback":
        yield node, {"_journal_topology"}, "run.rollback() reverts groups"
    if dotted(func) == "run.execute":
        yield (node, {"_journal_topology"},
               "run.execute() commits switch/swap steps")
        yield node, {"_journal_epoch"}, "run.execute() advances the epoch"

    # ---- recovery-policy decisions (core/policy.py)
    # a decision that dispatches a recovery must be durable BEFORE the
    # dispatch, or a crash-restarted controller adopting the run can
    # not see the choice it is replaying
    if recv == "self.policy_engine" and t == "decide":
        yield (node, {"_journal_policy"},
               "policy_engine.decide() picks a recovery")

    # ---- run lifecycle
    if isinstance(func, ast.Name) and func.id == "MigrationRun":
        yield (node, {"_journal_run_begin", "append:run_adopt"},
               "MigrationRun construction")
    if t == "record_switch":
        yield (node, {"append:run_switch"},
               "record_switch() stages a revertible plan")
    if t in ("dp_retire", "dp_restaff"):
        yield (node, {"_journal_run_meta"},
               f"engine.{t}() resizes the DP grid")

    # ---- run recovery context (pairing / xferred close-overs)
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        base = func.value.id
        if base == "pairing" and t in DICT_MUTATORS:
            yield (node, {"_journal_run_meta", "_journal_run_begin"},
                   f"pairing.{t}()")
        if base == "xferred" and t in SET_MUTATORS:
            yield (node, {"_journal_run_meta", "_journal_run_begin"},
                   f"xferred.{t}()")


def _store_triggers(stmt: ast.AST, target: ast.AST):
    d = dotted(target)
    if d == "self.standbys":
        yield stmt, {"_journal_standbys"}, "self.standbys assignment"
    elif d in ("self.storage", "self.storage_coords"):
        yield stmt, {"_journal_storage_index"}, f"{d} assignment"
    elif d == "self.engine.step_count":
        yield stmt, {"_journal_epoch"}, "engine.step_count assignment"
    elif isinstance(target, ast.Subscript):
        base = dotted(target.value)
        if base in ("self.storage", "self.storage_coords"):
            yield stmt, {"_journal_storage_index"}, f"{base}[...] store"
        elif base == "pairing":
            yield (stmt, {"_journal_run_meta", "_journal_run_begin"},
                   "pairing[...] store")
