"""determinism: charged/journaled paths are pure functions of
config + CostModel.

Two contracts depend on this. The sim-exec parity contract (BENCH
tables) asserts the 1024-GPU symbolic run charges bitwise-identical
ledger seconds across repeats; the resume/adoption contract replays
the journal and must land in exactly the state the dead controller
would have reached. Either one breaks the moment a charged path reads
a wall clock, an unseeded RNG, or the iteration order of an unordered
set.

Rules:
- forbidden calls: `time.time`/`time_ns`, `datetime.now`/`utcnow`,
  `os.urandom`, `uuid.uuid1`/`uuid4`, module-level `random.*`
  (anything but constructing a seeded `random.Random`), module-level
  `np.random.*` (anything but the seeded generator constructors), and
  torch's global generator: `torch.manual_seed`, and the draws of
  TORCH_RANDOM (`torch.rand`, `torch.randn`, ...) without `generator=`
  (a seeded `torch.Generator` threaded through is the port's rule).
  `time.perf_counter` stays legal: it feeds the measured-compile seam,
  which sim mode replaces with a CostModel charge by design.
- order-sensitive iteration over set-typed expressions (`for x in
  set(...)`, set displays, set-typed locals, set algebra) must wrap in
  `sorted(...)`. Generator arguments to order-insensitive reducers
  (`any`/`all`/`sum`/`min`/`max`/`len`/`sorted`/`set`/`frozenset`) are
  exempt; plain `for` statements never are.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .base import (AnalysisPass, Finding, Module, call_keyword, dotted,
                   functions, parent, terminal, walk_scope)

PASS_ID = "determinism"

FORBIDDEN = {
    "time.time": "wall-clock read",
    "time.time_ns": "wall-clock read",
    "datetime.now": "wall-clock read",
    "datetime.utcnow": "wall-clock read",
    "datetime.datetime.now": "wall-clock read",
    "datetime.datetime.utcnow": "wall-clock read",
    "os.urandom": "OS entropy",
    "uuid.uuid1": "host/time-derived id",
    "uuid.uuid4": "OS entropy",
}

ALLOWED_RANDOM = {"Random"}                 # random.Random(seed)
ALLOWED_NP_RANDOM = {"default_rng", "Generator", "RandomState",
                     "PCG64", "SeedSequence"}
# torch's draws from its global generator unless given generator=
TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}

# a generator argument consumed by one of these cannot leak iteration
# order into the result (tuple/list are deliberately absent: they DO)
ORDER_FREE_REDUCERS = {"any", "all", "sum", "min", "max", "len",
                       "sorted", "set", "frozenset"}

SET_BINOPS = (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)


class DeterminismPass(AnalysisPass):
    pass_id = PASS_ID

    def run_module(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        out.extend(self._forbidden_calls(module))
        for fn in functions(module.tree):
            out.extend(self._set_iteration(module, fn))
        return out

    # ------------------------------------------------- forbidden calls
    def _forbidden_calls(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            msg = None
            if d in FORBIDDEN:
                msg = (f"{d}() is {FORBIDDEN[d]} — charged/journaled "
                       f"paths must be deterministic")
            elif d.startswith("random."):
                name = d.split(".", 1)[1]
                if name not in ALLOWED_RANDOM:
                    msg = (f"module-level {d}() draws from the shared "
                           f"unseeded RNG; construct random.Random(seed) "
                           f"and thread it")
            elif d.startswith(("np.random.", "numpy.random.")):
                name = d.rsplit(".", 1)[1]
                if name not in ALLOWED_NP_RANDOM:
                    msg = (f"{d}() draws from the global numpy RNG; use "
                           f"np.random.default_rng(seed)")
            elif d == "torch.manual_seed" or (
                    d.startswith("torch.") and d[6:] in TORCH_RANDOM
                    and call_keyword(node, "generator") is None):
                msg = (f"{d}() uses torch's global generator; draw from "
                       f"a seeded torch.Generator passed as generator=")
            if msg:
                f = self.finding(module, node, msg)
                if f:
                    out.append(f)
        return out

    # ---------------------------------------------- set-iteration rule
    def _set_iteration(self, module: Module, fn) -> List[Finding]:
        out: List[Finding] = []
        known_sets = self._set_locals(fn)

        def is_set_expr(e: ast.AST) -> bool:
            if isinstance(e, (ast.Set, ast.SetComp)):
                return True
            if isinstance(e, ast.Call) and \
                    terminal(e.func) in ("set", "frozenset"):
                return True
            if isinstance(e, ast.Name) and e.id in known_sets:
                return True
            if isinstance(e, ast.BinOp) and isinstance(e.op, SET_BINOPS):
                return is_set_expr(e.left) or is_set_expr(e.right)
            return False

        for node in walk_scope(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if is_set_expr(node.iter):
                    f = self.finding(
                        module, node,
                        "for-loop iterates an unordered set — wrap the "
                        "iterable in sorted(...) so charged/journaled "
                        "order is stable")
                    if f:
                        out.append(f)
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                   ast.SetComp, ast.DictComp)):
                if not any(is_set_expr(g.iter) for g in node.generators):
                    continue
                p = parent(node)
                if (isinstance(p, ast.Call)
                        and terminal(p.func) in ORDER_FREE_REDUCERS
                        and node in p.args):
                    continue
                if isinstance(node, ast.SetComp):
                    continue        # produces a set again; flagged at use
                f = self.finding(
                    module, node,
                    "comprehension iterates an unordered set outside an "
                    "order-insensitive reducer — wrap the iterable in "
                    "sorted(...)")
                if f:
                    out.append(f)
        return out

    def _set_locals(self, fn) -> Set[str]:
        """Names assigned set-typed values anywhere in this scope
        (single forward sweep; set algebra on a known set propagates)."""
        known: Set[str] = set()

        def setish(e: ast.AST) -> bool:
            if isinstance(e, (ast.Set, ast.SetComp)):
                return True
            if isinstance(e, ast.Call) and \
                    terminal(e.func) in ("set", "frozenset"):
                return True
            if isinstance(e, ast.Name) and e.id in known:
                return True
            if isinstance(e, ast.BinOp) and isinstance(e.op, SET_BINOPS):
                return setish(e.left) or setish(e.right)
            return False

        for node in walk_scope(fn):
            if isinstance(node, ast.Assign) and setish(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        known.add(t.id)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and setish(node.value) and \
                    isinstance(node.target, ast.Name):
                known.add(node.target.id)
        return known
