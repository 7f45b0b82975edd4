"""charge-coverage: no free-riding communication.

Every transfer/collective call site must thread the SimClock so its
seconds land on a ledger lane, and every explicit lane must come from
the known universe (`repro_torch.cluster.simclock.KNOWN_LANES` — the same
frozenset the runtime asserts against, so the static pass and the
dynamic ledger can never disagree about what a lane is).

The paper's downtime table is only as honest as this accounting: a
transfer that skips the clock (like the DP-peer fetch fixed in the
journal PR) shows up as free bandwidth and silently deflates the
reported downtime.

Rules:
- `clock.advance(...)` / `clock.parallel(...)` / `wait_async` /
  `drain_async`: the lane argument must be a string literal in
  KNOWN_LANES or a plain threaded name; computed lanes are opaque to
  both this pass and the reader.
- `clock.issue_async((kind, ...), ...)`: a literal channel tuple must
  name a known channel kind ("compute" | "allreduce" | "p2p").
- calls to the state_sync transfer functions must pass a clock, and
  the `charge=`-capable ones (`leaver_to_joiner`, `regrow_staff`) must
  say explicitly whether they charge; a literal `charge=False` is only
  legal when the same scope visibly accounts the time itself
  (`advance` / `issue_async` / `wait_async` / `parallel`).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.cluster.simclock import KNOWN_LANES

from .base import (AnalysisPass, Finding, Module, call_keyword, dotted,
                   functions, terminal, walk_scope)

PASS_ID = "charge-coverage"

KNOWN_CHANNEL_KINDS = frozenset({"compute", "allreduce", "p2p"})

# transfer functions that accept an explicit charge= switch
CHARGE_FNS = {"leaver_to_joiner", "regrow_staff"}
# every state_sync transfer entry point: must thread a clock
CLOCK_FNS = CHARGE_FNS | {"recover_state", "reshard_in_place"}
# calls that account time on the ledger (evidence the scope pays
# for a charge=False transfer itself)
ACCOUNTING_ATTRS = {"advance", "issue_async", "wait_async", "parallel"}

# (method name, positional index of the lane argument)
LANE_ARG_POS = {"advance": 2, "parallel": 1, "wait_async": 1,
                "drain_async": 0}


def _is_clock_recv(func: ast.Attribute) -> bool:
    recv = dotted(func.value)
    return recv == "clock" or recv.endswith(".clock") or recv == "self"


class ChargePass(AnalysisPass):
    pass_id = PASS_ID

    def run_module(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for fn in functions(module.tree):
            accounts = False
            calls = []
            for node in walk_scope(fn):
                if isinstance(node, ast.Call):
                    calls.append(node)
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr in ACCOUNTING_ATTRS):
                        accounts = True
                elif isinstance(node, ast.withitem):
                    ctx = node.context_expr
                    if (isinstance(ctx, ast.Call)
                            and isinstance(ctx.func, ast.Attribute)
                            and ctx.func.attr == "parallel"):
                        accounts = True
            for call in calls:
                out.extend(self._check_call(module, fn, call, accounts))
        return out

    # ------------------------------------------------------------------
    def _check_call(self, module: Module, fn, call: ast.Call,
                    scope_accounts: bool) -> List[Finding]:
        out: List[Finding] = []
        func = call.func
        t = terminal(func)

        if isinstance(func, ast.Attribute) and _is_clock_recv(func):
            if t in LANE_ARG_POS:
                f = self._check_lane(module, call, t)
                if f:
                    out.append(f)
            if t == "issue_async" and call.args:
                f = self._check_channel(module, call)
                if f:
                    out.append(f)

        if t in CLOCK_FNS:
            # skip the defining module (the defs themselves are not
            # call sites; internal helpers never re-enter these)
            if not module.rel.endswith("core/state_sync.py"):
                out.extend(self._check_transfer(module, call, t,
                                                scope_accounts))
        return out

    def _check_lane(self, module: Module, call: ast.Call,
                    method: str) -> Optional[Finding]:
        lane = call_keyword(call, "lane")
        if lane is None:
            pos = LANE_ARG_POS[method]
            if len(call.args) > pos:
                lane = call.args[pos]
        if lane is None:
            return None                      # default lane ("train")
        if isinstance(lane, ast.Constant):
            if lane.value in KNOWN_LANES:
                return None
            return self.finding(
                module, call,
                f"{method}() charges unknown lane {lane.value!r}; known "
                f"lanes: {sorted(KNOWN_LANES)}")
        if isinstance(lane, (ast.Name, ast.Attribute)) and dotted(lane):
            return None                      # threaded lane parameter
        if isinstance(lane, ast.IfExp):
            bad = [b for b in (lane.body, lane.orelse)
                   if isinstance(b, ast.Constant)
                   and b.value not in KNOWN_LANES]
            if bad:
                return self.finding(
                    module, call,
                    f"{method}() conditional lane includes unknown lane "
                    f"{bad[0].value!r}")
            return None
        return self.finding(
            module, call,
            f"{method}() lane must be a literal lane name or a threaded "
            f"parameter, not a computed expression")

    def _check_channel(self, module: Module,
                       call: ast.Call) -> Optional[Finding]:
        chan = call.args[0]
        if not isinstance(chan, ast.Tuple) or not chan.elts:
            return None                      # threaded channel object
        kind = chan.elts[0]
        if not isinstance(kind, ast.Constant):
            return self.finding(
                module, call,
                "issue_async() channel kind must be a string literal so "
                "the ledger's channel universe stays auditable")
        if kind.value not in KNOWN_CHANNEL_KINDS:
            return self.finding(
                module, call,
                f"issue_async() uses unknown channel kind {kind.value!r}; "
                f"known kinds: {sorted(KNOWN_CHANNEL_KINDS)}")
        return None

    def _check_transfer(self, module: Module, call: ast.Call, name: str,
                        scope_accounts: bool) -> List[Finding]:
        out: List[Finding] = []
        passed = list(call.args) + [kw.value for kw in call.keywords]
        has_clock = any(
            dotted(a) == "clock" or dotted(a).endswith(".clock")
            for a in passed)
        if not has_clock:
            f = self.finding(
                module, call,
                f"{name}() call does not thread a clock — the transfer "
                f"would free-ride the ledger")
            if f:
                out.append(f)
        if name in CHARGE_FNS:
            charge = call_keyword(call, "charge")
            if charge is None:
                f = self.finding(
                    module, call,
                    f"{name}() call must pass charge= explicitly (True to "
                    f"charge here, False when the caller accounts the "
                    f"parallel time itself)")
                if f:
                    out.append(f)
            elif (isinstance(charge, ast.Constant)
                  and charge.value is False and not scope_accounts):
                f = self.finding(
                    module, call,
                    f"{name}(charge=False) but the enclosing scope never "
                    f"accounts the time (no advance/issue_async/"
                    f"wait_async/parallel)")
                if f:
                    out.append(f)
        return out
