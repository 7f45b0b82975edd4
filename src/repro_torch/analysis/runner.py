"""Pass runner, baseline machinery, and output formatting.

The baseline file (the port's own, `analysis-baseline-torch.json` at
the repo root) exists for grandfathering findings during an
incremental rollout. It is
checked in EMPTY and the contract is that it stays empty: real
violations get fixed, layer-enforced exceptions get a pragma naming
the enforcing layer. Two failure modes are distinguished so CI stays
honest in both directions:

- a finding not in the baseline -> exit 1 (new violation);
- a baseline entry matching no finding -> exit 2 with a "remove from
  baseline" message (the violation was fixed; a stale entry would
  silently re-admit a regression with the same message).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .base import AnalysisPass, Finding, Module
from .charge_pass import ChargePass
from .determinism_pass import DeterminismPass
from .journal_pass import JournalPass
from .kinds_pass import KindsPass
from .steps_pass import StepsPass

DEFAULT_ROOTS = ("src/repro_torch/core", "src/repro_torch/cluster",
                 "src/repro_torch/train")
BASELINE_NAME = "analysis-baseline-torch.json"

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_STALE_BASELINE = 2


def all_passes() -> List[AnalysisPass]:
    return [JournalPass(), ChargePass(), DeterminismPass(), KindsPass(),
            StepsPass()]


def repo_root() -> Path:
    # src/repro_torch/analysis/runner.py -> analysis -> repro_torch ->
    # src -> root
    return Path(__file__).resolve().parents[3]


def load_modules(root: Optional[Path] = None,
                 paths: Optional[Sequence[str]] = None) -> List[Module]:
    root = root or repo_root()
    files: List[Path] = []
    if paths:
        for p in paths:
            pp = Path(p)
            if not pp.is_absolute():
                pp = root / pp
            if pp.is_dir():
                files.extend(sorted(pp.rglob("*.py")))
            else:
                files.append(pp)
    else:
        for r in DEFAULT_ROOTS:
            d = root / r
            if d.is_dir():
                files.extend(sorted(d.rglob("*.py")))
    modules = []
    for f in files:
        rel = f.relative_to(root).as_posix() if f.is_relative_to(root) \
            else f.as_posix()
        modules.append(Module(rel, f.read_text()))
    return modules


def run_passes(modules: Iterable[Module],
               passes: Optional[Sequence[AnalysisPass]] = None
               ) -> List[Finding]:
    modules = list(modules)
    findings: List[Finding] = []
    for p in passes if passes is not None else all_passes():
        findings.extend(p.run_project(modules))
    return sorted(findings, key=lambda f: (f.file, f.line, f.pass_id,
                                           f.message))


# ---------------------------------------------------------- baseline
@dataclass
class BaselineResult:
    new: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[dict] = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        if self.stale:
            return EXIT_STALE_BASELINE
        if self.new:
            return EXIT_FINDINGS
        return EXIT_CLEAN


def load_baseline(path: Path) -> List[dict]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", []))


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[dict]) -> BaselineResult:
    res = BaselineResult()
    keys = {(e.get("file"), e.get("pass"), e.get("message")): e
            for e in baseline}
    matched = set()
    for f in findings:
        if f.key() in keys:
            matched.add(f.key())
            res.suppressed.append(f)
        else:
            res.new.append(f)
    for k, e in keys.items():
        if k not in matched:
            res.stale.append(e)
    return res


# ------------------------------------------------------------ output
def render_human(result: BaselineResult) -> str:
    lines: List[str] = []
    for f in result.new:
        lines.append(f.render())
    for e in result.stale:
        lines.append(
            f"{e.get('file')}: [{e.get('pass')}] stale baseline entry — "
            f"the finding no longer fires; remove from baseline: "
            f"{e.get('message')}")
    n, s, st = len(result.new), len(result.suppressed), len(result.stale)
    lines.append(f"repro_torch.analysis: {n} finding(s), {s} baselined, "
                 f"{st} stale baseline entr{'y' if st == 1 else 'ies'}")
    return "\n".join(lines)


def render_json(result: BaselineResult) -> str:
    return json.dumps({
        "findings": [f.to_dict() for f in result.new],
        "baselined": [f.to_dict() for f in result.suppressed],
        "stale_baseline": result.stale,
        "exit_code": result.exit_code,
    }, indent=2)


def run(paths: Optional[Sequence[str]] = None,
        baseline_path: Optional[Path] = None,
        root: Optional[Path] = None) -> BaselineResult:
    modules = load_modules(root=root, paths=paths)
    findings = run_passes(modules)
    baseline = load_baseline(baseline_path) if baseline_path else []
    return apply_baseline(findings, baseline)
