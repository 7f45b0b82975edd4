"""Static invariant linter for the resilience contract: the port's own
copy of `repro/analysis` (the reference's text but for its root, its
package name, its baseline file and the determinism pass's rule for
torch's global generator; `tests/test_torch_core_copies.py` holds it to
the reference's syntax tree). It imports nothing of `repro`.

`python -m repro_torch.analysis` runs five AST passes over the port's
core/, cluster/ and train/ and exits non-zero on any violation:

- journal-coverage: durable Controller mutations pair with a journal
  write in the same function scope (crash adoption depends on it);
- charge-coverage: transfers thread the SimClock and lanes/channels
  come from the known universe (no free-riding comm);
- determinism: no wall clocks, no unseeded RNGs (torch's global
  generator included), no unordered-set iteration on charged/journaled
  paths (sim-exec parity);
- delta-kinds: every DeltaPlan kind handled on all four dispatch
  surfaces (a new kind cannot half-land);
- step-names: journaled step names built only by the `_*_steps`
  builders from stable identifiers (adoption rebuilds by name).

See docs/invariants.md for the invariant statements and the
`# repro: allow(<pass>)` pragma contract, which the port keeps; its
baseline is `analysis-baseline-torch.json` at the repo root.
"""
from .base import (AnalysisPass, Finding, Module, SEVERITY_ERROR,
                   SEVERITY_WARNING)
from .runner import (BASELINE_NAME, BaselineResult, EXIT_CLEAN,
                     EXIT_FINDINGS, EXIT_STALE_BASELINE, all_passes,
                     apply_baseline, load_baseline, load_modules,
                     render_human, render_json, repo_root, run,
                     run_passes)

__all__ = [
    "AnalysisPass", "Finding", "Module", "SEVERITY_ERROR",
    "SEVERITY_WARNING", "BASELINE_NAME", "BaselineResult", "EXIT_CLEAN",
    "EXIT_FINDINGS", "EXIT_STALE_BASELINE", "all_passes",
    "apply_baseline", "load_baseline", "load_modules", "render_human",
    "render_json", "repo_root", "run", "run_passes",
]
