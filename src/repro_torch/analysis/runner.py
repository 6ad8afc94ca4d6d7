"""torch-lint runner: checker dispatch, suppressions, baseline round-trip.

The port's own copy of ``repro.analysis.runner``. Orchestrates the five
checkers over their scoped slices of ``src/repro_torch`` (the scopes of
the reference's runner, with the port's top-level ``lanes.py`` added to
the two retargeted rules) and applies the suppression contract:

1. A finding on a line carrying (or directly below) an inline
   ``# torch-lint: disable=<rule> -- <reason>`` comment is *suppressed*.
2. Every suppressed finding must also appear in
   ``src/repro_torch/analysis/baseline.json`` (rule + path + reason). A
   suppression without a baseline entry is an error — the baseline is the
   reviewed ledger, the comment is the in-situ justification, and both
   must exist.
3. A baseline entry with no live suppressed finding is *stale* and also
   an error, so the ledger can't rot.

``--update-baseline`` regenerates the ledger from the current inline
suppressions (it cannot invent one: a finding without an inline comment
stays active). Exit status: 0 clean, 1 findings or contract violations.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis import (config_discipline, freeze_mask,
                                  lock_discipline, telemetry, trace_safety)
from repro_torch.analysis.common import (Finding, dump_baseline,
                                         find_suppressions, iter_py,
                                         load_baseline, suppression_for)

#: checker module -> repo-relative directories (and files) it scans.
CHECKER_SCOPES = (
    (trace_safety, ("src/repro_torch/solvers", "src/repro_torch/core",
                    "src/repro_torch/gp", "src/repro_torch/online",
                    "src/repro_torch/lanes.py")),
    (config_discipline, ("src/repro_torch",)),
    (freeze_mask, ("src/repro_torch/solvers", "src/repro_torch/lanes.py")),
    (lock_discipline, ("src/repro_torch",)),
    (telemetry, ("src/repro_torch",)),
)

BASELINE = "src/repro_torch/analysis/baseline.json"


def collect_findings(root: Path) -> List[Finding]:
    """All raw findings from all checkers (suppressions not yet applied)."""
    findings: List[Finding] = []
    for checker, dirs in CHECKER_SCOPES:
        paths = list(iter_py(root, dirs))
        findings.extend(checker.run(paths, root))
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))


def partition(root: Path, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Tuple[Finding, str]],
                         List[str]]:
    """Split findings into (active, suppressed(+reason), errors)."""
    active: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    errors: List[str] = []
    cache: Dict[str, dict] = {}
    for f in findings:
        if f.path not in cache:
            try:
                cache[f.path] = find_suppressions(
                    (root / f.path).read_text(encoding="utf-8"))
            except OSError:
                cache[f.path] = {}
        sup = suppression_for(f, cache[f.path])
        if sup is None:
            active.append(f)
        elif not sup.reason:
            errors.append(
                f"{f.path}:{sup.line}: suppression for [{f.rule}] has no "
                "reason — write `# torch-lint: disable=<rule> -- <why>`")
            active.append(f)
        else:
            suppressed.append((f, sup.reason))
    return active, suppressed, errors


def check_baseline(root: Path,
                   suppressed: Sequence[Tuple[Finding, str]]) -> List[str]:
    """Cross-validate inline suppressions against baseline.json."""
    errors: List[str] = []
    entries = load_baseline(root / BASELINE)
    baseline_keys = {(e["rule"], e["path"]) for e in entries}
    live_keys = {(f.rule, f.path) for f, _ in suppressed}
    for f, _reason in suppressed:
        if (f.rule, f.path) not in baseline_keys:
            errors.append(
                f"{f.path}:{f.line}: suppressed [{f.rule}] finding missing "
                f"from {BASELINE} — run `python tools/torch_lint.py "
                "--update-baseline` and commit the reviewed entry")
    for rule, path in sorted(baseline_keys - live_keys):
        errors.append(
            f"{BASELINE}: stale entry [{rule}] for {path} — no matching "
            "inline suppression remains; remove it (or re-run "
            "--update-baseline)")
    return errors


def update_baseline(root: Path,
                    suppressed: Sequence[Tuple[Finding, str]]) -> int:
    """Rewrite baseline.json from the current inline suppressions."""
    seen = set()
    entries = []
    for f, reason in suppressed:
        key = (f.rule, f.path)
        if key not in seen:
            seen.add(key)
            entries.append({"rule": f.rule, "path": f.path,
                            "reason": reason})
    dump_baseline(root / BASELINE, entries)
    print(f"wrote {len(entries)} entries to {BASELINE}")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    """CLI entry point; returns the process exit status."""
    ap = argparse.ArgumentParser(
        prog="torch_lint",
        description="Project-invariant static analysis for the PyTorch "
                    "port (host syncs in loops, config discipline, freeze "
                    "masks, lock discipline, telemetry hygiene).")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--check", action="store_true",
                    help="explicit check mode (the default behaviour)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="regenerate analysis/baseline.json from the "
                         "current inline suppressions")
    ap.add_argument("--verbose", action="store_true",
                    help="also list suppressed findings")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    findings = collect_findings(root)
    active, suppressed, errors = partition(root, findings)

    if args.update_baseline:
        return update_baseline(root, suppressed)

    errors.extend(check_baseline(root, suppressed))
    for f in active:
        print(f.render())
    for e in errors:
        print(e)
    if args.verbose:
        for f, reason in suppressed:
            print(f"suppressed: {f.path}:{f.line} [{f.rule}] — {reason}")
    n = len(active) + len(errors)
    if n:
        print(f"torch-lint: {len(active)} finding(s), "
              f"{len(errors)} contract error(s)")
        return 1
    print(f"torch-lint: clean ({len(suppressed)} baselined suppression(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
