"""Shared plumbing for the torch-lint checkers; the port's own copy of
``repro.analysis.common`` with its own suppression marker and rules.

A finding is (rule, path, line, message, hint). Paths are repo-relative
POSIX strings so findings are stable across machines and usable as
baseline keys. Suppressions are inline comments of the form::

    x = bad_thing()  # torch-lint: disable=<rule> -- <reason>

(the separator may be ``--`` or an em/en dash; the reason is mandatory).
A suppression matches findings on its own line or on the line directly
below it (comment-above style). Suppressed findings must additionally be
recorded in ``src/repro_torch/analysis/baseline.json`` — see
:mod:`repro_torch.analysis.runner` for the round-trip contract. The marker
differs from the reference suite's ``repro-lint`` so the two ledgers never
answer for each other's findings.

Everything here is stdlib-only (``ast`` + ``pathlib``): the suite runs in a
bare job with neither torch nor jax installed.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: All rule IDs the suite can emit (one entry per checker sub-rule).
ALL_RULES = (
    "trace-host-sync",
    "trace-python-branch",
    "config-static-traced",
    "config-static-array",
    "freeze-mask",
    "lock-discipline",
    "telemetry-label",
    "telemetry-event-schema",
)

_SUPPRESS_RE = re.compile(
    r"#\s*torch-lint:\s*disable=([A-Za-z0-9_,-]+)"
    r"(?:\s*(?:--|—|–)\s*(\S[^\n]*))?"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a specific source location."""

    rule: str
    path: str  # repo-relative POSIX path
    line: int
    message: str
    hint: str = ""

    def render(self) -> str:
        """Human-readable one-liner, ``path:line: [rule] message``."""
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


@dataclass(frozen=True)
class Suppression:
    """An inline ``# torch-lint: disable=`` comment."""

    rules: Tuple[str, ...]
    reason: str
    line: int
    comment_only: bool = False  # whole line is a comment (applies below)


def rel(path: Path, root: Path) -> str:
    """``path`` relative to ``root`` as a POSIX string (or absolute posix)."""
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def parse_file(path: Path) -> Tuple[ast.AST, str]:
    """Parse ``path``; returns ``(tree, source)``."""
    source = path.read_text(encoding="utf-8")
    return ast.parse(source, filename=str(path)), source


def iter_py(root: Path, rel_dirs: Sequence[str]) -> Iterator[Path]:
    """Yield each ``root``-relative ``.py`` file, and the ``*.py`` files
    under each ``root``-relative directory, sorted."""
    for d in rel_dirs:
        base = root / d
        if base.is_file():
            yield base
            continue
        if not base.exists():
            continue
        for p in sorted(base.rglob("*.py")):
            if "__pycache__" not in p.parts:
                yield p


def find_suppressions(source: str) -> Dict[int, Suppression]:
    """Map line number -> suppression for every inline disable comment.

    A malformed comment (missing reason) is surfaced as a suppression with
    an empty reason; the runner turns that into an error rather than
    honouring it, so a justification can never be silently omitted.
    """
    out: Dict[int, Suppression] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            out[i] = Suppression(rules=rules, reason=(m.group(2) or "").strip(),
                                 line=i,
                                 comment_only=text.lstrip().startswith("#"))
    return out


def suppression_for(finding: Finding,
                    suppressions: Dict[int, Suppression]) -> Optional[Suppression]:
    """The suppression covering ``finding``, if any.

    Matches a comment on the finding's own line, or a comment-only line
    directly above it (a *trailing* comment never leaks downward).
    """
    sup = suppressions.get(finding.line)
    if sup is not None and finding.rule in sup.rules:
        return sup
    sup = suppressions.get(finding.line - 1)
    if sup is not None and sup.comment_only and finding.rule in sup.rules:
        return sup
    return None


def load_baseline(path: Path) -> List[dict]:
    """Read ``baseline.json``; each entry is ``{rule, path, reason}``."""
    if not path.exists():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    return list(data.get("suppressions", []))


def dump_baseline(path: Path, entries: Iterable[dict]) -> None:
    """Write ``baseline.json`` (sorted, stable formatting)."""
    entries = sorted(entries, key=lambda e: (e["path"], e["rule"]))
    payload = {
        "_comment": (
            "Reviewed intentional violations. Every entry must have a "
            "matching inline '# torch-lint: disable=<rule> -- <reason>' "
            "comment at the finding site. Regenerate with "
            "'python tools/torch_lint.py --update-baseline'."
        ),
        "suppressions": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target (``a.b.c(...)`` -> ``"a.b.c"``)."""
    return dotted(node.func)


def dotted(node: ast.AST) -> str:
    """Dotted path of a Name/Attribute chain, '' if not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


#: Function and lambda nodes: their bodies run when called, not in place.
DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def own_nodes(node: ast.AST) -> Iterator[ast.AST]:
    """Every node under ``node``, not descending into nested defs."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, DEFS):
            yield from own_nodes(child)
