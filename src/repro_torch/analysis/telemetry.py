"""Telemetry hygiene checker: bounded labels, schema'd events.

The port's own copy of ``repro.analysis.telemetry``, over ``src/repro_torch``
(the port emits the reference's event kinds with the reference's keys).

Two rules protect the observability plane:

* ``telemetry-label`` — metric label values must come from bounded sets.
  A label built with an f-string / ``.format`` / ``%`` / string
  concatenation of request or traced data mints a new time series per
  distinct value; the fleet scraper re-exports every series per
  replica, so one unbounded label cardinality-explodes the whole fleet
  plane. Checked at every ``self._m_*.inc/.set/.observe(...)`` call
  site, including one hop through a local name assigned in the same
  function. (``str(x)`` of an already-bounded value, e.g. a bucket size,
  is the sanctioned spelling.)
* ``telemetry-event-schema`` — ``emit("<kind>", ...)`` events are the
  repo's wire format for ``tools/trace_report.py`` and the tests; their
  kinds and keys are documented in ``docs/observability.md`` /
  ``docs/adaptive.md``. An unknown kind or an off-schema key silently
  breaks every downstream consumer, so both are flagged at the call
  site. ``**dynamic`` payloads are skipped (they are schema'd at the
  producer, e.g. the driver's ``solve_step`` fields).

``EVENT_SCHEMAS`` below is the canonical machine-readable copy of the
documented schemas; extend it in the same change that documents a new event
kind.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.common import Finding, parse_file, rel

#: Event kind -> allowed field names (docs/observability.md, docs/adaptive.md).
EVENT_SCHEMAS: Dict[str, frozenset] = {
    "request": frozenset({"method", "path", "status", "dur_ms"}),
    "admission": frozenset({"outcome", "rows", "priority", "retry_after_s",
                            "inflight"}),
    "span": frozenset({"span", "dur_ms", "error", "rows", "bucket", "id",
                       "parent", "thread", "start_ns", "end_ns", "step",
                       "lanes"}),
    "solve_step": frozenset({"step", "solver", "lane", "res_y", "res_z",
                             "iters", "epochs", "step_time_s",
                             "res_history"}),
    "fit_done": frozenset({"solver", "num_steps", "total_iters",
                           "total_epochs", "wall_time_s", "solver_time_s"}),
    "budget_decision": frozenset({"step", "solver", "lane", "alloc",
                                  "pred_to_tol", "realised", "res", "slope",
                                  "noise", "perturbation", "grad_noise",
                                  "pool", "epochs_per_iter"}),
    "refresh": frozenset({"mode", "n", "appended", "epochs", "iters",
                          "res_y", "res_z", "escalated", "corrected",
                          "trace_ids"}),
    "slo_alert": frozenset({"slo", "from_state", "to_state", "objective",
                            "burn_rates"}),
}

#: Keys every event may carry (stamped by the EventLog itself or tracing).
GLOBAL_EVENT_KEYS = frozenset({"ts", "kind", "trace_id"})

_LABEL_METHODS = {"inc", "set", "observe"}


def _is_unbounded_expr(expr: ast.AST) -> Optional[str]:
    """Why ``expr`` is an unbounded label value, or None if it's fine."""
    if isinstance(expr, ast.JoinedStr):
        return "f-string"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "format":
        return ".format() call"
    if isinstance(expr, ast.BinOp):
        if isinstance(expr.op, ast.Mod):
            return "%-formatting"
        if isinstance(expr.op, ast.Add):
            for side in (expr.left, expr.right):
                if isinstance(side, ast.Constant) and \
                        isinstance(side.value, str):
                    return "string concatenation"
                if isinstance(side, ast.JoinedStr):
                    return "string concatenation"
    if isinstance(expr, ast.IfExp):
        return _is_unbounded_expr(expr.body) or \
            _is_unbounded_expr(expr.orelse)
    return None


def _local_assignments(fn: ast.AST) -> Dict[str, ast.AST]:
    """Last ``name = <expr>`` value per simple local name in ``fn``."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _metric_receiver(call: ast.Call) -> Optional[str]:
    """Instrument attr name if this is a ``*._m_*.<inc|set|observe>()``."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _LABEL_METHODS and \
            isinstance(f.value, ast.Attribute) and \
            f.value.attr.startswith("_m_"):
        return f.value.attr
    return None


def _check_labels(fn: ast.AST, path: str, findings: List[Finding]) -> None:
    assigns = _local_assignments(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        instrument = _metric_receiver(node)
        if instrument is None:
            continue
        for kw in node.keywords:
            if kw.arg is None:
                continue
            expr = kw.value
            why = _is_unbounded_expr(expr)
            if why is None and isinstance(expr, ast.Name) and \
                    expr.id in assigns:
                why = _is_unbounded_expr(assigns[expr.id])
                if why:
                    why = f"{why} (via `{expr.id} = ...`)"
            if why:
                findings.append(Finding(
                    rule="telemetry-label", path=path, line=node.lineno,
                    message=f"label `{kw.arg}` of `{instrument}` built "
                            f"from {why} — unbounded cardinality",
                    hint="map dynamic values onto a small fixed vocabulary "
                         "before labelling (see the `other` path label); "
                         "each distinct value is a new fleet-wide series",
                ))


def _check_emits(tree: ast.AST, path: str, findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "emit"):
            continue
        if not node.args:
            continue
        kind_node = node.args[0]
        if not (isinstance(kind_node, ast.Constant) and
                isinstance(kind_node.value, str)):
            continue  # dynamic kind: schema'd at the producer
        kind = kind_node.value
        schema = EVENT_SCHEMAS.get(kind)
        if schema is None:
            findings.append(Finding(
                rule="telemetry-event-schema", path=path, line=node.lineno,
                message=f"emit of undocumented event kind `{kind}`",
                hint="document the kind in docs/observability.md (or "
                     "docs/adaptive.md) and add it to EVENT_SCHEMAS in "
                     "repro_torch/analysis/telemetry.py in the same change",
            ))
            continue
        for kw in node.keywords:
            if kw.arg is None:
                continue  # **payload — schema'd at the producer
            if kw.arg not in schema and kw.arg not in GLOBAL_EVENT_KEYS:
                findings.append(Finding(
                    rule="telemetry-event-schema", path=path,
                    line=node.lineno,
                    message=f"event `{kind}` carries undocumented key "
                            f"`{kw.arg}`",
                    hint=f"documented keys: {sorted(schema)}; update the "
                         "docs + EVENT_SCHEMAS if the schema is growing",
                ))


def run(paths: Sequence[Path], root: Path) -> List[Finding]:
    """Run the telemetry checker over ``paths``."""
    findings: List[Finding] = []
    for path in paths:
        try:
            tree, _ = parse_file(path)
        except SyntaxError:
            continue
        p = rel(path, root)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_labels(node, p, findings)
        _check_emits(tree, p, findings)
    return sorted(set(findings), key=lambda f: (f.path, f.line))
