"""Freeze-mask checker: a lane that has stopped stays frozen.

The port of ``repro.analysis.freeze_mask``, moved from ``lax.while_loop``
bodies to the port's loops. The lane-batched solvers (``solvers/cg.py``,
``ap.py``, ``sgd.py``) run B lanes through one host ``while`` loop that
goes on while any lane's own rule holds (``keep_going``), so a lane that
has converged, hit its budget or diverged rides along. What keeps its
iterates and counts a single solve's is the freeze mask: every
reassignment of a loop-carried tensor goes through ``keep(new, old)``
(``masked(active, lanes)``), ``freeze(active, new, old)`` or
``history_record(...)``, or advances by an ``active``-gated expression
(``t + active.to(torch.int32)``). An unguarded write lets a stopped lane
keep moving: its residuals drift, ``iters`` lies, and the lane no longer
matches its single solve.

Rule ``freeze-mask``, inside every ``while`` loop that calls
``keep_going`` or ``lane_active`` (a lane loop):

* an assignment or augmented assignment to a loop-carried name (bound
  before the loop, and rebound in it), or an in-place write into one
  (``x[i] = ...``, ``x.mul_(...)``), whose value is not one of the above;
* a draw from a generator (a name bound from a ``generator`` parameter, or
  from ``torch.Generator``): it advances every lane's stream, stopped
  lanes' too.

Exempt: plain host counters (a name whose bindings before the loop are
number literals: ``steps``, ``mvms``, ``syncs``), and the statements of an
``if lanes == 1:`` branch: with one lane the loop body runs only while
that lane is active, so its freeze is the identity (``base.masked``).
Intentional exceptions carry an inline suppression plus a baseline entry.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator, List, Sequence, Set

from repro_torch.analysis.common import (DEFS, Finding, call_name,
                                         own_nodes, parse_file, rel)

_MASK_WRAPPERS = {"keep", "freeze", "history_record"}
_LANE_RULES = {"keep_going", "lane_active"}
_GENERATOR_PARAMS = {"generator", "generators"}
_HINT = ("wrap in keep(new, old) / freeze(active, new, old) / "
         "history_record, or gate the update on `active`")


def _names(target: ast.AST) -> Iterator[str]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def _mentions(expr: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(expr))


def _value_ok(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call) and \
            call_name(expr).split(".")[-1] in _MASK_WRAPPERS:
        return True
    return _mentions(expr, {"active"})


def _is_lane_loop(loop: ast.While) -> bool:
    return any(isinstance(n, ast.Call) and
               call_name(n).split(".")[-1] in _LANE_RULES
               for n in own_nodes(loop))


def _single_lane_branch(test: ast.AST) -> bool:
    """``lanes == 1``: the branch a single lane takes."""
    return isinstance(test, ast.Compare) and \
        isinstance(test.left, ast.Name) and test.left.id == "lanes" and \
        len(test.ops) == 1 and isinstance(test.ops[0], ast.Eq) and \
        isinstance(test.comparators[0], ast.Constant) and \
        test.comparators[0].value == 1


def _bound_before(fn: ast.AST, loop: ast.While):
    """(names bound before ``loop`` in ``fn``, those bound only to number
    literals)."""
    bound: Set[str] = set()
    values = {}
    for node in own_nodes(fn):
        if getattr(node, "lineno", loop.lineno) >= loop.lineno:
            continue
        pairs = []
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple) and \
                        len(tgt.elts) == len(node.value.elts):
                    pairs.extend(zip(tgt.elts, node.value.elts))
                else:
                    pairs.append((tgt, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                node.value is not None:
            pairs.append((node.target, node.value))
        for tgt, value in pairs:
            for name in _names(tgt):
                if isinstance(tgt, (ast.Name, ast.Tuple)):
                    bound.add(name)
                    values.setdefault(name, []).append(value)
    counters = {name for name, vals in values.items()
                if all(isinstance(v, ast.Constant) and
                       isinstance(v.value, (int, float)) and
                       not isinstance(v.value, bool) for v in vals)}
    return bound, counters


def _generator_names(fn: ast.AST, loop: ast.While) -> Set[str]:
    """Names carrying a generator into the loop."""
    args = fn.args
    names = {a.arg for a in (list(args.posonlyargs) + list(args.args) +
                             list(args.kwonlyargs))
             if a.arg in _GENERATOR_PARAMS or
             (a.annotation is not None and
              "Generator" in ast.unparse(a.annotation))}
    for _ in range(2):
        for node in own_nodes(fn):
            if isinstance(node, ast.Assign) and node.lineno < loop.lineno:
                if _mentions(node.value, names) or any(
                        isinstance(n, ast.Call) and
                        call_name(n).endswith("Generator")
                        for n in ast.walk(node.value)):
                    for tgt in node.targets:
                        names.update(_names(tgt))
    return names


class _LoopScanner:
    """Checks the statements of one lane loop."""

    def __init__(self, fn_name: str, carried: Set[str], gens: Set[str],
                 path: str, findings: List[Finding]):
        self.fn_name, self.carried, self.gens = fn_name, carried, gens
        self.path, self.findings = path, findings

    def flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule="freeze-mask", path=self.path, line=node.lineno,
            message=f"{message} (in `{self.fn_name}`)", hint=_HINT))

    def statements(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.statement(stmt)

    def statement(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.If):
            if not _single_lane_branch(stmt.test):
                self.statements(stmt.body)
            self.statements(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While, ast.With,
                             ast.AsyncWith, ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                self.statements(getattr(stmt, field, []))
            for handler in getattr(stmt, "handlers", []):
                self.statements(handler.body)
            return
        if isinstance(stmt, DEFS):
            return
        self.draws(stmt)
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                self.assign(tgt, stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and \
                stmt.value is not None:
            self.assign(stmt.target, stmt.value)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            f = stmt.value.func
            if isinstance(f, ast.Attribute) and f.attr.endswith("_") and \
                    not f.attr.startswith("__") and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in self.carried and \
                    not _mentions(stmt.value, {"active"}):
                self.flag(stmt, f"in-place `{f.value.id}.{f.attr}()` on a "
                                "loop-carried tensor is not frozen for "
                                "stopped lanes")

    def assign(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple) \
                and len(target.elts) == len(value.elts):
            for t, v in zip(target.elts, value.elts):
                self.assign(t, v)
            return
        if _value_ok(value):
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name) and base.id in self.carried:
                self.flag(target, f"in-place write into loop-carried "
                                  f"`{base.id}` is not frozen for stopped "
                                  "lanes")
            return
        for name in _names(target):
            if name in self.carried:
                self.flag(target, f"loop-carried `{name}` is reassigned "
                                  "without the freeze mask")

    def draws(self, stmt: ast.stmt) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and self.gens and \
                    _mentions(node, self.gens) and \
                    not _mentions(node, {"active"}):
                self.flag(node, "a draw from the lanes' generators advances "
                                "stopped lanes' streams")
                return


def _check_function(fn: ast.AST, path: str,
                    findings: List[Finding]) -> None:
    for loop in own_nodes(fn):
        if not (isinstance(loop, ast.While) and _is_lane_loop(loop)):
            continue
        bound, counters = _bound_before(fn, loop)
        rebound: Set[str] = set()
        for node in own_nodes(loop):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    rebound.update(_names(tgt))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                rebound.update(_names(node.target))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name):
                rebound.add(node.func.value.id)  # in-place methods
        carried = (bound & rebound) - counters
        scanner = _LoopScanner(fn.name, carried,
                               _generator_names(fn, loop), path, findings)
        scanner.statements(loop.body)


def run(paths: Sequence[Path], root: Path) -> List[Finding]:
    """Run the freeze-mask checker over ``paths``; returns findings."""
    findings: List[Finding] = []
    for path in paths:
        try:
            tree, _ = parse_file(path)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(node, rel(path, root), findings)
    return sorted(set(findings), key=lambda f: (f.path, f.line))
