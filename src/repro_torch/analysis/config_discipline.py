"""Static/numeric config discipline checker.

The port's own copy of ``repro.analysis.config_discipline``. Solver
configuration splits in two, as in the reference: ``SolverConfig``
(``solvers/base.py``) is a frozen, hashable dataclass that fixes the
program (solver, shapes, flags) and keys ``launch.batch``'s groups (one
``fit_batch`` per static group, via ``strip_numerics``), while
``SolverNumerics`` holds the values a solve merely reads (tolerance,
epoch budget, learning rate, ...) as fp32 tensors, scalar or one per lane.
The split only works if the two never mix:

* ``config-static-traced`` — a ``SolverNumerics`` value (or one of its
  fields) must never flow into a hashable static position: a dict key, a
  set element, an argument to ``hash()``, or a parameter of a
  ``functools.lru_cache`` / ``functools.cache`` function (the port's
  static cache key, where the reference names ``static_argnames`` of a
  jit). A tensor hashes by identity, so such a key never hits for an equal
  value and grows one entry per tensor object, and grouping by it splits
  lanes that should share one solve.
* ``config-static-array`` — a frozen (hashable) config dataclass must not
  declare tensor- or array-valued fields (``torch.Tensor``,
  ``np.ndarray``): they don't hash by value, so such a config poisons
  every cache and group keyed on it.

Numerics-typed names are recognised from annotations
(``x: SolverNumerics``, ``Optional[SolverNumerics]``) and from
assignments off the canonical constructors (``numerics_of``,
``stack_numerics``, ``broadcast_numerics``, ``lane_numerics``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Sequence, Set

from repro_torch.analysis.common import (Finding, call_name, dotted,
                                         parse_file, rel)

_NUMERICS_TYPE = "SolverNumerics"
_NUMERICS_CTORS = {"numerics_of", "stack_numerics", "broadcast_numerics",
                   "lane_numerics"}
_ARRAY_TYPES = ("torch.Tensor", "Tensor", "np.ndarray", "numpy.ndarray",
                "ndarray", "ArrayLike")
_CACHE_DECORATORS = {"lru_cache", "functools.lru_cache", "cache",
                     "functools.cache"}


def _annotation_mentions(node: ast.AST, needle: str) -> bool:
    try:
        text = ast.unparse(node)
    except Exception:
        return False
    return needle in text


def _numerics_params(fn: ast.AST) -> List[ast.arg]:
    args = fn.args
    return [a for a in (list(args.posonlyargs) + list(args.args) +
                        list(args.kwonlyargs))
            if a.annotation is not None and
            _annotation_mentions(a.annotation, _NUMERICS_TYPE)]


def _numerics_names(fn: ast.AST) -> Set[str]:
    """Names bound to SolverNumerics values inside ``fn``."""
    names: Set[str] = set()
    if getattr(fn, "args", None) is not None:
        names.update(a.arg for a in _numerics_params(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                _annotation_mentions(node.annotation, _NUMERICS_TYPE):
            names.add(node.target.id)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = call_name(node.value).split(".")[-1]
            if ctor in _NUMERICS_CTORS or ctor == _NUMERICS_TYPE:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
    return names


def _refers_to_numerics(expr: ast.AST, names: Set[str]) -> bool:
    """``expr`` is a numerics name or an attribute chain rooted at one."""
    node = expr
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in names


def _check_function(fn: ast.AST, path: str,
                    findings: List[Finding]) -> None:
    names = _numerics_names(fn)
    if not names:
        return

    def flag(node: ast.AST, what: str) -> None:
        findings.append(Finding(
            rule="config-static-traced", path=path, line=node.lineno,
            message=f"SolverNumerics value flows into {what}",
            hint="numerics are per-lane tensors; key caches and groups on "
                 "the static SolverConfig instead (strip_numerics)",
        ))

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for node in ast.walk(ast.Module(body=body, type_ignores=[])):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            continue  # nested defs get their own pass
        if isinstance(node, ast.Dict):
            for key in node.keys:
                if key is not None and _refers_to_numerics(key, names):
                    flag(key, "a dict key (hashable static position)")
        elif isinstance(node, ast.Set):
            for elt in node.elts:
                if _refers_to_numerics(elt, names):
                    flag(elt, "a set element (hashable static position)")
        elif isinstance(node, ast.Call):
            if call_name(node) == "hash" and node.args and \
                    _refers_to_numerics(node.args[0], names):
                flag(node, "hash() (static cache key)")


def _is_cache_decorator(expr: ast.AST) -> bool:
    """``lru_cache`` / ``functools.cache``, bare or called with options."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    return dotted(expr) in _CACHE_DECORATORS


def _cached_numerics_params(tree: ast.AST, path: str,
                            findings: List[Finding]) -> None:
    """Flag SolverNumerics-annotated params of cache-keyed functions."""

    def flag(arg: ast.arg, fn_name: str) -> None:
        findings.append(Finding(
            rule="config-static-traced", path=path, line=arg.lineno,
            message=f"cache decorator hashes SolverNumerics param "
                    f"`{arg.arg}` of `{fn_name}` into its key",
            hint="cache keys hash tensors by identity; key the cache on "
                 "the static SolverConfig and pass numerics alongside",
        ))

    defs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
            if any(_is_cache_decorator(d) for d in node.decorator_list):
                for a in _numerics_params(node):
                    flag(a, node.name)
    for node in ast.walk(tree):  # lru_cache(...)(f) wrappers
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Call) and \
                _is_cache_decorator(node.func):
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in defs:
                    for a in _numerics_params(defs[arg.id]):
                        flag(a, arg.id)


def _frozen_dataclass_arrays(tree: ast.AST, path: str,
                             findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        frozen = False
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and \
                    call_name(dec).split(".")[-1] == "dataclass":
                for kw in dec.keywords:
                    if kw.arg == "frozen" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is True:
                        frozen = True
        if not frozen:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                try:
                    text = ast.unparse(stmt.annotation)
                except Exception:
                    continue
                if any(t in text for t in _ARRAY_TYPES):
                    findings.append(Finding(
                        rule="config-static-array", path=path,
                        line=stmt.lineno,
                        message=f"frozen config `{node.name}` declares "
                                f"array-valued field `{stmt.target.id}`",
                        hint="static configs key caches and groups and must "
                             "hash by value; carry tensors in SolverNumerics "
                             "(or another non-hashed argument) instead",
                    ))


def run(paths: Sequence[Path], root: Path) -> List[Finding]:
    """Run the config-discipline checker over ``paths``."""
    findings: List[Finding] = []
    for path in paths:
        try:
            tree, _ = parse_file(path)
        except SyntaxError:
            continue
        p = rel(path, root)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(node, p, findings)
        _cached_numerics_params(tree, p, findings)
        _frozen_dataclass_arrays(tree, p, findings)
    # Nested defs are visited by both their own pass and the enclosing
    # function's walk — dedupe identical findings.
    return sorted(set(findings), key=lambda f: (f.path, f.line))
