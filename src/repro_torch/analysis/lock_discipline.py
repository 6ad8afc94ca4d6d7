"""Lock-discipline checker: annotated shared state stays behind its lock.

The port's own copy of ``repro.analysis.lock_discipline``, over
``src/repro_torch``.

The serve/obs planes are stdlib-threaded (engine worker, admission,
artifact poller, fleet scraper/monitor, event log). Their shared mutable
attributes are declared with a guard annotation on the attribute's
defining line (``self.x = ...`` in ``__init__``, or a dataclass field)::

    self._replicas = {}          #: guarded by self._lock
    self.scrape_rounds = 0       #: guarded by self._lock

(the comment may also sit on its own line directly above). From those
declarations the checker enforces, per class:

* ``lock-discipline`` — any read or write of a guarded attribute outside
  a lexical ``with self.<lock>`` block (``__init__`` and ``*_locked``
  methods are exempt: construction is single-threaded, and the
  ``_locked`` suffix is this repo's caller-holds-the-lock convention);
* a call to a ``self.*_locked(...)`` helper from outside any ``with
  self.<lock>`` block (the suffix is a contract: the caller must already
  hold the lock);
* any same-file access to a guarded attribute from *outside* the owning
  class (e.g. a handler reaching into ``self.monitor.ticks``): external
  readers must go through a locked accessor method.

The analysis is lexical, not interprocedural — it will not see a lock
held across a method call — which is exactly the granularity the
annotated classes are written to: every public method takes the lock
itself or delegates to a ``*_locked`` helper.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, parse_file, rel

_GUARD_RE = re.compile(r"#:\s*guarded by\s+self\.(\w+)")


def _guard_comments(source: str) -> Dict[int, Tuple[str, bool]]:
    """Line -> (lock name, comment-only?) for every guard annotation.

    A trailing annotation applies to its own line only; a comment-only
    line applies to the statement directly below it.
    """
    out: Dict[int, Tuple[str, bool]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _GUARD_RE.search(text)
        if m:
            out[i] = (m.group(1), text.lstrip().startswith("#"))
    return out


def _guarded_attrs(cls: ast.ClassDef,
                   comments: Dict[int, Tuple[str, bool]]) -> Dict[str, str]:
    """Attr name -> lock name for one class, from annotated declarations."""
    guarded: Dict[str, str] = {}

    def lock_for(line: int) -> Optional[str]:
        same = comments.get(line)
        if same is not None:
            return same[0]
        above = comments.get(line - 1)
        if above is not None and above[1]:  # comment-only line above
            return above[0]
        return None

    for stmt in cls.body:  # dataclass-style class-level fields
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            lock = lock_for(stmt.lineno)
            if lock:
                guarded[stmt.target.id] = lock
    for node in ast.walk(cls):  # self.x = ... in __init__ (or anywhere)
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    lock = lock_for(node.lineno)
                    if lock:
                        guarded[tgt.attr] = lock
    return guarded


def _exempt(name: str) -> bool:
    return name == "__init__" or name.endswith("_locked")


class _MethodScanner(ast.NodeVisitor):
    """Walk one method body tracking lexically held ``self.*`` locks."""

    def __init__(self, guarded: Dict[str, str], path: str, cls: str,
                 method: str, findings: List[Finding]):
        self.guarded = guarded
        self.path = path
        self.cls = cls
        self.method = method
        self.findings = findings
        self.held: Set[str] = set()

    def _flag(self, node: ast.AST, attr: str, lock: str) -> None:
        self.findings.append(Finding(
            rule="lock-discipline", path=self.path, line=node.lineno,
            message=f"`self.{attr}` accessed outside `with self.{lock}` "
                    f"(in `{self.cls}.{self.method}`)",
            hint=f"take `with self.{lock}:` around the access, or move it "
                 f"into a `*_locked` helper called under the lock",
        ))

    def visit_With(self, node: ast.With) -> None:
        added: Set[str] = set()
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Attribute) and \
                    isinstance(ctx.value, ast.Name) and ctx.value.id == "self":
                if ctx.attr not in self.held:
                    added.add(ctx.attr)
        self.held |= added
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self" and \
                node.attr in self.guarded:
            lock = self.guarded[node.attr]
            if lock not in self.held:
                self._flag(node, node.attr, lock)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and f.attr.endswith("_locked") \
                and not self.held:
            self.findings.append(Finding(
                rule="lock-discipline", path=self.path, line=node.lineno,
                message=f"`self.{f.attr}()` called without holding a lock "
                        f"(in `{self.cls}.{self.method}`); the `_locked` "
                        "suffix means the caller must hold it",
                hint="call it inside `with self.<lock>:`, or rename the "
                     "helper if it actually takes the lock itself",
            ))
        self.generic_visit(node)

    # Nested defs inherit the enclosing lock scope only if the closure is
    # called inline — too dynamic to track; treat them as lock-free.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved, self.held = self.held, set()
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef


def _check_class(cls: ast.ClassDef, guarded: Dict[str, str], path: str,
                 findings: List[Finding]) -> None:
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not _exempt(stmt.name):
            scanner = _MethodScanner(guarded, path, cls.name, stmt.name,
                                     findings)
            for inner in stmt.body:
                scanner.visit(inner)


def _check_foreign_access(tree: ast.AST, owners: Dict[str, Tuple[str, str]],
                          path: str, findings: List[Finding]) -> None:
    """Flag same-file access to a guarded attr from outside its class."""

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.cls_stack: List[str] = []

        def visit_ClassDef(self, node: ast.ClassDef) -> None:
            self.cls_stack.append(node.name)
            self.generic_visit(node)
            self.cls_stack.pop()

        def visit_Attribute(self, node: ast.Attribute) -> None:
            info = owners.get(node.attr)
            if info is not None:
                owner_cls, lock = info
                in_owner = bool(self.cls_stack) and \
                    self.cls_stack[-1] == owner_cls
                is_self = isinstance(node.value, ast.Name) and \
                    node.value.id == "self"
                if not (in_owner and is_self) and not is_self:
                    findings.append(Finding(
                        rule="lock-discipline", path=path, line=node.lineno,
                        message=f"guarded `{owner_cls}.{node.attr}` read "
                                "from outside its class without "
                                f"`{owner_cls}`'s `{lock}`",
                        hint=f"add a locked accessor on `{owner_cls}` and "
                             "call that instead of reaching into the "
                             "attribute",
                    ))
            self.generic_visit(node)

    V().visit(tree)


def run(paths: Sequence[Path], root: Path) -> List[Finding]:
    """Run the lock-discipline checker over ``paths``."""
    findings: List[Finding] = []
    for path in paths:
        try:
            tree, source = parse_file(path)
        except SyntaxError:
            continue
        comments = _guard_comments(source)
        if not comments:
            continue
        p = rel(path, root)
        owners: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                guarded = _guarded_attrs(node, comments)
                if guarded:
                    for attr, lock in guarded.items():
                        owners[attr] = (node.name, lock)
                    _check_class(node, guarded, p, findings)
        if owners:
            _check_foreign_access(tree, owners, p, findings)
    return sorted(set(findings), key=lambda f: (f.path, f.line))
