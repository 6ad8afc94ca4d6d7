"""Host-sync checker: every device read inside the port's loops is listed.

The reference's rule of this name guards code reachable from
``jax.jit`` / ``lax.while_loop`` / ``lax.scan``. The port runs eagerly: its
solver loops are Python ``while`` loops on the host, so there is no trace
to poison, and a tensor read inside a loop is legal. What it costs is a
device synchronisation per iteration: the host waits for the queue to
drain before it can issue the next launch (``PERF.md`` names these reads
as the port's top host cost). This checker makes the list of them.

Scope: the modules it is given (``solvers/``, ``core/``, ``gp/``,
``online/`` and ``lanes.py``). Inside the body of a Python ``while`` or
``for`` loop, a comprehension, or a ``while`` loop's own test (evaluated
every iteration), it flags

* ``trace-host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()`` and
  ``.numpy()``; ``torch.cuda.synchronize``; ``bool()``, ``float()`` or
  ``int()`` of a tensor expression; and a call, at its call site in the
  loop, to a function of the scanned modules whose body does one of these
  (one level of the call graph: same-module names and ``from
  repro_torch.x import f``, as the reference builds its graph);
* ``trace-python-branch`` — an ``if``/``while`` (or a conditional
  expression) whose test is a tensor expression (``is None`` checks,
  ``isinstance`` and ``len`` are exempt, as in the reference).

Tensor-ness is lexical, per function: parameters annotated ``Tensor``,
names bound from ``torch.*`` calls or from expressions over tensor names
(a tensor's methods, arithmetic), spread through assignment. A call to a
function of the scanned modules that declares its return type is typed by
that annotation instead (``-> tuple[torch.Tensor, bool]`` unpacks into a
tensor and a host value), and so is a field or property of a class of the
scanned modules (``res.res_y`` of a ``SolveResult``). Reads of ``.shape``,
``.ndim``, ``.dtype``, ``.device`` and ``.size()`` / ``.numel()`` /
``.dim()`` are host metadata, not syncs. A read that is
meant (the solvers' one stopping read per iteration) carries an inline
suppression and a baseline entry, so the baseline is the reviewed list
of the port's per-iteration host reads.

Dropped from the reference: ``trace-impure-call`` (wall-clock and entropy
reads are frozen at trace time under ``jit``; eager code reads them when
it runs, which is what it means) and the ``np.asarray`` rule (a host
array inside eager code is already on the host, and a tensor's
conversion is ``.cpu()``/``.numpy()``, flagged above).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import (DEFS, Finding, call_name,
                                         dotted, own_nodes, parse_file, rel)

_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"bool", "float", "int"}
_SYNC_CALLS = {"torch.cuda.synchronize"}
#: ``torch.<x>`` calls that return host values or objects, not tensors.
_TORCH_HOST = {"cuda", "device", "Size", "Generator", "get_num_threads",
               "set_num_threads", "is_tensor", "is_grad_enabled", "no_grad",
               "enable_grad", "finfo", "iinfo", "manual_seed", "backends",
               "distributed", "autograd", "profiler", "get_default_dtype",
               "is_floating_point", "dtype", "Stream", "Event"}
#: Attribute reads and methods that are host metadata of a tensor.
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad"}
_META_METHODS = {"size", "dim", "numel", "element_size", "stride",
                 "data_ptr", "is_contiguous", "get_device"}
_EXEMPT_CALLS = {"len", "isinstance", "hasattr"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


class _Fn:
    """A function definition plus where it lives and its typed names."""

    def __init__(self, node: ast.AST, path: Path, module: str):
        self.node = node
        self.path = path
        self.module = module
        self.types: Optional["_Types"] = None

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")


def _module_name(path: Path, root: Path) -> str:
    """Dotted module path of ``path`` relative to ``root`` (src-aware)."""
    r = rel(path, root)
    r = r[:-3] if r.endswith(".py") else r
    parts = [p for p in r.split("/") if p]
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _index_functions(tree: ast.AST, path: Path,
                     module: str) -> Dict[str, List[_Fn]]:
    """All (async) function defs in ``tree`` keyed by bare name."""
    out: Dict[str, List[_Fn]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(_Fn(node, path, module))
    return out


def _class_fields(tree: ast.AST) -> Dict[str, Dict[str, ast.AST]]:
    """Class name -> annotated fields and ``@property`` return types."""
    out: Dict[str, Dict[str, ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            fields = out.setdefault(node.name, {})
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    fields[stmt.target.id] = stmt.annotation
                elif isinstance(stmt, ast.FunctionDef) and \
                        stmt.returns is not None and \
                        any(dotted(d) == "property"
                            for d in stmt.decorator_list):
                    fields[stmt.name] = stmt.returns
    return out


def _import_map(tree: ast.AST) -> Dict[str, Tuple[str, str]]:
    """``from repro_torch.x import f [as g]`` -> ``{g: ("repro_torch.x",
    "f")}``."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (node.module, alias.name)
    return out


# ---------------------------------------------------------------------------
# lexical tensor-ness


def _mentions_tensor(annotation: Optional[ast.AST]) -> bool:
    if annotation is None:
        return False
    try:
        return "Tensor" in ast.unparse(annotation)
    except Exception:
        return False


def _tuple_items(annotation: ast.AST) -> Optional[List[ast.AST]]:
    """The item annotations of ``tuple[a, b]`` / ``Tuple[a, b]``."""
    if isinstance(annotation, ast.Subscript) and \
            dotted(annotation.value).split(".")[-1] in ("tuple", "Tuple") \
            and isinstance(annotation.slice, ast.Tuple):
        return list(annotation.slice.elts)
    return None


class _Types:
    """Tensor names and struct-typed names of one function, over the
    graph's return annotations and class fields."""

    def __init__(self, fn: _Fn, graph: "_Graph"):
        self.fn, self.graph = fn, graph
        self.tensors: Set[str] = set()
        self.structs: Dict[str, str] = {}  # name -> class of the modules

    def returns(self, expr: ast.AST) -> Optional[ast.AST]:
        """Return annotation of a bare call to a scanned function."""
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            for callee in self.graph.resolve(self.fn.module, expr.func.id):
                if callee.node.returns is not None:
                    return callee.node.returns
        return None

    def _class_of(self, annotation: Optional[ast.AST]) -> Optional[str]:
        name = dotted(annotation) if annotation is not None else ""
        name = name.split(".")[-1]
        return name if name in self.graph.classes else None

    def bind(self, target: ast.AST, annotation: ast.AST) -> None:
        """Type ``target`` by a declared annotation."""
        items = _tuple_items(annotation)
        if isinstance(target, ast.Tuple) and items is not None and \
                len(items) == len(target.elts):
            for t, a in zip(target.elts, items):
                self.bind(t, a)
        elif isinstance(target, ast.Name):
            cls = self._class_of(annotation)
            if cls is not None:
                self.structs[target.id] = cls
            elif _mentions_tensor(annotation):
                self.tensors.add(target.id)
        elif _mentions_tensor(annotation):
            self.tensors.update(_targets(target))

    def is_tensor(self, expr: ast.AST) -> bool:
        """True if ``expr`` is a tensor: a tensor name, a ``torch.*`` call,
        a tensor's method or attribute, a tensor field of a struct, a call
        declared to return one, or arithmetic, comparison or indexing over
        these. Host metadata (``x.shape``, ``x.size()``, ``len(x)``),
        identity checks and calls of other functions are not."""
        if isinstance(expr, ast.Name):
            return expr.id in self.tensors
        if isinstance(expr, ast.Attribute):
            if expr.attr in _META_ATTRS:
                return False
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id in self.structs:
                fields = self.graph.classes[self.structs[expr.value.id]]
                return _mentions_tensor(fields.get(expr.attr))
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute):
                if f.attr in _META_METHODS | _HOST_METHODS:
                    return False  # host metadata, or already a host value
                if _is_torch_tensor_call(expr):
                    return True
                return self.is_tensor(f.value)  # a tensor's method
            ann = self.returns(expr)
            return ann is not None and _mentions_tensor(ann)
        if isinstance(expr, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        if isinstance(expr, (ast.BinOp, ast.UnaryOp, ast.Compare, ast.BoolOp,
                             ast.IfExp, ast.Subscript, ast.Starred)):
            return any(self.is_tensor(child)
                       for child in ast.iter_child_nodes(expr)
                       if isinstance(child, ast.expr))
        return False


def _is_torch_tensor_call(node: ast.Call) -> bool:
    parts = call_name(node).split(".")
    return len(parts) > 1 and parts[0] == "torch" and \
        parts[1] not in _TORCH_HOST


def _targets(target: ast.AST) -> Iterator[str]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def _bind_value(types: _Types, target: ast.AST, value: ast.AST) -> None:
    """Type ``target = value``: element-wise for ``a, b = x, y``, by the
    callee's return annotation for a call to a scanned function."""
    if isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple) and \
            len(target.elts) == len(value.elts):
        for t, v in zip(target.elts, value.elts):
            _bind_value(types, t, v)
        return
    ann = types.returns(value)
    if ann is not None:
        types.bind(target, ann)
    elif types.is_tensor(value):
        types.tensors.update(_targets(target))


def _collect_types(fn: _Fn, graph: "_Graph") -> _Types:
    """Tensor and struct names inside ``fn``."""
    types = _Types(fn, graph)
    args = fn.node.args
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        if a.annotation is not None:
            types.bind(ast.Name(id=a.arg), a.annotation)
    # Two passes so a name bound below its first use still lands.
    for _ in range(2):
        for stmt in own_nodes(fn.node):
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    _bind_value(types, tgt, stmt.value)
            elif isinstance(stmt, ast.AnnAssign):
                types.bind(stmt.target, stmt.annotation)
            elif isinstance(stmt, ast.AugAssign) and \
                    types.is_tensor(stmt.value):
                types.tensors.update(_targets(stmt.target))
            elif isinstance(stmt, (ast.For, ast.AsyncFor)) and \
                    types.is_tensor(stmt.iter):
                types.tensors.update(_targets(stmt.target))
    return types


def _branch_exempt(test: ast.AST) -> bool:
    """Host structure checks: ``is None``, isinstance, hasattr, len."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _branch_exempt(test.operand)
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return True
    if isinstance(test, ast.Call) and call_name(test) in _EXEMPT_CALLS:
        return True
    if isinstance(test, ast.BoolOp):
        return all(_branch_exempt(v) for v in test.values)
    return False


# ---------------------------------------------------------------------------
# sync sites


def _sync_sites(nodes: Sequence[ast.AST],
                types: _Types) -> List[Tuple[str, ast.AST, str]]:
    """(rule, node, what) for every direct host read among ``nodes``."""
    sites: List[Tuple[str, ast.AST, str]] = []
    for node in nodes:
        if isinstance(node, ast.Call):
            name = call_name(node)
            f = node.func
            if name in _SYNC_CALLS:
                sites.append(("trace-host-sync", node, f"`{name}()`"))
            elif name in _HOST_CASTS and node.args and \
                    types.is_tensor(node.args[0]):
                sites.append(("trace-host-sync", node,
                              f"`{name}()` of a tensor"))
            elif isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
                sites.append(("trace-host-sync", node, f"`.{f.attr}()`"))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if not _branch_exempt(node.test) and \
                    types.is_tensor(node.test):
                kind = {ast.If: "if", ast.While: "while"}.get(
                    type(node), "conditional expression")
                sites.append(("trace-python-branch", node,
                              f"Python `{kind}` on a tensor"))
    return sites


def _loop_nodes(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn_node`` that run once per iteration of a loop: loop
    bodies (``else`` excluded), a ``while`` test, comprehension elements and
    conditions; nested defs excluded. Each node is yielded once."""
    seen: Set[int] = set()

    def emit(nodes: Iterator[ast.AST]) -> Iterator[ast.AST]:
        for n in nodes:
            if id(n) not in seen:
                seen.add(id(n))
                yield n

    def subtree(n: ast.AST) -> Iterator[ast.AST]:
        yield n
        if not isinstance(n, DEFS):
            yield from own_nodes(n)

    for node in own_nodes(fn_node):
        if isinstance(node, _LOOPS):
            parts = list(node.body)
            if isinstance(node, ast.While):
                parts.append(node.test)
            for part in parts:
                yield from emit(subtree(part))
        elif isinstance(node, _COMPS):
            elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            for gen in node.generators:
                elts.extend(gen.ifs)
            for part in elts:
                yield from emit(subtree(part))


class _Graph:
    """Functions of the scanned modules, for one level of call edges."""

    def __init__(self) -> None:
        self.functions: Dict[str, Dict[str, List[_Fn]]] = {}
        self.imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: class of the scanned modules -> field / property -> annotation
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        self.syncing: Dict[int, Tuple[str, int]] = {}  # fn -> (what, line)

    def resolve(self, module: str, name: str) -> List[_Fn]:
        """Function defs a bare call name refers to, following imports."""
        fns = self.functions.get(module, {}).get(name)
        if fns:
            return fns
        imp = self.imports.get(module, {}).get(name)
        if imp and imp[0] in self.functions:
            return self.functions[imp[0]].get(imp[1], [])
        return []

    def host_read(self, module: str, name: str) -> Optional[Tuple[str, Path,
                                                                   int]]:
        """(what, path, line) of the first host read in the body of the
        function ``name`` resolves to, if it makes one."""
        for fn in self.resolve(module, name):
            hit = self.syncing.get(id(fn.node))
            if hit is not None:
                return hit[0], fn.path, hit[1]
        return None


def _scan_function(fn: _Fn, graph: _Graph, root: Path) -> List[Finding]:
    path = rel(fn.path, root)
    findings: List[Finding] = []
    loop_nodes = list(_loop_nodes(fn.node))
    for rule, node, what in _sync_sites(loop_nodes, fn.types):
        if rule == "trace-host-sync":
            hint = ("read it once after the loop, or every k iterations; "
                    "inside, keep the value a tensor (torch.where, masks)")
        else:
            hint = ("branch on a host value, or keep both arms as tensor "
                    "ops (torch.where) so the loop issues without a read")
        findings.append(Finding(
            rule=rule, path=path, line=node.lineno,
            message=f"{what} inside a loop reads the device every "
                    f"iteration (in `{fn.name}`)", hint=hint))
    for node in loop_nodes:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            hit = graph.host_read(fn.module, node.func.id)
            if hit is not None:
                what, callee_path, line = hit
                findings.append(Finding(
                    rule="trace-host-sync", path=path, line=node.lineno,
                    message=f"call to `{node.func.id}` inside a loop reads "
                            f"the device every iteration ({what} at "
                            f"{rel(callee_path, root)}:{line}; in "
                            f"`{fn.name}`)",
                    hint="hoist the read out of the loop, or read every k "
                         "iterations; the callee's read is the sync"))
    return findings


def run(paths: Sequence[Path], root: Path) -> List[Finding]:
    """Run the host-sync checker over ``paths``; returns findings."""
    graph = _Graph()
    fns: List[_Fn] = []
    for path in paths:
        try:
            tree, _ = parse_file(path)
        except SyntaxError:
            continue
        module = _module_name(path, root)
        graph.functions[module] = _index_functions(tree, path, module)
        graph.imports[module] = _import_map(tree)
        graph.classes.update(_class_fields(tree))
        for group in graph.functions[module].values():
            fns.extend(group)
    for fn in fns:
        fn.types = _collect_types(fn, graph)
        sites = _sync_sites(list(own_nodes(fn.node)), fn.types)
        if sites:
            _, node, what = min(sites, key=lambda s: s[1].lineno)
            graph.syncing[id(fn.node)] = (what, node.lineno)
    findings: List[Finding] = []
    for fn in fns:
        findings.extend(_scan_function(fn, graph, root))
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
