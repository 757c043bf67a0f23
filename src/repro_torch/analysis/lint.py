"""The port's static checker: the engine of ``repro.analysis.lint`` (an
AST pass, stdlib ``ast`` alone), read for what the port compiles. The
reference builds the set of functions *traced by JAX* (passed to
``lax.scan``/``jit``/``vmap``/``cond``/``while_loop``, and what they reach
through local calls); the port compiles nothing but CUDA graphs, so here the
same set is the code *captured by a CUDA graph*:

* the body of ``with torch.cuda.graph(...)``;
* the statements between ``g.capture_begin(...)`` and ``g.capture_end()``;
* functions passed to ``torch.cuda.make_graphed_callables``;
* everything those reach through local calls (the module's call graph).

Captured Python runs ONCE, at capture: a replay repeats the kernels it
launched and nothing else. A per-function taint says which names hold
tensors: every parameter of a captured function (``self`` aside), the
tensors a captured block reads from its function, and what is computed from
them or returned by a ``torch.*`` call. Taint follows tensors, not shapes:
``.shape``, ``.size()``, ``.dim()``, ``len()``, ``isinstance()`` and an
identity test (``x is None``) read none of a tensor's values. The rules
(:mod:`repro_torch.analysis.rules`):

* **R1 capture-purity** — no host RNG, wall clock or I/O reachable from a
  captured body (one value at capture, repeated by every replay).
* **R2 host-sync** — no ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()``/``int()``/``bool()`` or ``numpy.asarray`` on a
  tensor, and no ``if``/``while`` on a tensor's value, in a captured body.
* **R3 controller-purity** and **R6 fault-injector-purity** — the
  reference's rules, copied (they know no framework).
* **R4 recapture-hazard** — no capture inside a loop, no capture keyed by a
  value that changes from call to call, no ``torch.compile(f)(x)`` on the
  spot.
* **R5 in-place-state** — state a captured body carries is written into its
  buffers, not rebound.

Grandfathering: ``baseline.json`` (next to this file) pins the accepted
findings by line-independent fingerprint with a one-line justification
each; ``--ci`` fails only on findings NOT in the baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Iterable, Optional

#: rule id -> one-line description
RULES = {
    "R1": "capture-purity: no host RNG / wall-clock / IO reachable from captured code",
    "R2": "host-sync: no host read of, or branch on, a tensor in captured code",
    "R3": "controller-purity: controllers decide, engines act",
    "R4": "recapture-hazard: captures are made once, outside loops, under stable keys",
    "R5": "in-place-state: captured state is written into its buffers, not rebound",
    "R6": "fault-injector-purity: fault schedules draw only injected seeded RNG",
}

#: the port's package and its card smoke script, relative to the repo root
DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py")


# ---------------------------------------------------------------------------
# Findings + baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``fingerprint`` deliberately excludes the line number, so a baseline
    entry survives unrelated edits to the same file; ``symbol`` (the
    enclosing function/class qualname) plus the machine-stable ``detail``
    keeps it specific enough not to mask new violations of the same rule
    elsewhere in the function — unless they have the identical detail,
    which is the granularity we accept for grandfathering."""

    rule: str
    path: str      # repo-relative posix path
    line: int
    symbol: str    # enclosing qualname ("" = module level)
    detail: str    # machine-stable short form, e.g. "numpy.random.normal"
    message: str   # human explanation

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


@dataclasses.dataclass
class Baseline:
    """Grandfathered findings: fingerprint -> justification."""

    entries: dict[str, str]
    path: Optional[str] = None

    @staticmethod
    def load(path: str) -> "Baseline":
        try:
            with open(path) as fh:
                data = json.load(fh)
        except OSError:
            return Baseline({}, path=path)
        entries = {
            e["fingerprint"]: e.get("justification", "")
            for e in data.get("findings", [])
        }
        return Baseline(entries, path=path)

    def save(self, path: str) -> None:
        data = {
            "schema": 1,
            "comment": (
                "Grandfathered repro_torch.analysis findings. Every entry "
                "needs a one-line justification; new code must not add "
                "entries (python -m repro_torch.analysis --ci fails on "
                "non-baseline findings)."),
            "findings": [
                {"fingerprint": fp, "justification": j}
                for fp, j in sorted(self.entries.items())
            ],
        }
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
            fh.write("\n")

    def split(self, findings: list[Finding]):
        """(new, grandfathered, stale-fingerprints)."""
        seen = {f.fingerprint for f in findings}
        new = [f for f in findings if f.fingerprint not in self.entries]
        old = [f for f in findings if f.fingerprint in self.entries]
        stale = sorted(fp for fp in self.entries if fp not in seen)
        return new, old, stale


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


# ---------------------------------------------------------------------------
# Module model
# ---------------------------------------------------------------------------

#: canonical names of a capture context (``with torch.cuda.graph(...)``)
CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
#: canonical names of the callables whose function arguments are captured
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables",
                     "torch.cuda.graphs.make_graphed_callables"}
#: attribute reads that yield no tensor value
_TAINT_BREAKER_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                        "requires_grad"}
#: method calls that yield no tensor value
_TAINT_BREAKER_METHODS = {"size", "dim", "numel", "stride", "element_size",
                          "is_contiguous", "data_ptr"}
#: calls whose result is no tensor value even on tensor arguments
_TAINT_BREAKER_CALLS = {"len", "isinstance", "type", "id", "hasattr", "callable"}
#: parameters that hold no tensor
_UNTAINTED_PARAMS = {"self", "cls"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    qualname: str
    node: ast.AST                    # FunctionDef / Lambda / a captured region's node
    params: list[str]
    class_name: Optional[str]        # enclosing class, if a method
    parent: Optional[str]            # enclosing function qualname, if nested
    # call edges: (callee expression, Call node) for Name / self.X calls
    calls: list[tuple[str, ast.Call]] = dataclasses.field(default_factory=list)
    # set by the capture pass: which params hold tensors
    tensor_params: set[str] = dataclasses.field(default_factory=set)
    capture_reason: Optional[str] = None


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    bases: list[str]                 # dotted base names as written
    methods: dict[str, str]          # method name -> qualname


class _StatementVisitor(ast.NodeVisitor):
    """Walks one function body without descending into nested defs."""

    def __init__(self, root: ast.AST, on_node) -> None:
        self._root = root
        self._on_node = on_node

    def generic_visit(self, node: ast.AST) -> None:
        if node is not self._root and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # nested function: its own FunctionInfo covers it
        self._on_node(node)
        super().generic_visit(node)


def walk_body(func_node: ast.AST) -> Iterable[ast.AST]:
    """Every AST node lexically inside ``func_node``'s body, excluding
    nested function/lambda bodies (they are separate FunctionInfos)."""
    out: list[ast.AST] = []
    _StatementVisitor(func_node, out.append).visit(func_node)
    return out


def _calls_in(node: ast.AST) -> list[tuple[str, ast.Call]]:
    out = []
    for sub in walk_body(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if name:
                out.append((name, sub))
    return out


def _is_method_call(stmt: ast.AST, method: str) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == method)


@dataclasses.dataclass
class Region:
    """One captured block: its node (a ``With``, or a ``Module`` holding the
    statements between ``capture_begin`` and ``capture_end``) and the
    function it lies in."""
    node: ast.AST
    function: Optional[FunctionInfo]
    kind: str                        # "graph" or "capture_begin"


class ModuleModel:
    """Everything the rules need about one module, computed once."""

    def __init__(self, path: str, rel_path: str, source: str) -> None:
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.imports: dict[str, str] = {}      # local alias -> canonical module
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.module_mutables: dict[str, int] = {}  # name -> lineno
        self.parents: dict[ast.AST, ast.AST] = {}
        self._collect()
        self.regions: list[Region] = []
        self.captured: dict[str, FunctionInfo] = {}
        self._find_captured()

    # -- canonicalization ------------------------------------------------
    def canonical(self, dotted: Optional[str]) -> Optional[str]:
        """Resolve the leading segment through the import table:
        ``np.random.normal`` -> ``numpy.random.normal``."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        base = self.imports.get(head)
        if base is None:
            return dotted
        return f"{base}.{rest}" if rest else base

    # -- collection ------------------------------------------------------
    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.imports[a.asname or a.name] = f"{node.module}.{a.name}"
        self._collect_scope(self.tree.body, prefix="", class_name=None,
                            parent=None)

    def _collect_scope(self, body, *, prefix: str, class_name, parent) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                self._add_function(node, qual, class_name, parent)
                self._collect_scope(node.body, prefix=f"{qual}.",
                                    class_name=None, parent=qual)
            elif isinstance(node, ast.ClassDef):
                qual = f"{prefix}{node.name}"
                bases = [dotted_name(b) or "" for b in node.bases]
                ci = ClassInfo(name=qual, node=node, bases=bases, methods={})
                self.classes[qual] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        mq = f"{qual}.{sub.name}"
                        ci.methods[sub.name] = mq
                        self._add_function(sub, mq, qual, parent)
                        self._collect_scope(sub.body, prefix=f"{mq}.",
                                            class_name=None, parent=mq)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and prefix == "" and class_name is None:
                value = node.value
                if isinstance(value, (ast.List, ast.Dict, ast.Set)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.module_mutables[t.id] = node.lineno

    def _add_function(self, node, qual: str, class_name, parent) -> None:
        args = node.args
        params = [a.arg for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs))]
        if args.vararg:
            params.append(args.vararg.arg)
        if args.kwarg:
            params.append(args.kwarg.arg)
        self.functions[qual] = FunctionInfo(
            qualname=qual, node=node, params=params, class_name=class_name,
            parent=parent, calls=_calls_in(node))

    def _lambda_info(self, node: ast.Lambda) -> FunctionInfo:
        qual = f"<lambda:{node.lineno}:{node.col_offset}>"
        if qual not in self.functions:
            params = [a.arg for a in (
                list(node.args.posonlyargs) + list(node.args.args)
                + list(node.args.kwonlyargs))]
            self.functions[qual] = FunctionInfo(
                qualname=qual, node=node, params=params, class_name=None,
                parent=None, calls=_calls_in(node))
        return self.functions[qual]

    # -- call resolution -------------------------------------------------
    def resolve_call(self, caller: FunctionInfo, name: str) -> Optional[FunctionInfo]:
        """Resolve a called name to a locally defined function: nested
        defs of the caller first, then same-class ``self.X`` methods,
        then module-level functions."""
        if name.startswith("self.") and caller.class_name:
            meth = name[len("self."):]
            ci = self.classes.get(caller.class_name)
            if ci and "." not in meth and meth in ci.methods:
                return self.functions.get(ci.methods[meth])
            return None
        if "." in name:
            return None  # external / attribute call — not a local edge
        nested = self.functions.get(f"{caller.qualname}.{name}")
        if nested is not None:
            return nested
        # enclosing scopes, innermost first
        parent = caller.parent
        while parent:
            cand = self.functions.get(f"{parent}.{name}")
            if cand is not None:
                return cand
            parent = self.functions[parent].parent \
                if parent in self.functions else None
        return self.functions.get(name)

    def enclosing_function(self, node: ast.AST) -> Optional[FunctionInfo]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for fi in self.functions.values():
                    if fi.node is cur:
                        return fi
            cur = self.parents.get(cur)
        return None

    # -- captured-code discovery -----------------------------------------
    def _find_regions(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    fn = ctx.func if isinstance(ctx, ast.Call) else ctx
                    if self.canonical(dotted_name(fn)) in CAPTURE_CONTEXTS:
                        self.regions.append(
                            Region(node, self.enclosing_function(node), "graph"))
                        break
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if not isinstance(stmts, list):
                    continue
                begin = None
                for i, stmt in enumerate(stmts):
                    if _is_method_call(stmt, "capture_begin"):
                        begin = i
                    elif _is_method_call(stmt, "capture_end") and begin is not None:
                        block = ast.Module(body=stmts[begin + 1:i], type_ignores=[])
                        self.regions.append(Region(block, self.enclosing_function(stmt),
                                                   "capture_begin"))
                        begin = None

    def _region_info(self, region: Region, index: int) -> FunctionInfo:
        """A captured block as a function of the names it reads from its
        enclosing function (its tensors, ``self`` aside)."""
        outer = region.function
        prefix = outer.qualname if outer else ""
        qual = f"{prefix}.<captured>" if prefix else "<captured>"
        if index:
            qual += f"#{index}"
        reads = {n.id for n in walk_body(region.node)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
        first = min(n.lineno for n in walk_body(region.node) if hasattr(n, "lineno"))
        scope = set(outer.params) | _assigned_names(outer.node, first) if outer else set()
        fi = FunctionInfo(
            qualname=qual, node=region.node, params=sorted(reads & scope),
            class_name=outer.class_name if outer else None,
            parent=outer.qualname if outer else None, calls=_calls_in(region.node))
        self.functions[qual] = fi
        return fi

    def _mark(self, fi: FunctionInfo, reason: str) -> None:
        if fi.qualname not in self.captured:
            fi.capture_reason = reason
            fi.tensor_params.update(p for p in fi.params if p not in _UNTAINTED_PARAMS)
            self.captured[fi.qualname] = fi

    def _find_captured(self) -> None:
        self._find_regions()
        per_function: dict[Optional[str], int] = {}
        for region in self.regions:
            key = region.function.qualname if region.function else None
            index = per_function.get(key, 0)
            per_function[key] = index + 1
            how = ("with torch.cuda.graph" if region.kind == "graph"
                   else "capture_begin/capture_end")
            self._mark(self._region_info(region, index),
                       f"captured by {how} at line {region.node.body[0].lineno}"
                       if region.node.body else f"captured by {how}")
        # make_graphed_callables(f or (f, g), ...)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if self.canonical(dotted_name(node.func)) not in GRAPHED_CALLABLES:
                continue
            caller = self.enclosing_function(node)
            arg = node.args[0]
            for target in (arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]):
                fi = None
                if isinstance(target, ast.Lambda):
                    fi = self._lambda_info(target)
                else:
                    name = dotted_name(target)
                    if name is not None:
                        fi = (self.resolve_call(caller, name) if caller else None) \
                            or self.functions.get(name)
                if fi is not None:
                    self._mark(fi, f"passed to make_graphed_callables at line {node.lineno}")
        # propagate: what a captured function calls locally is captured, and
        # the tensors it passes are its callee's
        frontier = list(self.captured.values())
        while frontier:
            fi = frontier.pop()
            tainted = self.tainted_names(fi)
            for name, call in fi.calls:
                callee = self.resolve_call(fi, name)
                if callee is None:
                    continue
                changed = False
                if callee.qualname not in self.captured:
                    callee.capture_reason = f"called from captured {fi.qualname}"
                    self.captured[callee.qualname] = callee
                    changed = True
                pos = [p for p in callee.params if p not in _UNTAINTED_PARAMS]
                for i, a in enumerate(call.args):
                    if i < len(pos) and taint_mentions(a, tainted) \
                            and pos[i] not in callee.tensor_params:
                        callee.tensor_params.add(pos[i])
                        changed = True
                for kw in call.keywords:
                    if kw.arg in callee.params and kw.arg not in _UNTAINTED_PARAMS \
                            and taint_mentions(kw.value, tainted) \
                            and kw.arg not in callee.tensor_params:
                        callee.tensor_params.add(kw.arg)
                        changed = True
                if changed:
                    frontier.append(callee)

    # -- taint within one function ---------------------------------------
    def tainted_names(self, fi: FunctionInfo) -> set[str]:
        """Names in ``fi`` holding tensors: its tensor params, the results of
        ``torch.*`` calls, and anything assigned from an expression that
        mentions a tainted name (two passes over the body handle
        use-before-redef chains)."""
        tainted = set(fi.tensor_params)
        body_nodes = list(walk_body(fi.node))
        for _ in range(3):
            before = len(tainted)
            for node in body_nodes:
                targets: list[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.NamedExpr):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    targets, value = [node.target], node.iter
                elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                    targets, value = [node.optional_vars], node.context_expr
                if value is None:
                    continue
                if not (taint_mentions(value, tainted) or self._torch_value(value)):
                    continue
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
            if len(tainted) == before:
                break
        return tainted

    def _torch_value(self, expr: ast.AST) -> bool:
        """A call of ``torch.*`` that returns a tensor (a factory or an op)."""
        if not isinstance(expr, ast.Call):
            return False
        name = self.canonical(dotted_name(expr.func)) or ""
        return name.startswith("torch.") and not name.startswith(
            ("torch.cuda.", "torch.distributed.", "torch.backends.", "torch.Size"))


def _assigned_names(func_node: ast.AST, before: int) -> set[str]:
    """Names the function binds on lines before ``before``."""
    return {node.id for node in walk_body(func_node)
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store)
            and node.lineno < before}


def taint_mentions(expr: ast.AST, tainted: set[str]) -> bool:
    """Does ``expr`` produce a tensor value given ``tainted`` names? Reads
    of shapes (``.shape``, ``.size()``, ``.dim()``, ``len(...)``), types
    (``isinstance``) and identities (``x is None``) break the taint: they are
    concrete at capture, and a branch on them is the same at every replay."""
    if not tainted:
        return False
    if isinstance(expr, ast.Attribute) and expr.attr in _TAINT_BREAKER_ATTRS:
        return False
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Name) and fn.id in _TAINT_BREAKER_CALLS:
            return False
        if isinstance(fn, ast.Attribute) and fn.attr in _TAINT_BREAKER_METHODS:
            return False
    if isinstance(expr, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    return any(taint_mentions(c, tainted)
               for c in ast.iter_child_nodes(expr))


# ---------------------------------------------------------------------------
# Engine driver
# ---------------------------------------------------------------------------


def iter_python_files(paths: Iterable[str]) -> Iterable[tuple[str, str]]:
    """Yield (abs_path, display_path) for every .py under ``paths``."""
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            yield root, os.path.basename(root)
            continue
        base = os.path.dirname(root)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in ("__pycache__", ".git", ".mypy_cache"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield full, os.path.relpath(full, base).replace(os.sep, "/")


def analyze_file(path: str, rel_path: str,
                 rules: Optional[Iterable[str]] = None) -> list[Finding]:
    from .rules import run_rules  # late: rules import this module
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    return analyze_source(source, rel_path, rules=rules, abs_path=path)


def analyze_source(source: str, rel_path: str, *,
                   rules: Optional[Iterable[str]] = None,
                   abs_path: str = "<string>") -> list[Finding]:
    from .rules import run_rules
    try:
        model = ModuleModel(abs_path, rel_path, source)
    except SyntaxError as e:
        return [Finding(rule="R0", path=rel_path, line=e.lineno or 0,
                        symbol="", detail="syntax-error",
                        message=f"does not parse: {e.msg}")]
    return run_rules(model, rules)


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Iterable[str]] = None) -> list[Finding]:
    findings: list[Finding] = []
    for full, rel in iter_python_files(paths):
        findings.extend(analyze_file(full, rel, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings


__all__ = [
    "Baseline",
    "DEFAULT_TARGETS",
    "Finding",
    "FunctionInfo",
    "ModuleModel",
    "RULES",
    "analyze_paths",
    "analyze_source",
    "default_baseline_path",
    "dotted_name",
    "iter_python_files",
    "taint_mentions",
    "walk_body",
]
