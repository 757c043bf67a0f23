"""R4 recapture-hazard + R5 in-place-state.

R4 reads the reference's recompile hazard for capture. A ``jax.jit``
wrapper made per call never hits its compile cache; a CUDA graph captured
per call is the same hazard, and worse (each capture holds its own memory
pool until dropped). Flagged:

* a capture inside a ``for``/``while`` loop (``with torch.cuda.graph``,
  ``capture_begin``, ``make_graphed_callables``; the reference's
  ``jit-in-loop``): hoist it, and keep one graph per key;
* a capture keyed by a value that changes from call to call: in a function
  that captures (directly, or through a local call), a container lookup or
  store whose key reads ``id()``, ``.data_ptr()``, the wall clock or a
  tensor's value (``.item()``, ``.tolist()``), directly or through a local
  name, recaptures at every call (the reference's unhashable or
  structure-unstable ``container-arg``);
* ``torch.compile(f)(x)`` invoked on the spot, or ``torch.compile`` inside
  a loop (the reference's ``jit-immediate-call``): the compiled wrapper
  and its cache die with the expression.

R5 reads the reference's scan-carrier rule for capture. A ``lax.scan``
carry must keep one structure; a captured body's state must keep its
buffers. A replay writes into the tensors the capture recorded, so state
that the body rebinds to a new tensor is a result that no later replay
updates and nobody reads where the old buffer was. In captured code, write
state in place (``t.copy_(new)``, ``t.index_copy_(...)``, ``t[...] = new``);
flagged are an attribute rebound (``self.state = new``), a dict entry
rebound by name (``cache["h"] = new``, ``cache[f"g{i}.C"] = new``), and a
tensor parameter rebound (``state = f(state)``) that the function does not
return.
"""
from __future__ import annotations

import ast
from typing import Optional

from ..lint import GRAPHED_CALLABLES, Finding, ModuleModel, dotted_name, walk_body

_COMPILERS = {"torch.compile"}
#: what makes a key differ from call to call
_PER_CALL_CALLS = {"id"}
_PER_CALL_METHODS = {"data_ptr", "item", "tolist"}
_PER_CALL_PREFIXES = ("time.", "datetime.")


def _is_compile(model: ModuleModel, node: ast.AST) -> bool:
    """``torch.compile(...)`` or ``functools.partial(torch.compile, ...)``."""
    if not isinstance(node, ast.Call):
        return False
    fn = model.canonical(dotted_name(node.func))
    if fn in _COMPILERS:
        return True
    if fn in ("functools.partial", "partial") and node.args:
        return model.canonical(dotted_name(node.args[0])) in _COMPILERS
    return False


def _inside_loop(model: ModuleModel, node: ast.AST) -> bool:
    cur = model.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False  # a def inside a loop captures once per call
        cur = model.parents.get(cur)
    return False


def _symbol(model: ModuleModel, node: ast.AST) -> str:
    fi = model.enclosing_function(node)
    return fi.qualname if fi else ""


def _per_call(model: ModuleModel, expr: ast.AST, names: set) -> Optional[str]:
    """What in ``expr`` differs from call to call, or None."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and sub.id in names:
            return sub.id
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Name) and sub.func.id in _PER_CALL_CALLS:
            return f"{sub.func.id}()"
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in _PER_CALL_METHODS:
            return f".{sub.func.attr}()"
        canon = model.canonical(dotted_name(sub.func)) or ""
        if canon.startswith(_PER_CALL_PREFIXES):
            return canon
    return None


def _capturing_functions(model: ModuleModel) -> set[str]:
    """Functions that capture: they hold a capture, or call one that does."""
    out = {r.function.qualname for r in model.regions if r.function is not None}
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Call) and model.canonical(
                dotted_name(node.func)) in GRAPHED_CALLABLES:
            fi = model.enclosing_function(node)
            if fi is not None:
                out.add(fi.qualname)
    changed = True
    while changed:
        changed = False
        for qual, fi in model.functions.items():
            if qual in out:
                continue
            if any((callee := model.resolve_call(fi, name)) is not None
                   and callee.qualname in out for name, _ in fi.calls):
                out.add(qual)
                changed = True
    return out


def _bound_names(target: ast.AST) -> set[str]:
    """The names an assignment target binds (not those it reads: the
    ``self`` of ``self.x = ...``)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound_names(e) for e in target.elts))
    return set()


def _keys(node: ast.AST) -> list[ast.AST]:
    """The keys a node looks up or stores: ``d[k]``, ``d.get(k)``,
    ``d.setdefault(k, ...)``, ``d.pop(k)``, ``k in d``."""
    if isinstance(node, ast.Subscript):
        return [node.slice]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("get", "setdefault", "pop") and node.args:
        return [node.args[0]]
    if isinstance(node, ast.Compare) and any(isinstance(op, (ast.In, ast.NotIn))
                                             for op in node.ops):
        return [node.left]
    return []


def check_recapture_hazard(model: ModuleModel) -> list[Finding]:
    findings: list[Finding] = []
    for region in model.regions:
        if _inside_loop(model, region.node):
            findings.append(Finding(
                rule="R4", path=model.rel_path, line=region.node.body[0].lineno,
                symbol=region.function.qualname if region.function else "",
                detail=f"capture-in-loop:{region.kind}",
                message=(
                    "a CUDA graph captured inside a loop: every iteration "
                    "records a new graph (and holds its memory); capture once "
                    "per key, outside the loop, and replay"),
            ))
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = model.canonical(dotted_name(node.func))
        if canon in GRAPHED_CALLABLES and _inside_loop(model, node):
            findings.append(Finding(
                rule="R4", path=model.rel_path, line=node.lineno,
                symbol=_symbol(model, node), detail="capture-in-loop:make_graphed_callables",
                message=(
                    "make_graphed_callables inside a loop captures new graphs "
                    "at every iteration; graph the callables once"),
            ))
        if isinstance(node.func, ast.Call) and _is_compile(model, node.func):
            findings.append(Finding(
                rule="R4", path=model.rel_path, line=node.lineno,
                symbol=_symbol(model, node), detail="compile-immediate-call",
                message=(
                    "torch.compile(...) applied and called on the spot: the "
                    "compiled wrapper (and its cache) dies with the "
                    "expression; compile once and call the result"),
            ))
        elif _is_compile(model, node) and _inside_loop(model, node):
            findings.append(Finding(
                rule="R4", path=model.rel_path, line=node.lineno,
                symbol=_symbol(model, node), detail="compile-in-loop",
                message=(
                    "torch.compile applied inside a loop: every iteration "
                    "builds a fresh wrapper; hoist it out of the loop"),
            ))
    for qual in sorted(_capturing_functions(model)):
        fi = model.functions[qual]
        per_call: set[str] = set()
        for _ in range(2):
            for sub in walk_body(fi.node):
                if isinstance(sub, ast.Assign) and _per_call(model, sub.value, per_call):
                    per_call.update(n for t in sub.targets for n in _bound_names(t))
        for sub in walk_body(fi.node):
            for key in _keys(sub):
                what = _per_call(model, key, per_call)
                if what is not None:
                    findings.append(Finding(
                        rule="R4", path=model.rel_path, line=sub.lineno, symbol=qual,
                        detail=f"per-call-key:{what}",
                        message=(
                            f"a capturing function keys a container by {what}, "
                            f"which differs from call to call: every call "
                            f"misses its graph and captures again; key by "
                            f"shapes and static settings"),
                    ))
    return findings


def _string_key(node: ast.AST) -> bool:
    return isinstance(node, ast.JoinedStr) or (
        isinstance(node, ast.Constant) and isinstance(node.value, str))


def check_in_place_state(model: ModuleModel) -> list[Finding]:
    findings: list[Finding] = []
    for qual, fi in sorted(model.captured.items()):
        returned: set[str] = set()
        for sub in walk_body(fi.node):
            if isinstance(sub, ast.Return) and sub.value is not None:
                returned.update(n.id for n in ast.walk(sub.value) if isinstance(n, ast.Name))
        for sub in walk_body(fi.node):
            if not isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                continue
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            if isinstance(sub, ast.AugAssign):
                continue  # x += y on a tensor is in place
            for target in targets:
                for t in ast.walk(target):
                    detail = None
                    if isinstance(t, ast.Attribute) and isinstance(t.ctx, ast.Store) \
                            and dotted_name(t.value) == "self":
                        detail = f"rebind-attr:self.{t.attr}"
                    elif isinstance(t, ast.Subscript) and isinstance(t.ctx, ast.Store) \
                            and _string_key(t.slice):
                        detail = f"rebind-item:{dotted_name(t.value) or '<expr>'}"
                    elif isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store) \
                            and t.id in fi.tensor_params and t.id not in returned:
                        detail = f"rebind-param:{t.id}"
                    if detail is None:
                        continue
                    findings.append(Finding(
                        rule="R5", path=model.rel_path, line=sub.lineno, symbol=qual,
                        detail=detail,
                        message=(
                            f"captured code rebinds state to a new tensor "
                            f"({detail.split(':', 1)[1]}; {fi.capture_reason}): "
                            f"replays write the captured buffers, so write it in "
                            f"place (copy_, index_copy_, t[...] = new)"),
                    ))
    return findings
