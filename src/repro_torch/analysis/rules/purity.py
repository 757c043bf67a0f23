"""R1 capture-purity + R2 host-sync: what captured code may not do.

The reference's R1 (scan-purity) and R2 (tracer-leak), read for CUDA-graph
capture. Code is *captured* when it runs inside ``with torch.cuda.graph``,
between ``capture_begin`` and ``capture_end``, or as a function passed to
``torch.cuda.make_graphed_callables``, or is reached from such code through
local calls (the engine's per-module call graph). Captured Python runs
ONCE, at capture; a replay repeats the kernels it launched and nothing of
the host:

* **R1** (the reference's "no host RNG / wall clock / I/O reachable from
  traced code"): host RNG (``numpy.random``, stdlib ``random``), wall-clock
  reads and file, network or environment I/O run at capture and never
  again, so every replay repeats the one draw or time they made. torch's
  own generators are captured as kernels (with their offsets), and stay
  legal.
* **R2** (the reference's "no host conversion of, or branch on, a traced
  value"): ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float()``/``int()``/``bool()`` and ``numpy.asarray`` on a tensor are
  host syncs, which a capture refuses (or, on a CPU tensor, bakes one value
  into the graph); an ``if``/``while`` on a tensor's value reads it on the
  host as well, and records one branch for every replay. The engine's
  taint says which names hold tensors; a branch on a shape, a type or an
  identity (``x is None``) stays legal.
"""
from __future__ import annotations

import ast
from typing import Optional

from ..lint import (
    Finding, FunctionInfo, ModuleModel, dotted_name, taint_mentions, walk_body,
)

#: canonical dotted prefixes forbidden in captured code (R1), with reasons.
_FORBIDDEN_PREFIXES = (
    ("numpy.random.", "host RNG"),
    ("random.", "host RNG"),
    ("secrets.", "host RNG"),
    ("time.time", "wall clock"),
    ("time.monotonic", "wall clock"),
    ("time.perf_counter", "wall clock"),
    ("time.process_time", "wall clock"),
    ("time.sleep", "host sleep"),
    ("datetime.datetime.now", "wall clock"),
    ("datetime.datetime.utcnow", "wall clock"),
    ("datetime.datetime.today", "wall clock"),
    ("datetime.date.today", "wall clock"),
    ("datetime.now", "wall clock"),
    ("socket.", "network I/O"),
    ("urllib.", "network I/O"),
    ("requests.", "network I/O"),
    ("http.client.", "network I/O"),
    ("os.urandom", "host RNG"),
    ("os.getenv", "host environment read"),
    ("os.environ", "host environment read"),
    ("subprocess.", "host process I/O"),
)

#: bare builtins forbidden as calls in captured code (R1: file I/O).
_FORBIDDEN_BUILTINS = {
    "open": "file I/O",
    "input": "console I/O",
}

#: numpy host-conversion calls (R2) once canonicalized.
_HOST_CONVERSIONS = {
    "numpy.asarray", "numpy.array", "numpy.asanyarray", "numpy.ascontiguousarray",
}

#: tensor methods that copy a value to the host (R2).
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def _forbidden(canon: str) -> Optional[str]:
    for prefix, why in _FORBIDDEN_PREFIXES:
        if canon == prefix or canon.startswith(prefix):
            return why
        if prefix.endswith(".") and canon == prefix[:-1]:
            return why
    return None


def check_capture_purity(model: ModuleModel) -> list[Finding]:
    """R1: no host RNG / wall clock / I/O reachable from captured code."""
    findings: list[Finding] = []
    for qual, fi in sorted(model.captured.items()):
        locals_here = _local_names(fi)
        for node in walk_body(fi.node):
            name = None
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
            elif isinstance(node, ast.Attribute):
                # plain attribute read, e.g. os.environ["X"]
                name = dotted_name(node)
            if not name:
                continue
            head = name.split(".", 1)[0]
            if head in locals_here and head not in model.imports:
                continue  # shadowed by a local binding — not the module
            canon = model.canonical(name)
            why = _forbidden(canon)
            if why is None and isinstance(node, ast.Call) \
                    and name in _FORBIDDEN_BUILTINS and head not in locals_here:
                canon, why = name, _FORBIDDEN_BUILTINS[name]
            if why is not None:
                findings.append(Finding(
                    rule="R1", path=model.rel_path, line=node.lineno,
                    symbol=qual, detail=canon,
                    message=(
                        f"{canon} ({why}) inside captured code "
                        f"({fi.capture_reason}): it runs once, at capture, and "
                        f"every replay repeats its value; draw on the device "
                        f"(torch's generators) or outside the capture"),
                ))
    return _dedup(findings)


def check_host_sync(model: ModuleModel) -> list[Finding]:
    """R2: no host read of, or branch on, a tensor in captured code."""
    findings: list[Finding] = []
    for qual, fi in sorted(model.captured.items()):
        tainted = model.tainted_names(fi)
        if not tainted:
            continue
        for node in walk_body(fi.node):
            if isinstance(node, ast.Call):
                findings.extend(_check_conversion_call(model, fi, qual, node, tainted))
            elif isinstance(node, (ast.If, ast.While)) \
                    and taint_mentions(node.test, tainted):
                kind = "if" if isinstance(node, ast.If) else "while"
                names = _tainted_in(node.test, tainted)
                findings.append(Finding(
                    rule="R2", path=model.rel_path, line=node.lineno,
                    symbol=qual, detail=f"{kind}-on-tensor:{names}",
                    message=(
                        f"`{kind}` branches on tensor value(s) {names} "
                        f"({fi.capture_reason}): a host sync, and the graph "
                        f"records one branch for every replay; use torch.where"),
                ))
    return _dedup(findings)


def _check_conversion_call(model: ModuleModel, fi: FunctionInfo, qual: str,
                           node: ast.Call, tainted: set[str]) -> list[Finding]:
    out: list[Finding] = []
    name = dotted_name(node.func)
    arg0_tainted = bool(node.args) and taint_mentions(node.args[0], tainted)
    if name in ("float", "int", "bool", "complex") and arg0_tainted:
        names = _tainted_in(node.args[0], tainted)
        out.append(Finding(
            rule="R2", path=model.rel_path, line=node.lineno, symbol=qual,
            detail=f"{name}-on-tensor:{names}",
            message=(
                f"{name}() reads tensor value(s) {names} on the host "
                f"({fi.capture_reason}): a host sync inside a capture"),
        ))
    elif name and model.canonical(name) in _HOST_CONVERSIONS and arg0_tainted:
        canon = model.canonical(name)
        names = _tainted_in(node.args[0], tainted)
        out.append(Finding(
            rule="R2", path=model.rel_path, line=node.lineno, symbol=qual,
            detail=f"{canon}-on-tensor:{names}",
            message=(
                f"{canon}() copies tensor value(s) {names} to the host "
                f"({fi.capture_reason}): a host sync inside a capture"),
        ))
    elif isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS \
            and not node.args and taint_mentions(node.func.value, tainted):
        method = node.func.attr
        names = _tainted_in(node.func.value, tainted)
        out.append(Finding(
            rule="R2", path=model.rel_path, line=node.lineno, symbol=qual,
            detail=f"{method}-on-tensor:{names}",
            message=(
                f".{method}() copies tensor value(s) {names} to the host "
                f"({fi.capture_reason}): a host sync inside a capture"),
        ))
    return out


def _local_names(fi: FunctionInfo) -> set[str]:
    """Params + names assigned anywhere in the body (shadow check)."""
    names = set(fi.params)
    for node in walk_body(fi.node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.NamedExpr, ast.For)):
            targets = getattr(node, "targets", None) \
                or [getattr(node, "target", None)]
            for t in targets:
                if t is None:
                    continue
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def _tainted_in(expr: ast.AST, tainted: set[str]) -> str:
    hits = sorted({n.id for n in ast.walk(expr)
                   if isinstance(n, ast.Name) and n.id in tainted})
    return ",".join(hits)


def _dedup(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
