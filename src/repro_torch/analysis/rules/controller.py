"""R3 controller-purity: controllers decide, engines act (DESIGN.md §10).

The control-plane contract every PR since 4 hand-verified: a
:class:`~repro.core.control.Controller` receives a read-only
:class:`~repro.core.control.Telemetry` view and returns a decision; all
side effects (pool mutation, lifecycle transitions, billing) stay
engine-owned. A controller that mutates the pool or telemetry silently
desynchronizes the engine's O(1) aggregates and the seeded golden digests
— the drift is invisible until a sweep diverges. Statically enforced:

* no assignment (or augmented assignment / delete) to an attribute of a
  telemetry expression (``ctx.telemetry.x = ...``, ``telemetry.y += 1``);
* no calls to pool mutators (``take``/``release``/``retire``/
  ``add_warm``/``drop``/``admit_cold``/``submit``) on pool- or
  engine-reaching expressions (``...pool.take(...)``,
  ``ctx.telemetry._engine...`` — reaching through Telemetry's private
  engine handle is itself the violation);
* no mutable shared state: ``global`` statements in controller methods
  and mutable (list/dict/set literal) class-level attributes — a
  controller must be re-instantiable per engine without cross-run bleed.

A class is a controller when its base chain (resolved within the module)
or its name says so: bases named ``Controller``/``ControllerBase``/
``DelegatingController``/``ClassicMinosController`` (any dotted
spelling), or a class name ending in ``Controller``.

Fleet routing policies (``repro.fleet.policies``) sit on the same side
of the contract: they receive a read-only
:class:`~repro.core.control.FleetTelemetry` per
:class:`~repro.fleet.policies.RouteContext` and return a fleet index —
submits and hedges are the :class:`~repro.fleet.router.FleetRouter`'s
job. So classes named/based ``*RoutingPolicy`` (or
``RoutingPolicyBase``) are scanned under the same rule. The router
itself is deliberately exempt: ``FleetRouter`` is an engine-side actor
(it must call ``engine.submit``), which is why the match is on
``RoutingPolicy``, never on ``*Router``.
"""
from __future__ import annotations

import ast

from ..lint import Finding, ModuleModel, dotted_name, walk_body

_CONTROLLER_BASES = {
    "Controller", "ControllerBase", "DelegatingController",
    "ClassicMinosController", "RoutingPolicy", "RoutingPolicyBase",
}


def _name_is_controller(name: str) -> bool:
    tail = name.split(".")[-1]
    return (tail.endswith("Controller") or tail.endswith("RoutingPolicy")
            or tail == "RoutingPolicyBase")

_POOL_MUTATORS = {
    "take", "release", "retire", "add_warm", "drop", "admit_cold",
    "submit", "requeue", "push",
}


def _is_controller(model: ModuleModel, name: str,
                   _seen: frozenset = frozenset()) -> bool:
    if name in _seen:
        return False
    ci = model.classes.get(name)
    if ci is None:
        return _name_is_controller(name)
    if _name_is_controller(ci.name):
        return True
    for base in ci.bases:
        tail = base.split(".")[-1]
        if tail in _CONTROLLER_BASES:
            return True
        if _is_controller(model, base, _seen | {name}):
            return True
    return False


def _reaches_telemetry(node: ast.AST) -> bool:
    """Expression flows through a telemetry handle: any segment named
    ``telemetry`` in the attribute chain, or a bare name ``telemetry``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "telemetry":
            return True
        if isinstance(sub, ast.Name) and sub.id == "telemetry":
            return True
    return False


def _reaches_pool_or_engine(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "pool", "_engine", "engine", "queue", "loop"):
            return True
        if isinstance(sub, ast.Name) and sub.id in ("pool", "engine"):
            return True
    return False


def check_controller_purity(model: ModuleModel) -> list[Finding]:
    findings: list[Finding] = []
    for cls_name, ci in sorted(model.classes.items()):
        if not _is_controller(model, cls_name):
            continue
        # mutable class-level attributes (shared across instances)
        for node in ci.node.body:
            value = None
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target, value = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                target, value = node.target.id, node.value
            if value is not None and isinstance(
                    value, (ast.List, ast.Dict, ast.Set)):
                kind = type(value).__name__.lower()
                findings.append(Finding(
                    rule="R3", path=model.rel_path, line=node.lineno,
                    symbol=cls_name, detail=f"mutable-class-attr:{target}",
                    message=(
                        f"controller class attribute `{target}` is a "
                        f"mutable {kind} literal shared across instances; "
                        f"initialize it per-instance in __init__"),
                ))
        for meth_name, meth_qual in sorted(ci.methods.items()):
            fi = model.functions.get(meth_qual)
            if fi is None:
                continue
            for node in walk_body(fi.node):
                findings.extend(
                    _check_stmt(model, meth_qual, node))
    return findings


def _check_stmt(model: ModuleModel, qual: str, node: ast.AST) -> list[Finding]:
    out: list[Finding] = []
    # telemetry attribute writes
    targets: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    for t in targets:
        if isinstance(t, (ast.Attribute, ast.Subscript)) \
                and _reaches_telemetry(t):
            name = dotted_name(t) or "<telemetry attribute>"
            out.append(Finding(
                rule="R3", path=model.rel_path, line=node.lineno,
                symbol=qual, detail=f"telemetry-write:{name}",
                message=(
                    f"controller writes `{name}` through the read-only "
                    f"Telemetry view; controllers decide, engines act "
                    f"(DESIGN.md §10)"),
            ))
    # pool/engine mutator calls
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        recv = node.func.value
        if attr in _POOL_MUTATORS and (
                _reaches_pool_or_engine(recv) or _reaches_telemetry(recv)):
            name = dotted_name(node.func) or f"<...>.{attr}"
            out.append(Finding(
                rule="R3", path=model.rel_path, line=node.lineno,
                symbol=qual, detail=f"pool-mutator:{attr}",
                message=(
                    f"controller calls pool/engine mutator `{name}`; "
                    f"lifecycle side effects are engine-owned — return a "
                    f"decision instead"),
            ))
    # global state
    if isinstance(node, ast.Global):
        for gname in node.names:
            out.append(Finding(
                rule="R3", path=model.rel_path, line=node.lineno,
                symbol=qual, detail=f"global-state:{gname}",
                message=(
                    f"controller method declares `global {gname}` — "
                    f"module-level mutable state bleeds across engines/"
                    f"runs; keep controller state per-instance"),
            ))
    return out
