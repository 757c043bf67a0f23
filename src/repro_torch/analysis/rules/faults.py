"""R6 fault-injector purity: fault schedules draw only injected,
seeded randomness (DESIGN.md §15).

The fault-injection substrate's whole value is *reproducible* failure:
a crash schedule that consults the host RNG, the wall clock, the
environment, or a file is a different experiment on every run — and the
acceptance criterion "FaultPlan disabled ⇒ bit-identical goldens" is
unverifiable if the injector can smuggle in entropy. Statically
enforced for every class whose name (or base chain) ends in
``FaultPlan`` or ``FaultProcess``:

* no host RNG / wall clock / IO / environment reads (the R1 forbidden
  set: ``numpy.random.*``, ``random.*``, ``time.time``, ``open``, ...)
  anywhere in a method body — with ONE exemption: *constructing* a
  seeded generator, ``numpy.random.RandomState(seed)`` /
  ``numpy.random.default_rng(seed)`` *with at least one argument*, is
  the sanctioned pattern (the injector owns a private stream);
* the unseeded constructors (``RandomState()`` / ``default_rng()``)
  are flagged separately (``unseeded-rng``): they seed from the OS and
  differ per process.

Module-level fault *configuration* (rates, windows) is plain data and
not scanned; only the injector classes' methods are.
"""
from __future__ import annotations

import ast

from ..lint import Finding, ModuleModel, dotted_name, walk_body
from .purity import _FORBIDDEN_BUILTINS, _forbidden, _local_names

_FAULT_SUFFIXES = ("FaultPlan", "FaultProcess")

#: seeded-generator constructors exempt from the host-RNG ban when
#: called with at least one (seed) argument.
_SEEDED_CTORS = {
    "numpy.random.RandomState",
    "numpy.random.default_rng",
    "numpy.random.Generator",
}


def _name_is_fault_injector(name: str) -> bool:
    tail = name.split(".")[-1]
    return tail.endswith(_FAULT_SUFFIXES)


def _is_fault_injector(model: ModuleModel, name: str,
                       _seen: frozenset = frozenset()) -> bool:
    if name in _seen:
        return False
    ci = model.classes.get(name)
    if ci is None:
        return _name_is_fault_injector(name)
    if _name_is_fault_injector(ci.name):
        return True
    for base in ci.bases:
        if _name_is_fault_injector(base):
            return True
        if _is_fault_injector(model, base, _seen | {name}):
            return True
    return False


def check_fault_injector_purity(model: ModuleModel) -> list[Finding]:
    """R6: ``*FaultPlan``/``*FaultProcess`` methods touch no host
    entropy beyond constructing their own seeded generator."""
    findings: list[Finding] = []
    for cls_name, ci in sorted(model.classes.items()):
        if not _is_fault_injector(model, cls_name):
            continue
        for meth_name, meth_qual in sorted(ci.methods.items()):
            fi = model.functions.get(meth_qual)
            if fi is None:
                continue
            locals_here = _local_names(fi)
            # generator-constructor calls are judged at the Call node;
            # their func attribute chains must not re-fire as bare reads
            ctor_chain_ids: set[int] = set()
            for node in walk_body(fi.node):
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name and model.canonical(name) in _SEEDED_CTORS:
                        ctor_chain_ids.update(
                            id(sub) for sub in ast.walk(node.func))
            for node in walk_body(fi.node):
                name = None
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                elif isinstance(node, ast.Attribute):
                    if id(node) in ctor_chain_ids:
                        continue
                    name = dotted_name(node)
                if not name:
                    continue
                head = name.split(".", 1)[0]
                if head in locals_here and head not in model.imports:
                    continue  # shadowed by a local binding
                canon = model.canonical(name)
                if canon in _SEEDED_CTORS and isinstance(node, ast.Call):
                    if node.args or node.keywords:
                        continue  # seeded ctor: the sanctioned pattern
                    findings.append(Finding(
                        rule="R6", path=model.rel_path, line=node.lineno,
                        symbol=meth_qual, detail=f"unseeded-rng:{canon}",
                        message=(
                            f"{canon}() without a seed draws OS entropy — "
                            f"the fault schedule differs per process; pass "
                            f"the injected seed (DESIGN.md §15)"),
                    ))
                    continue
                why = _forbidden(canon)
                if why is None and isinstance(node, ast.Call) \
                        and name in _FORBIDDEN_BUILTINS \
                        and head not in locals_here:
                    canon, why = name, _FORBIDDEN_BUILTINS[name]
                if why is not None:
                    findings.append(Finding(
                        rule="R6", path=model.rel_path, line=node.lineno,
                        symbol=meth_qual, detail=canon,
                        message=(
                            f"{canon} ({why}) inside fault injector "
                            f"{cls_name}; fault schedules must draw only "
                            f"from their own injected seeded RNG "
                            f"(DESIGN.md §15)"),
                    ))
    return _dedup(findings)


def _dedup(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
