"""Rule registry for :mod:`repro_torch.analysis`, as ``repro.analysis``'s.

Each rule module exposes ``check(model) -> list[Finding]`` functions
registered here under their rule ids. The engine (``lint.py``) owns the
module model (imports, call graph, captured set), the rules own the
judgments. R3 and R6 are the reference's rules, copied; R1, R2, R4 and R5
read the reference's rules about JAX tracing for CUDA-graph capture.
"""
from __future__ import annotations

from typing import Iterable, Optional

from ..lint import Finding, ModuleModel
from . import controller, faults, purity, recompile

#: rule id -> checker. Order is report order within a file.
REGISTRY = {
    "R1": purity.check_capture_purity,
    "R2": purity.check_host_sync,
    "R3": controller.check_controller_purity,
    "R4": recompile.check_recapture_hazard,
    "R5": recompile.check_in_place_state,
    "R6": faults.check_fault_injector_purity,
}


def run_rules(model: ModuleModel,
              rules: Optional[Iterable[str]] = None) -> list[Finding]:
    selected = list(rules) if rules else list(REGISTRY)
    unknown = [r for r in selected if r not in REGISTRY]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)}; "
                         f"available: {', '.join(REGISTRY)}")
    findings: list[Finding] = []
    for rule in selected:
        findings.extend(REGISTRY[rule](model))
    return findings


__all__ = ["REGISTRY", "run_rules"]
