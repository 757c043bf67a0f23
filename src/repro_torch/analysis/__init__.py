"""repro_torch.analysis — the port's static checks and runtime sanitizer.

Static side (``python -m repro_torch.analysis``): ``repro.analysis``'s AST
lint, its engine copied (:mod:`repro_torch.analysis.lint`, stdlib ``ast``
alone) and its rules read for what the port compiles, CUDA graphs: the code
a graph captures (``torch.cuda.graph``, ``capture_begin``/``capture_end``,
``make_graphed_callables``, and what those reach) draws no host RNG and
reads no clock or file (R1), syncs nothing to the host (R2), is captured
once a key (R4) and writes its state in place (R5); R3 (controller purity)
and R6 (fault-injector purity) are the reference's, copied. It checks
``src/repro_torch/`` and ``chip_smoke.py`` by default, with a fingerprint
baseline (``baseline.json``, empty) so grandfathered findings only ratchet
down. ``python -m repro.analysis`` lints this package too, with the
reference's rules.

Runtime side (``REPRO_SANITIZE=1``): :mod:`repro_torch.analysis.sanitizer`
is a copy of ``repro``'s and wraps the port's SubstrateEngine and
InstancePool with the same conservation, heap-consistency,
telemetry-immutability and NaN/inf checks.
"""
from __future__ import annotations

from .lint import (
    Baseline,
    DEFAULT_TARGETS,
    Finding,
    ModuleModel,
    RULES,
    analyze_paths,
    analyze_source,
    default_baseline_path,
)

__all__ = [
    "Baseline",
    "DEFAULT_TARGETS",
    "Finding",
    "ModuleModel",
    "RULES",
    "analyze_paths",
    "analyze_source",
    "default_baseline_path",
]
