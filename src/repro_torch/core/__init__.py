"""Minos core: instance selection via benchmark-gated self-termination."""
from .benchmark import CallableProbe, MatmulProbe, effective_cold_start_overhead_ms, overlap_fraction
from .control import (
    AdmitDecision,
    ClassicMinosController,
    Controller,
    ControllerBase,
    PassFractionController,
    ProbeDecision,
    QueueAwareAdmissionController,
    ReprobeController,
    ReuseDecision,
    Telemetry,
    lognormal_pool_speedup,
    static_admission_bound,
)
from .cost import Pricing, WorkflowCost, total_cost
from .elysium import (
    OnlineElysiumController,
    PretestReport,
    optimal_pass_fraction,
    pretest_threshold,
    run_pretest,
)
from .estimators import EMA, P2Quantile, Welford
from .lifecycle import FunctionInstance, InstanceState, LifecycleError
from .policy import (
    AdaptiveMinosPolicy,
    MinosPolicy,
    Verdict,
    expected_cold_start_attempts,
    retries_for_runaway_budget,
    runaway_probability,
)
from .queue import Invocation, InvocationQueue
from .substrate import (
    ElysiumGate,
    InstancePool,
    RequestResult,
    SimClock,
    SubstrateEngine,
    SubstrateKnobs,
    sample_jitter,
)

__all__ = [
    "CallableProbe", "MatmulProbe", "effective_cold_start_overhead_ms", "overlap_fraction",
    "AdmitDecision", "ClassicMinosController", "Controller", "ControllerBase",
    "PassFractionController", "ProbeDecision", "QueueAwareAdmissionController",
    "ReprobeController", "ReuseDecision", "Telemetry", "lognormal_pool_speedup",
    "static_admission_bound",
    "Pricing", "WorkflowCost", "total_cost",
    "OnlineElysiumController", "PretestReport", "optimal_pass_fraction",
    "pretest_threshold", "run_pretest",
    "EMA", "P2Quantile", "Welford",
    "FunctionInstance", "InstanceState", "LifecycleError",
    "AdaptiveMinosPolicy", "MinosPolicy", "Verdict", "expected_cold_start_attempts",
    "retries_for_runaway_budget", "runaway_probability",
    "Invocation", "InvocationQueue",
    "ElysiumGate", "InstancePool", "RequestResult", "SimClock",
    "SubstrateEngine", "SubstrateKnobs", "sample_jitter",
]
