"""Discrete-event FaaS platform simulator (the paper's evaluation substrate).

Copies of ``repro.sim``'s event-driven modules, numpy randomness and all, so
the same seeds give the same runs, and the vectorized Monte-Carlo path
(``vectorized``) as batched torch over arms × seeds, on the card by
default."""
from .experiment import (
    ARMS,
    PAPER_PRICING,
    PAPER_SPEC,
    PASS_FRACTION,
    DayResult,
    WeekResult,
    make_arm_policy,
    run_day,
    run_pretest_phase,
    run_week,
    workflow_arm_factory,
)
from .arrivals import (
    ArrivalProcess,
    DiurnalPoissonProcess,
    MMPPProcess,
    OpenLoopRun,
    PoissonProcess,
    QoSClass,
    TraceProcess,
    arrival_times_ms,
    run_open_loop,
)
from .metrics import (
    ArmSummary,
    FleetSummary,
    OpenLoopSummary,
    WorkflowSummary,
    cost_timeline,
    improvement,
    slo_attainment_by_class,
)
from .platform import (
    FaaSPlatform,
    FunctionSpec,
    PlatformProfile,
    RequestResult,
    SimFunctionBackend,
)
from .variation import VariationModel, paper_week
from .vectorized import (
    ArmParams,
    VecResult,
    arm_from_spec,
    run_event_chain,
    simulate_arms,
    simulate_open_arms,
    stack_arms,
)
from .workflow_dag import (
    ItemResult,
    Stage,
    WorkflowDAG,
    WorkflowEngine,
    WorkflowRunResult,
    etl_chain,
    etl_suite,
    run_workflow_batch,
    run_workflow_closed_loop,
    run_workflow_open_loop,
)
from .workload import WorkflowSpec, make_chain, run_closed_loop, run_workflow

__all__ = [
    "ARMS", "PAPER_PRICING", "PAPER_SPEC", "PASS_FRACTION",
    "DayResult", "WeekResult", "make_arm_policy", "run_day",
    "run_pretest_phase", "run_week", "workflow_arm_factory",
    "ArmSummary", "FleetSummary", "OpenLoopSummary", "WorkflowSummary",
    "cost_timeline", "improvement", "slo_attainment_by_class",
    "ArrivalProcess", "DiurnalPoissonProcess", "MMPPProcess", "OpenLoopRun",
    "PoissonProcess", "QoSClass", "TraceProcess", "arrival_times_ms",
    "run_open_loop",
    "FaaSPlatform", "FunctionSpec", "PlatformProfile", "RequestResult",
    "SimFunctionBackend",
    "VariationModel", "paper_week",
    "ArmParams", "VecResult", "arm_from_spec", "run_event_chain",
    "simulate_arms", "simulate_open_arms", "stack_arms",
    "ItemResult", "Stage", "WorkflowDAG", "WorkflowEngine",
    "WorkflowRunResult", "etl_chain", "etl_suite",
    "run_workflow_batch", "run_workflow_closed_loop",
    "run_workflow_open_loop",
    "WorkflowSpec", "make_chain", "run_closed_loop", "run_workflow",
]
