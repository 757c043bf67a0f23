"""Fleet-level meta-scheduler (DESIGN.md §14).

The paper's gate picks *instances* inside one platform; this package
routes one live request stream *across* heterogeneous Minos-gated fleets
— each a full :class:`~repro_torch.sim.platform.FaaSPlatform` on a shared
:class:`~repro_torch.core.substrate.SimClock` — through a pluggable
:class:`RoutingPolicy` (random / weighted-static / greedy /
probabilistic-split), with optional request hedging. Per-fleet
:class:`CircuitBreaker` gating, failover, and QoS-priority load shedding
(DESIGN.md §15) sit on top of the same routing policies.
"""
from .policies import (
    GreedyRoutingPolicy,
    ProbabilisticRoutingPolicy,
    RandomRoutingPolicy,
    RouteContext,
    RoutingPolicy,
    RoutingPolicyBase,
    WeightedStaticRoutingPolicy,
    solve_split,
)
from .resilience import BreakerConfig, BreakerState, CircuitBreaker
from .router import FleetRouter, FleetRunResult, FleetSpec, run_fleet_open_loop

__all__ = [
    "BreakerConfig",
    "BreakerState",
    "CircuitBreaker",
    "FleetRouter",
    "FleetRunResult",
    "FleetSpec",
    "GreedyRoutingPolicy",
    "ProbabilisticRoutingPolicy",
    "RandomRoutingPolicy",
    "RouteContext",
    "RoutingPolicy",
    "RoutingPolicyBase",
    "WeightedStaticRoutingPolicy",
    "run_fleet_open_loop",
    "solve_split",
]
