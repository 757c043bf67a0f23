"""The fleet meta-scheduler: N Minos-gated fleets, one clock, one stream
(DESIGN.md §14; ROADMAP: fleet-level meta-scheduler).

Per-instance selection (the paper's gate) composes with cross-platform
selection: each fleet is a full :class:`~repro_torch.sim.platform.FaaSPlatform`
— its own profile, knobs, warm pool, controller and RNG — and the
:class:`FleetRouter` owns the one :class:`~repro_torch.core.substrate.SimClock`
they all share, so fleet timelines interleave exactly. Every arrival is
routed by a pluggable :class:`~repro_torch.fleet.policies.RoutingPolicy` fed a
read-only :class:`~repro_torch.core.control.FleetTelemetry`; the router alone
performs submits, hedges and the conservation bookkeeping.

Hedging (``hedge_after_ms``): a request still incomplete after that long
is duplicated onto a second fleet (the policy re-routes with the primary
excluded), first completion wins. The loser runs to completion and its
cost is billed by whichever engine served it — there is no free
cancellation; ``count_hedge_waste=False`` is the *idealized* view that
subtracts the measured loser cost (``hedge_waste_cost``) from
``total_cost``, kept as an explicit flag so the honest accounting is the
default.

Conservation (sanitizer ``check_fleet_conservation``, armed under
``REPRO_SANITIZE=1`` at the end of :func:`run_fleet_open_loop`)::

    Σ_f arrived_f   == (n_arrived - n_rejected) + n_hedges  (copies enter once)
    Σ_f completed_f == n_completed + n_hedge_cancelled
    Σ_f dropped_f   == n_dropped + n_hedge_dropped
    Σ_f dead_f      == n_dead_lettered + n_hedge_dead_lettered
    arrived_f       == completed_f + dropped_f + dead_f + parked_f  (per fleet)
    n_arrived       == n_completed + n_dropped + n_rejected
                       + n_dead_lettered + n_pending               (logical)

Failure resilience (DESIGN.md §15): with a ``breaker``
(:class:`~repro_torch.fleet.resilience.BreakerConfig`), each fleet gets a
circuit breaker fed by its engine's per-attempt fault stream (and by
queue-full submit refusals); routing to a tripped fleet fails over
through the policy's ``exclude`` re-route, then a deterministic
first-allowing scan; when every breaker rejects, the request is
*rejected* at the router (``n_rejected``) — never submitted anywhere.
``shed_when_degraded`` additionally sheds the lowest-priority QoS
classes (one priority level per OPEN breaker, the top level never sheds)
— graceful degradation. A request whose every submitted copy
dead-letters inside its engine closes as ``n_dead_lettered``.

Deliberate omissions (documented in DESIGN.md §14): the router does not
run the per-engine admission-deferral layer (arrivals queue inside the
chosen fleet; a finite ``queue_capacity`` drop is a logical drop, not a
re-route), and a hedge is attempted at most once per request.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import sanitizer as _sanitizer
from repro_torch.core.control import FleetTelemetry
from repro_torch.core.cost import Pricing
from repro_torch.core.substrate import RequestResult, SimClock, SubstrateKnobs
from repro_torch.sim.arrivals import (
    ArrivalProcess,
    QoSClass,
    arrival_times_ms,
    draw_classes,
)
from repro_torch.sim.platform import FaaSPlatform, FunctionSpec, PlatformProfile
from repro_torch.sim.variation import VariationModel

from .policies import RouteContext, RoutingPolicy
from .resilience import BreakerConfig, BreakerState, CircuitBreaker


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One fleet's full configuration. ``policy`` is the classic Minos
    gate stack; ``controller_factory`` builds a fresh
    :class:`~repro_torch.core.control.Controller` per engine (controllers are
    stateful — sharing one across fleets would bleed estimates). Exactly
    one of the two must be provided.

    ``fault_plan_factory`` builds a fresh
    :class:`~repro_torch.faults.FaultPlan` per engine (plans hold a private RNG
    stream — sharing one would entangle fleets) from the engine's derived
    seed; ``recovery`` is a frozen :class:`~repro_torch.faults.RecoveryPolicy`
    and may be shared."""

    name: str
    spec: FunctionSpec
    variation: VariationModel
    profile: Optional[PlatformProfile] = None
    knobs: Optional[SubstrateKnobs] = None
    policy: Any = None
    controller_factory: Optional[Callable[[], Any]] = None
    pricing: Optional[Pricing] = None
    fault_plan_factory: Optional[Callable[[int], Any]] = None
    recovery: Any = None

    def build(self, *, seed: int, clock: SimClock) -> FaaSPlatform:
        controller = (self.controller_factory()
                      if self.controller_factory is not None else None)
        if (controller is None) == (self.policy is None):
            raise ValueError(
                f"fleet {self.name!r} needs exactly one of policy / "
                f"controller_factory")
        fault_plan = (self.fault_plan_factory(seed)
                      if self.fault_plan_factory is not None else None)
        return FaaSPlatform(
            self.spec, self.variation,
            self.policy if controller is None else None,
            pricing=self.pricing, seed=seed, profile=self.profile,
            controller=controller, knobs=self.knobs, clock=clock,
            fault_plan=fault_plan, recovery=self.recovery,
        )


class _FleetRequest:
    """One logical request's live state across its (1 or 2) copies."""

    __slots__ = ("arrival_ms", "qos", "qos_weight", "payload",
                 "primary_fleet", "hedge_fleet", "done", "live_copies")

    def __init__(self, arrival_ms: float, qos: str, qos_weight: float,
                 payload: Any, primary_fleet: int) -> None:
        self.arrival_ms = arrival_ms
        self.qos = qos
        self.qos_weight = qos_weight
        self.payload = payload
        self.primary_fleet = primary_fleet
        self.hedge_fleet: Optional[int] = None
        self.done = False
        self.live_copies = 0  # submitted copies not yet dead-lettered


class FleetRouter:
    """Owns the fleets, the shared clock, the routing policy and the
    request/hedge ledgers. Per-fleet engine seeds derive from ``seed`` so
    one integer reproduces the whole fleet run."""

    def __init__(
        self,
        fleets: Sequence[FleetSpec],
        policy: RoutingPolicy,
        *,
        seed: int = 0,
        hedge_after_ms: Optional[float] = None,
        count_hedge_waste: bool = True,
        breaker: Optional[BreakerConfig] = None,
        shed_when_degraded: bool = False,
        qos_priorities: Optional[dict[str, int]] = None,
    ) -> None:
        """``breaker`` arms one :class:`CircuitBreaker` per fleet, fed by
        the engine's per-attempt fault stream (crashes, cold-start
        failures, probe timeouts, lost completions, request timeouts) and
        by queue-full submit refusals. ``shed_when_degraded`` sheds the
        lowest-priority QoS classes while breakers are OPEN (one priority
        level per OPEN breaker; the highest level never sheds);
        ``qos_priorities`` maps class name → priority (higher = more
        important; unknown classes rank lowest)."""
        fleets = tuple(fleets)
        if not fleets:
            raise ValueError("need at least one FleetSpec")
        names = [f.name for f in fleets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fleet names: {names}")
        if hedge_after_ms is not None and hedge_after_ms <= 0.0:
            raise ValueError("hedge_after_ms must be > 0")
        if shed_when_degraded and breaker is None:
            raise ValueError(
                "shed_when_degraded needs a breaker config (shedding is "
                "keyed on OPEN breakers)")
        self.clock = SimClock()
        self.fleets = fleets
        self.policy = policy
        self.rng = np.random.RandomState(seed)  # routing draws only
        self.engines = tuple(
            f.build(seed=seed * 7919 + 101 * i + 1, clock=self.clock)
            for i, f in enumerate(fleets))
        self.telemetry = FleetTelemetry(
            (e.telemetry for e in self.engines), names)
        self.hedge_after_ms = hedge_after_ms
        self.count_hedge_waste = count_hedge_waste
        # -- failure resilience (DESIGN.md §15) --------------------------
        self.shed_when_degraded = shed_when_degraded
        self.qos_priorities = dict(qos_priorities or {})
        self.breakers: Optional[tuple[CircuitBreaker, ...]] = None
        if breaker is not None:
            self.breakers = tuple(CircuitBreaker(breaker) for _ in fleets)
            for i, e in enumerate(self.engines):
                e.fault_listener = (
                    lambda kind, inv, i=i: self._on_engine_fault(i, kind))
        # -- logical ledger (one entry per arrival) ----------------------
        self.n_arrived = 0
        self.n_dropped = 0          # primary copy refused at the fleet queue
        self._open_logical = 0      # submitted, neither won nor dropped
        self.n_rejected = 0         # never submitted: shed + breaker-rejected
        self.n_shed = 0             # rejected by QoS degradation
        self.n_breaker_rejected = 0  # rejected with every breaker open
        self.shed_by_class: dict[str, int] = {}
        self.n_dead_lettered = 0    # logical requests whose copies all died
        # -- hedge ledger (secondary copies) -----------------------------
        self.n_hedges = 0           # hedge submits attempted
        self.n_hedge_dropped = 0    # hedge copies refused at the queue
        self.n_hedge_wins = 0       # logical wins served by the hedge copy
        self.n_hedge_cancelled = 0  # loser copies that ran to completion
        self.n_hedge_dead_lettered = 0  # surplus copy dead-letters
        self.hedge_waste_cost = 0.0
        # -- winner results (exactly one per completed logical request) --
        self.results: List[RequestResult] = []
        self.result_fleets: List[int] = []
        self.result_classes: List[str] = []

    # ------------------------------------------------------------------
    @property
    def n_completed(self) -> int:
        return len(self.results)

    @property
    def total_cost(self) -> float:
        """Σ engine cost — honest by default: hedge losers stay billed.
        ``count_hedge_waste=False`` subtracts the measured loser cost
        (the idealized cancel-on-win accounting)."""
        total = sum(e.cost.total for e in self.engines)
        if not self.count_hedge_waste:
            total -= self.hedge_waste_cost
        return total

    def _route(self, arrival_ms: float, qos: str,
               exclude: Optional[int] = None) -> int:
        idx = int(self.policy.route(RouteContext(
            telemetry=self.telemetry, rng=self.rng,
            arrival_ms=arrival_ms, qos=qos, exclude=exclude)))
        if not 0 <= idx < len(self.engines):
            raise ValueError(
                f"policy {self.policy.name!r} routed to fleet {idx} "
                f"of {len(self.engines)}")
        return idx

    # -- failure resilience (DESIGN.md §15) ----------------------------
    def _on_engine_fault(self, fleet_idx: int, kind: str) -> None:
        """Per-attempt fault feed from engine ``fleet_idx`` (the engine's
        ``fault_listener`` hook; gate terminations never fire it)."""
        if self.breakers is not None:
            self.breakers[fleet_idx].record_failure(self.clock.now)

    def _should_shed(self, qos: str) -> bool:
        """Graceful degradation: with k breakers OPEN, shed the k lowest
        of the configured priority levels (the top level never sheds)."""
        if not self.shed_when_degraded or self.breakers is None:
            return False
        n_open = sum(1 for b in self.breakers
                     if b.state is BreakerState.OPEN)
        if n_open == 0:
            return False
        levels = sorted(set(self.qos_priorities.values()))
        if len(levels) < 2:
            return False  # one class of traffic: nothing lower to shed
        shed_levels = set(levels[:min(n_open, len(levels) - 1)])
        return self.qos_priorities.get(qos, levels[0]) in shed_levels

    def _route_resilient(self, arrival_ms: float, qos: str,
                         exclude: Optional[int] = None) -> Optional[int]:
        """Policy route + breaker gating: fail over through the policy's
        ``exclude`` re-route, then a deterministic first-allowing scan;
        None when every breaker rejects."""
        if self.breakers is None:
            return self._route(arrival_ms, qos, exclude=exclude)
        now = self.clock.now
        idx = self._route(arrival_ms, qos, exclude=exclude)
        if self.breakers[idx].allow(now):
            self.breakers[idx].on_route(now)
            return idx
        if exclude is None and len(self.engines) > 1:
            alt = self._route(arrival_ms, qos, exclude=idx)
            if alt != idx and self.breakers[alt].allow(now):
                self.breakers[alt].on_route(now)
                return alt
        for j in range(len(self.engines)):
            if j != exclude and self.breakers[j].allow(now):
                self.breakers[j].on_route(now)
                return j
        return None

    def offer(self, payload: Any, qos: str = "default",
              qos_weight: float = 1.0) -> None:
        """Route and submit one arrival at the current clock time."""
        now = self.clock.now
        self.n_arrived += 1
        if self._should_shed(qos):
            self.n_rejected += 1
            self.n_shed += 1
            self.shed_by_class[qos] = self.shed_by_class.get(qos, 0) + 1
            return
        idx = self._route_resilient(now, qos)
        if idx is None:
            # every fleet's breaker rejects: fail fast, never submitted
            self.n_rejected += 1
            self.n_breaker_rejected += 1
            return
        req = _FleetRequest(now, qos, qos_weight, payload, idx)
        ok = self.engines[idx].submit(
            payload,
            lambda res, req=req, i=idx: self._complete(req, i, res),
            submitted_at_ms=now, qos=qos, qos_weight=qos_weight,
            on_dead_letter=lambda inv, req=req, i=idx:
                self._copy_dead(req, i))
        if not ok:
            # finite fleet queue refused the primary copy — a logical drop
            # (deliberate omission: no re-route; DESIGN.md §14). An
            # overloaded/throttled fleet is a health signal the breaker
            # should see.
            self.n_dropped += 1
            if self.breakers is not None:
                self.breakers[idx].record_failure(now)
            return
        self._open_logical += 1
        req.live_copies = 1
        if self.hedge_after_ms is not None and len(self.engines) > 1:
            self.clock.after(self.hedge_after_ms,
                             lambda req=req: self._maybe_hedge(req))

    def _maybe_hedge(self, req: _FleetRequest) -> None:
        if req.done or req.hedge_fleet is not None:
            return
        idx = self._route_resilient(
            self.clock.now, req.qos, exclude=req.primary_fleet)
        if idx is None or idx == req.primary_fleet:
            return  # the policy declined to diversify (or breakers reject)
        self.n_hedges += 1
        ok = self.engines[idx].submit(
            req.payload,
            lambda res, req=req, i=idx: self._complete(req, i, res),
            submitted_at_ms=req.arrival_ms, qos=req.qos,
            qos_weight=req.qos_weight,
            on_dead_letter=lambda inv, req=req, i=idx:
                self._copy_dead(req, i))
        if not ok:
            self.n_hedge_dropped += 1
            if self.breakers is not None:
                self.breakers[idx].record_failure(self.clock.now)
            return
        req.hedge_fleet = idx
        req.live_copies += 1

    def _copy_dead(self, req: _FleetRequest, fleet_idx: int) -> None:
        """One submitted copy dead-lettered inside engine ``fleet_idx``.
        The logical request closes only when its LAST live copy dies —
        a hedge twin may still win (first-completion-wins unchanged)."""
        req.live_copies -= 1
        if req.done:
            # the logical request already completed; this was the loser
            self.n_hedge_dead_lettered += 1
            return
        if req.live_copies <= 0:
            req.done = True
            self._open_logical -= 1
            self.n_dead_lettered += 1
        else:
            self.n_hedge_dead_lettered += 1

    def _complete(self, req: _FleetRequest, fleet_idx: int,
                  res: RequestResult) -> None:
        if not req.done:
            # first copy home wins: counted exactly once in latency
            req.done = True
            self._open_logical -= 1
            if fleet_idx == req.hedge_fleet:
                self.n_hedge_wins += 1
            self.results.append(res)
            self.result_fleets.append(fleet_idx)
            self.result_classes.append(req.qos)
        else:
            # the losing copy: latency discarded, cost already billed by
            # the engine that served it — record the waste explicitly
            self.n_hedge_cancelled += 1
            pricing = self.engines[fleet_idx].pricing
            self.hedge_waste_cost += (
                pricing.cost_per_invocation
                + pricing.cost_per_ms * (res.download_ms + res.analysis_ms))
        if self.breakers is not None:
            # winner or loser, the ENGINE served it: a health success
            self.breakers[fleet_idx].record_success(self.clock.now)
        self.policy.on_result(fleet_idx, res, self.telemetry)

    # ------------------------------------------------------------------
    def per_fleet_counts(self) -> dict[str, tuple]:
        """The copies-level ledger the conservation check consumes.
        ``parked`` is measured (queue + in flight), not a residual."""
        return {
            "per_fleet_arrived": tuple(
                e.requests_arrived for e in self.engines),
            "per_fleet_completed": tuple(
                len(e.results) for e in self.engines),
            "per_fleet_dropped": tuple(
                e.requests_dropped for e in self.engines),
            "per_fleet_dead_lettered": tuple(
                e.requests_dead_lettered for e in self.engines),
            "per_fleet_parked": tuple(
                len(e.queue) + e.pool.total_in_flight
                - e._zombie_executions
                for e in self.engines),
        }

    def check_conservation(self) -> None:
        """Cross-check every ledger (raises SanitizerError on violation);
        callable unconditionally — run_fleet_open_loop invokes it when
        the sanitizer env gate is armed."""
        _sanitizer.check_fleet_conservation(
            n_arrived=self.n_arrived,
            n_completed=self.n_completed,
            n_dropped=self.n_dropped,
            n_pending=self._open_logical,
            n_hedges=self.n_hedges,
            n_hedge_dropped=self.n_hedge_dropped,
            n_hedge_cancelled=self.n_hedge_cancelled,
            n_rejected=self.n_rejected,
            n_dead_lettered=self.n_dead_lettered,
            n_hedge_dead_lettered=self.n_hedge_dead_lettered,
            **self.per_fleet_counts(),
        )
        for e in self.engines:
            _sanitizer.check_fault_ledger(e, where="fleet")


@dataclasses.dataclass
class FleetRunResult:
    """One fleet run: winner-level results plus both ledgers."""

    results: List[RequestResult]
    result_fleets: List[int]
    result_classes: List[str]
    n_arrived: int
    n_dropped: int
    n_pending_at_end: int
    n_hedges: int
    n_hedge_dropped: int
    n_hedge_wins: int
    n_hedge_cancelled: int
    hedge_waste_cost: float
    total_cost: float
    duration_ms: float
    process_name: str
    fleet_names: tuple[str, ...]
    per_fleet: dict[str, tuple]
    # -- failure resilience (DESIGN.md §15); zeros when no faults armed --
    n_rejected: int = 0          # shed or breaker-rejected (never submitted)
    n_shed: int = 0
    n_breaker_rejected: int = 0
    n_dead_lettered: int = 0     # logical requests whose last copy died
    n_hedge_dead_lettered: int = 0
    breaker_opens: tuple[int, ...] = ()
    shed_by_class: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def n_completed(self) -> int:
        return len(self.results)

    @property
    def drop_rate(self) -> float:
        return self.n_dropped / max(self.n_arrived, 1)


def run_fleet_open_loop(
    router: FleetRouter,
    process: ArrivalProcess,
    *,
    rng: np.random.RandomState,
    duration_ms: float,
    qos_classes: Optional[Sequence[QoSClass]] = None,
    payload_fn: Optional[Callable[[int, str], Any]] = None,
    drain: bool = True,
    drain_limit_ms: Optional[float] = None,
) -> FleetRunResult:
    """Drive the router's fleets with one open-loop arrival stream.

    Arrival times and QoS class draws come from ``rng`` (the traffic
    realization); routing randomness comes from the router's own seeded
    RNG — so the same traffic can be replayed against different policies.
    With ``drain`` the clock runs past the horizon until in-flight work
    finishes (``drain_limit_ms`` bounds a backlog that cannot drain).
    """
    if duration_ms <= 0.0:
        raise ValueError("duration_ms must be > 0")
    times = arrival_times_ms(process, rng, duration_ms)
    if qos_classes:
        cls_idx = draw_classes(rng, len(times), qos_classes)
        names = [qos_classes[i].name for i in cls_idx]
        weights = [qos_classes[i].weight for i in cls_idx]
    else:
        names = ["default"] * len(times)
        weights = [1.0] * len(times)

    for i, (t, qos, w) in enumerate(zip(times, names, weights)):
        payload = payload_fn(i, qos) if payload_fn is not None else {"qos": qos}
        router.clock.at(
            float(t),
            lambda payload=payload, qos=qos, w=w:
                router.offer(payload, qos=qos, qos_weight=w))

    router.clock.run_until(duration_ms)
    if drain:
        limit = (duration_ms + 20 * 60 * 1000.0
                 if drain_limit_ms is None else duration_ms + drain_limit_ms)
        router.clock.run_all(hard_limit_ms=limit)

    if _sanitizer.enabled():
        router.check_conservation()

    return FleetRunResult(
        results=list(router.results),
        result_fleets=list(router.result_fleets),
        result_classes=list(router.result_classes),
        n_arrived=router.n_arrived,
        n_dropped=router.n_dropped,
        n_pending_at_end=router._open_logical,
        n_hedges=router.n_hedges,
        n_hedge_dropped=router.n_hedge_dropped,
        n_hedge_wins=router.n_hedge_wins,
        n_hedge_cancelled=router.n_hedge_cancelled,
        hedge_waste_cost=router.hedge_waste_cost,
        total_cost=router.total_cost,
        duration_ms=duration_ms,
        process_name=process.name,
        fleet_names=router.telemetry.names,
        per_fleet=router.per_fleet_counts(),
        n_rejected=router.n_rejected,
        n_shed=router.n_shed,
        n_breaker_rejected=router.n_breaker_rejected,
        n_dead_lettered=router.n_dead_lettered,
        n_hedge_dead_lettered=router.n_hedge_dead_lettered,
        breaker_opens=(tuple(b.n_opens for b in router.breakers)
                       if router.breakers is not None else ()),
        shed_by_class=dict(router.shed_by_class),
    )


__all__ = [
    "FleetRouter",
    "FleetRunResult",
    "FleetSpec",
    "run_fleet_open_loop",
]
