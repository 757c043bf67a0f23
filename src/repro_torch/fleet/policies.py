"""Fleet routing policies: which Minos-gated fleet serves this request
(DESIGN.md §14).

The :class:`~repro_torch.fleet.router.FleetRouter` owns N engines and one
request stream; every arrival (and every hedge attempt) flows through a
:class:`RoutingPolicy` — the faas-offloading-sim policy ladder (SNIPPETS
§2) lifted onto per-fleet :class:`~repro_torch.core.control.FleetTelemetry`:

* :class:`RandomRoutingPolicy` — uniform over fleets (the floor);
* :class:`WeightedStaticRoutingPolicy` — fixed split probabilities; a
  one-hot weight vector is the static single-fleet baseline;
* :class:`GreedyRoutingPolicy` — argmin expected response time from live
  telemetry (queue depth, capacity slots, Welford body means, cold-start
  penalty for an empty pool);
* :class:`ProbabilisticRoutingPolicy` — per-fleet split probabilities
  re-solved every ``update_interval_ms`` from an EMA-tracked arrival rate
  and per-fleet certified-speed quantiles / unit-speed body estimates; the
  split LP runs via scipy when available, with a closed-form waterfilling
  fallback (:func:`solve_split`) that provably coincides with it.

Routing policies obey the same purity contract as controllers (analysis
rule R3, extended to ``*RoutingPolicy`` classes): they read the
:class:`~repro_torch.core.control.FleetTelemetry` view and return a fleet
index; submits, hedges, billing and every other side effect stay with the
router. A policy never stores the telemetry view — it arrives on each
:class:`RouteContext`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.control import FleetTelemetry
from repro_torch.core.estimators import EMA, Welford

try:  # optional dependency: never required, only preferred (DESIGN.md §14)
    from scipy.optimize import linprog as _linprog
except ImportError:  # pragma: no cover - scipy present in the dev container
    _linprog = None


@dataclasses.dataclass(frozen=True)
class RouteContext:
    """One routing decision's inputs.

    ``exclude`` is the hedging hook: when the router duplicates a
    straggling request it re-routes with the primary fleet excluded; a
    policy that still answers the excluded index declines to hedge."""

    telemetry: FleetTelemetry
    rng: np.random.RandomState
    arrival_ms: float
    qos: str = "default"
    exclude: Optional[int] = None


@runtime_checkable
class RoutingPolicy(Protocol):
    """What the router calls. Same shape discipline as
    :class:`~repro_torch.core.control.Controller`: decisions out, no side
    effects on engines/telemetry (rule R3)."""

    name: str

    def route(self, ctx: RouteContext) -> int: ...

    def on_result(self, fleet_index: int, result: Any,
                  telemetry: FleetTelemetry) -> None: ...


class RoutingPolicyBase:
    """Default plumbing: a no-op result feed and the candidate-set helper
    honoring ``RouteContext.exclude``."""

    name = "routing-policy"

    def on_result(self, fleet_index: int, result: Any,
                  telemetry: FleetTelemetry) -> None:
        return None

    @staticmethod
    def _candidates(ctx: RouteContext) -> list[int]:
        n = len(ctx.telemetry)
        cand = [i for i in range(n) if i != ctx.exclude]
        return cand if cand else list(range(n))


class RandomRoutingPolicy(RoutingPolicyBase):
    """Uniform random fleet choice — the baseline every informed policy
    must beat (acceptance bar: greedy never loses to this)."""

    def __init__(self) -> None:
        self.name = "random"

    def route(self, ctx: RouteContext) -> int:
        cand = self._candidates(ctx)
        return cand[int(ctx.rng.randint(len(cand)))]


class WeightedStaticRoutingPolicy(RoutingPolicyBase):
    """Fixed split probabilities proportional to ``weights``.

    ``one_hot(k, n)`` weights make this the static single-fleet
    assignment — the baseline the probabilistic policy is judged against
    in benchmarks/fleet_sweep.py."""

    def __init__(self, weights: Sequence[float]) -> None:
        w = np.asarray(list(weights), float)
        if w.size == 0 or np.any(w < 0.0) or w.sum() <= 0.0:
            raise ValueError("weights must be non-negative with positive sum")
        self.weights = w / w.sum()
        self.name = "weighted-static"

    @staticmethod
    def one_hot(index: int, n_fleets: int) -> "WeightedStaticRoutingPolicy":
        if not 0 <= index < n_fleets:
            raise ValueError("index out of range")
        w = np.zeros(n_fleets)
        w[index] = 1.0
        p = WeightedStaticRoutingPolicy(w)
        p.name = f"static[{index}]"
        return p

    def route(self, ctx: RouteContext) -> int:
        n = len(ctx.telemetry)
        if self.weights.size != n:
            raise ValueError(
                f"{self.weights.size} weights for {n} fleets")
        p = self.weights.copy()
        if ctx.exclude is not None and 0 <= ctx.exclude < n:
            p[ctx.exclude] = 0.0
            if p.sum() <= 0.0:  # excluded the only weighted fleet
                cand = self._candidates(ctx)
                return cand[int(ctx.rng.randint(len(cand)))]
            p /= p.sum()
        return int(ctx.rng.choice(n, p=p))


class GreedyRoutingPolicy(RoutingPolicyBase):
    """Argmin expected response time, from live telemetry only.

    Per fleet: expected service time = the engine's Welford body mean
    (``prior_serve_ms`` until it exists), expected wait = backlog (queue
    depth + in flight) × service time / capacity slots, plus the profile's
    cold-start latency when no warm instance is available. Deterministic:
    draws nothing, ties break toward the lowest fleet index."""

    def __init__(self, prior_serve_ms: float = 1500.0) -> None:
        if prior_serve_ms <= 0.0:
            raise ValueError("prior_serve_ms must be > 0")
        self.name = "greedy"
        self.prior_serve_ms = prior_serve_ms

    def _score(self, ctx: RouteContext, i: int, slots: int) -> float:
        view = ctx.telemetry.fleet(i)
        serve = view.body_mean_ms
        if not np.isfinite(serve) or serve <= 0.0:
            serve = self.prior_serve_ms
        backlog = view.queue_depth + view.total_in_flight
        wait = backlog * serve / max(slots, 1)
        cold = 0.0 if view.pool_available > 0 else view.knobs.cold_start_ms
        return wait + cold + serve

    def route(self, ctx: RouteContext) -> int:
        slots = ctx.telemetry.capacity_slots()
        best, best_score = -1, np.inf
        for i in self._candidates(ctx):
            score = self._score(ctx, i, slots[i])
            if score < best_score:
                best, best_score = i, score
        return best


def solve_split(
    serve_costs: Sequence[float],
    caps: Sequence[float],
    *,
    solver: str = "auto",
) -> tuple[np.ndarray, str]:
    """Split probabilities minimizing expected service time under
    per-fleet capacity caps::

        min Σ c_i·p_i   s.t.   Σ p_i = 1,   0 ≤ p_i ≤ cap_i

    where ``c_i`` is fleet i's expected per-request service time and
    ``cap_i`` the fraction of the offered rate it can absorb at the
    target utilization. This is a continuous knapsack, so the LP's
    optimum IS the closed-form waterfill — fill fleets in ascending cost
    order up to their caps (tested equal in tests/test_fleet.py); scipy
    is an implementation choice, never a requirement. When Σ cap < 1 the
    offered load exceeds total capacity: every fleet saturates and the
    split is capacity-proportional instead (``solver_used='overload'``).

    Returns ``(probs, solver_used)`` with ``solver_used`` one of
    ``lp`` / ``waterfill`` / ``overload`` / ``trivial``.
    """
    if solver not in ("auto", "lp", "waterfill"):
        raise ValueError(f"unknown solver {solver!r}")
    c = np.asarray(list(serve_costs), float)
    cap = np.clip(np.asarray(list(caps), float), 0.0, 1.0)
    n = c.size
    if n == 0 or c.shape != cap.shape:
        raise ValueError("serve_costs and caps must be equal-length, non-empty")
    if n == 1:
        return np.ones(1), "trivial"
    total = float(cap.sum())
    if total < 1.0 - 1e-9:
        if total <= 0.0:
            return np.full(n, 1.0 / n), "overload"
        return cap / total, "overload"
    if solver != "waterfill" and _linprog is not None:
        res = _linprog(c, A_eq=np.ones((1, n)), b_eq=[1.0],
                       bounds=[(0.0, float(u)) for u in cap])
        if getattr(res, "status", 1) == 0 and res.x is not None:
            p = np.clip(np.asarray(res.x, float), 0.0, None)
            return p / p.sum(), "lp"
    p = np.zeros(n)
    remaining = 1.0
    for i in sorted(range(n), key=lambda j: (c[j], j)):
        take = min(float(cap[i]), remaining)
        p[i] = take
        remaining -= take
        if remaining <= 1e-12:
            break
    return p / p.sum(), "waterfill"


class ProbabilisticRoutingPolicy(RoutingPolicyBase):
    """Periodically re-solved probabilistic split (faas-offloading-sim's
    ``probabilistic`` policy, SNIPPETS §2, at fleet granularity).

    State it maintains (all per-instance, rule R3):

    * an EMA of inter-arrival times (``arrival_alpha``) → offered rate λ;
    * per-fleet Welford estimates of the *unit-speed* body time, fed by
      ``on_result`` as ``analysis_ms × instance_speed`` (undoing the
      serving instance's speed so the estimate is fleet-portable);
    * the current split probabilities, re-solved at most every
      ``update_interval_ms`` via :func:`solve_split` with per-fleet
      expected service time ``unit_mean / certified-speed quantile`` and
      capacity cap ``utilization × slots / (serve × λ)``.

    Until the first solve (or while λ is unknown) the split is uniform.
    """

    def __init__(
        self,
        *,
        update_interval_ms: float = 5_000.0,
        arrival_alpha: float = 0.25,
        utilization: float = 0.9,
        speed_quantile: float = 0.5,
        prior_unit_ms: float = 1500.0,
        solver: str = "auto",
    ) -> None:
        if update_interval_ms <= 0.0:
            raise ValueError("update_interval_ms must be > 0")
        if not 0.0 < arrival_alpha <= 1.0:
            raise ValueError("arrival_alpha must be in (0,1]")
        if not 0.0 < utilization <= 1.0:
            raise ValueError("utilization must be in (0,1]")
        if not 0.0 <= speed_quantile <= 1.0:
            raise ValueError("speed_quantile must be in [0,1]")
        if solver not in ("auto", "lp", "waterfill"):
            raise ValueError(f"unknown solver {solver!r}")
        self.name = f"probabilistic[{solver}]" if solver != "auto" \
            else "probabilistic"
        self.update_interval_ms = update_interval_ms
        self.utilization = utilization
        self.speed_quantile = speed_quantile
        self.prior_unit_ms = prior_unit_ms
        self.solver = solver
        self._iat_ema = EMA(arrival_alpha, None)
        self._last_arrival_ms: Optional[float] = None
        self._unit_stats: list[Welford] = []
        self.probs: Optional[np.ndarray] = None
        self._last_solve_ms: Optional[float] = None
        self.n_solves = 0
        self.solver_used = "none"

    def _ensure(self, n: int) -> None:
        if len(self._unit_stats) != n:
            self._unit_stats = [Welford() for _ in range(n)]
            self.probs = None
            self._last_solve_ms = None

    def on_result(self, fleet_index: int, result: Any,
                  telemetry: FleetTelemetry) -> None:
        self._ensure(len(telemetry))
        # analysis_ms was divided by the serving instance's speed; undo it
        # so the Welford tracks the fleet-portable unit-speed body time
        self._unit_stats[fleet_index].update(
            result.analysis_ms * result.instance_speed)

    def _serve_ms(self, t: FleetTelemetry, i: int) -> float:
        stats = self._unit_stats[i]
        unit = stats.mean if stats.count else self.prior_unit_ms
        speed = t.fleet(i).pool_speed_quantile(self.speed_quantile)
        if not np.isfinite(speed) or speed <= 0.0:
            speed = 1.0
        return unit / speed

    def _resolve(self, t: FleetTelemetry) -> np.ndarray:
        n = len(t)
        iat = self._iat_ema.value
        if iat is None or iat <= 0.0:
            return np.full(n, 1.0 / n)
        lam = 1.0 / iat  # arrivals per ms
        serve = np.asarray([self._serve_ms(t, i) for i in range(n)])
        slots = np.asarray(t.capacity_slots(), float)
        mu = slots / np.maximum(serve, 1e-9)  # per-fleet service rate (1/ms)
        caps = self.utilization * mu / lam
        probs, used = solve_split(serve, caps, solver=self.solver)
        self.n_solves += 1
        self.solver_used = used
        return probs

    def route(self, ctx: RouteContext) -> int:
        t = ctx.telemetry
        n = len(t)
        self._ensure(n)
        if ctx.exclude is None:
            # hedge re-routes are duplicates, not offered load: only real
            # arrivals feed the rate estimate
            if self._last_arrival_ms is not None:
                self._iat_ema.update(
                    max(ctx.arrival_ms - self._last_arrival_ms, 1e-6))
            self._last_arrival_ms = ctx.arrival_ms
        if self.probs is None or self._last_solve_ms is None or \
                ctx.arrival_ms - self._last_solve_ms >= self.update_interval_ms:
            self.probs = self._resolve(t)
            self._last_solve_ms = ctx.arrival_ms
        p = np.asarray(self.probs, float).copy()
        if ctx.exclude is not None and 0 <= ctx.exclude < n:
            p[ctx.exclude] = 0.0
        total = p.sum()
        if total <= 0.0:
            cand = self._candidates(ctx)
            return cand[int(ctx.rng.randint(len(cand)))]
        return int(ctx.rng.choice(n, p=p / total))


__all__ = [
    "GreedyRoutingPolicy",
    "ProbabilisticRoutingPolicy",
    "RandomRoutingPolicy",
    "RouteContext",
    "RoutingPolicy",
    "RoutingPolicyBase",
    "WeightedStaticRoutingPolicy",
    "solve_split",
]
