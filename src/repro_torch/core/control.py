"""The control-plane API: one ``Controller`` surface for every Minos
decision (DESIGN.md §10).

Minos is a *decision loop* — benchmark an instance, keep it or crash it,
and let the warm pool compound the gains (paper §III–IV). Before this
module the loop's decisions were smeared across five surfaces
(``ElysiumGate.judge``, the two policies, ``OnlineElysiumController``,
static ``Stage.max_in_flight`` and the ``gate_load_aware`` knob), which is
why every ROADMAP item that needed a new decision — adaptive pass
fraction, queue-aware admission, re-probing under drift — had no place to
live. Now the :class:`~repro_torch.core.substrate.SubstrateEngine` (and the
workflow layer's admission path) calls exactly one interface:

* :meth:`Controller.on_cold_start` → :class:`ProbeDecision` — benchmark a
  fresh instance, or accept it unjudged (baseline arm, emergency exit);
* :meth:`Controller.on_probe` → :class:`~repro_torch.core.policy.Verdict` — the
  elysium gate: judge a probe observation (cold, or a warm re-probe);
* :meth:`Controller.on_reuse` → :class:`ReuseDecision` — on warm reuse:
  keep serving, re-probe the drifted certification, or retire the
  instance (the drift-recovery hook, ROADMAP: re-probing under drift);
* :meth:`Controller.on_admit` → :class:`AdmitDecision` — per-stage
  admission back-pressure (``Stage.max_in_flight`` is now just the static
  special case);
* :meth:`Controller.on_release` — a request completed; estimator feedback.

Every decision point receives a context carrying a read-only
:class:`Telemetry` view of the live engine: pool load/occupancy, queue
depth, the clock, and Welford reuse-rate / probe / body estimates the
engine maintains — everything a policy needs to close its loop online,
nothing it could corrupt.

The old surfaces survive as thin adapters: :class:`ClassicMinosController`
wraps an :class:`ElysiumGate` (policy + optional
:class:`~repro_torch.core.elysium.OnlineElysiumController`) and reproduces the
pre-control-plane behavior bit-identically (the seeded golden digests in
tests/test_unified_substrate.py run through it). On top, three concrete
controllers close ROADMAP open items: :class:`PassFractionController`
(live Welford estimates → ``optimal_pass_fraction`` → threshold),
:class:`QueueAwareAdmissionController` (dynamic per-stage admission from
queue depth / pool occupancy) and :class:`ReprobeController` (cheap warm
re-benchmark once the certified speed's drift half-life expires).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from enum import Enum
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np

from .elysium import optimal_pass_fraction
from .estimators import EMA
from .lifecycle import FunctionInstance
from .policy import Verdict


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------


class ProbeDecision(Enum):
    """What to do with a freshly placed (cold) instance."""

    PROBE = "probe"  # run the benchmark, then judge at on_probe
    SKIP = "skip"    # accept without benchmarking (baseline / emergency exit)


class ReuseDecision(Enum):
    """What to do with a warm instance about to serve a reused request."""

    KEEP = "keep"        # paper §II-B: reuse without re-benchmarking
    REPROBE = "reprobe"  # re-benchmark the (possibly drifted) certification
    RETIRE = "retire"    # despawn gracefully; the request cold-starts instead


class AdmitDecision(Enum):
    """Whether a workflow item may enter a stage now."""

    ADMIT = "admit"
    DEFER = "defer"  # wait at the admission queue (back-pressure)


class FailureDecision(Enum):
    """What to do with a request whose dispatch attempt failed (platform
    fault: crash / cold-start failure / probe timeout / lost completion /
    per-request timeout — DESIGN.md §15)."""

    RETRY = "retry"              # re-queue (engine applies backoff)
    DEAD_LETTER = "dead_letter"  # terminal: stop retrying, count + surface


# ---------------------------------------------------------------------------
# Telemetry — the read-only view every decision point receives
# ---------------------------------------------------------------------------


class Telemetry:
    """Live, read-only view of one engine's observable state.

    Not a snapshot: every property reads through to the engine at call
    time, so a controller asking mid-run sees exactly what
    ``InstancePool.load`` / ``total_in_flight`` / ``len(queue)`` would
    report (tested in tests/test_control_plane.py). Mutation raises —
    controllers decide, engines act.
    """

    __slots__ = ("_engine",)

    def __init__(self, engine: Any) -> None:
        object.__setattr__(self, "_engine", engine)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Telemetry is read-only")

    def __delattr__(self, name: str) -> None:
        raise AttributeError("Telemetry is read-only")

    # -- clock / hosting -------------------------------------------------
    @property
    def now_ms(self) -> float:
        return self._engine.loop.now

    @property
    def knobs(self):
        """The engine's (frozen) :class:`~repro_torch.core.substrate.SubstrateKnobs`."""
        return self._engine.knobs

    # -- pool ------------------------------------------------------------
    @property
    def pool_available(self) -> int:
        """Warm instances with spare request capacity."""
        return len(self._engine.pool)

    @property
    def pool_instances(self) -> int:
        """Live instances (available + at-capacity serving ones)."""
        return self._engine.pool.n_instances

    @property
    def total_in_flight(self) -> int:
        return self._engine.pool.total_in_flight

    @property
    def mean_load(self) -> float:
        return self._engine.pool.mean_load()

    @property
    def pool_speeds(self) -> tuple[float, ...]:
        """Certified speeds of pooled instances — the pool's cached
        immutable view (no per-read list rebuild; PR 5)."""
        return self._engine.pool.speeds_view()

    @property
    def pool_warm(self) -> int:
        """Pooled WARM instances (len of :attr:`pool_speeds`, O(1))."""
        return self._engine.pool.n_warm

    def pool_speed_quantile(self, q: float) -> float:
        """q-quantile of the pooled certified speeds (nan when empty) —
        what a gate needs instead of the full speeds list."""
        return self._engine.pool.certified_speed_quantile(q)

    def instance_load(self, inst: FunctionInstance) -> int:
        return self._engine.pool.load(inst)

    # -- queue -----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Invocations waiting on the engine's own queue (requeues incl.)."""
        return len(self._engine.queue)

    # -- open-loop pressure (DESIGN.md §12) ------------------------------
    @property
    def n_arrived(self) -> int:
        """Requests submitted to the engine (accepted + dropped)."""
        return getattr(self._engine, "requests_arrived", 0)

    @property
    def n_dropped(self) -> int:
        """Requests refused at submit because the finite queue
        (``SubstrateKnobs.queue_capacity``) was full."""
        return getattr(self._engine, "requests_dropped", 0)

    # -- platform faults (DESIGN.md §15) ---------------------------------
    @property
    def n_failures(self) -> int:
        """Failed dispatch attempts (crashes, cold-start failures, probe
        timeouts, lost completions, request timeouts) — per-attempt, so a
        request retried twice counts twice."""
        counts = getattr(self._engine, "fault_counts", None)
        return sum(counts.values()) if counts else 0

    @property
    def failure_rate(self) -> float:
        """Failed fraction of finished dispatch attempts (Welford mean of
        the engine's failure indicator stream; 0.0 before any attempt)."""
        s = getattr(self._engine, "failure_stats", None)
        return s.mean if s is not None and s.count else 0.0

    @property
    def n_dead_lettered(self) -> int:
        """Requests that exhausted their attempt budget (terminal)."""
        return getattr(self._engine, "requests_dead_lettered", 0)

    # -- streaming estimates (Welford; maintained by the engine) ---------
    @property
    def n_probes(self) -> int:
        """Cold-start probes observed (warm re-probes excluded)."""
        return self._engine.probe_stats.count

    @property
    def probe_mean_ms(self) -> float:
        s = self._engine.probe_stats
        return s.mean if s.count else float("nan")

    @property
    def probe_std_ms(self) -> float:
        return self._engine.probe_stats.std

    @property
    def probe_log_mean(self) -> float:
        s = self._engine.log_probe_stats
        return s.mean if s.count else float("nan")

    @property
    def probe_log_std(self) -> float:
        """Std of log probe durations ≈ the speed distribution's lognormal
        sigma (plus observation noise) — what the §II-A trade-off needs."""
        return self._engine.log_probe_stats.std

    @property
    def n_requests(self) -> int:
        """Requests completed so far."""
        return self._engine.reuse_stats.count

    @property
    def reuse_rate(self) -> float:
        """Fraction of completed requests served by a warm (reused)
        instance — the live estimate of how often certification pays."""
        s = self._engine.reuse_stats
        return s.mean if s.count else 0.0

    @property
    def expected_reuses(self) -> float:
        """Expected serves per pooled instance beyond its first,
        ≈ r/(1−r) for reuse rate r (geometric reuse chain)."""
        r = min(self.reuse_rate, 0.98)
        return r / (1.0 - r)

    @property
    def body_mean_ms(self) -> float:
        s = self._engine.body_stats
        return s.mean if s.count else float("nan")


class FleetTelemetry:
    """Read-only view over N engines' :class:`Telemetry` views — what a
    fleet-level :class:`~repro_torch.fleet.policies.RoutingPolicy` receives
    (DESIGN.md §14).

    Same contract as :class:`Telemetry`, one level up: every read flows
    through the per-fleet views to the live engines (no snapshots), and
    mutation raises — routing policies decide, the
    :class:`~repro_torch.fleet.router.FleetRouter` acts. Aggregates are plain
    per-fleet tuples so a policy can score fleets without ever touching an
    engine handle.
    """

    __slots__ = ("_views", "_names")

    def __init__(self, views: Any, names: Optional[Any] = None) -> None:
        views = tuple(views)
        if not views:
            raise ValueError("FleetTelemetry needs at least one fleet view")
        if names is None:
            names = tuple(f"fleet{i}" for i in range(len(views)))
        else:
            names = tuple(names)
            if len(names) != len(views):
                raise ValueError("names/views length mismatch")
        object.__setattr__(self, "_views", views)
        object.__setattr__(self, "_names", names)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("FleetTelemetry is read-only")

    def __delattr__(self, name: str) -> None:
        raise AttributeError("FleetTelemetry is read-only")

    def __len__(self) -> int:
        return len(self._views)

    def __iter__(self):
        return iter(self._views)

    @property
    def names(self) -> tuple[str, ...]:
        return self._names

    def fleet(self, i: int) -> Telemetry:
        """The i-th fleet's own read-only view."""
        return self._views[i]

    # -- clock (the router runs every fleet on ONE SimClock) -------------
    @property
    def now_ms(self) -> float:
        return self._views[0].now_ms

    # -- per-fleet aggregate tuples (policy scoring inputs) --------------
    def queue_depths(self) -> tuple[int, ...]:
        return tuple(v.queue_depth for v in self._views)

    def in_flights(self) -> tuple[int, ...]:
        return tuple(v.total_in_flight for v in self._views)

    def pool_availables(self) -> tuple[int, ...]:
        return tuple(v.pool_available for v in self._views)

    def capacity_slots(self) -> tuple[int, ...]:
        """Concurrent-request slots each fleet can hold: the autoscaling
        cap × per-instance concurrency when ``max_instances`` is set, else
        the live instance count (elastic supply; floored at 1 slot so an
        idle uncapped fleet still scores as able to serve)."""
        out = []
        for v in self._views:
            cap = v.knobs.max_instances
            n = cap if cap is not None else max(v.pool_instances, 1)
            out.append(n * v.knobs.per_instance_concurrency)
        return tuple(out)

    # -- fleet-wide totals ------------------------------------------------
    @property
    def total_queue_depth(self) -> int:
        return sum(self.queue_depths())

    @property
    def total_in_flight(self) -> int:
        return sum(self.in_flights())


# ---------------------------------------------------------------------------
# Decision contexts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColdStartContext:
    telemetry: Telemetry
    retry_count: int


@dataclasses.dataclass(frozen=True)
class ProbeContext:
    telemetry: Telemetry
    instance: FunctionInstance
    observed_ms: float
    retry_count: int
    is_cold: bool = True  # False: warm re-probe (ReuseDecision.REPROBE)


@dataclasses.dataclass(frozen=True)
class ReuseContext:
    telemetry: Telemetry
    instance: FunctionInstance
    retry_count: int
    age_ms: float
    uses_since_probe: int
    ms_since_probe: Optional[float]  # None: never probed (forced pass)


@dataclasses.dataclass(frozen=True)
class AdmitContext:
    telemetry: Telemetry
    in_flight: int               # items admitted to the stage, not completed
    bound: Optional[int]         # the stage's static max_in_flight (if any)
    admission_queue_depth: int   # items already deferred at admission


@dataclasses.dataclass(frozen=True)
class FailureContext:
    """A dispatch attempt failed (DESIGN.md §15). ``attempts`` counts
    failed attempts so far (>= 1); ``elapsed_ms`` is measured from the
    request's first enqueue. The engine still enforces
    ``RecoveryPolicy.max_attempts`` after the controller answers, so a
    RETRY past the budget dead-letters anyway."""

    telemetry: Telemetry
    kind: str                      # "crash" | "cold_start" | "probe_timeout" | "lost" | "timeout"
    invocation_id: Optional[int]
    attempts: int
    elapsed_ms: float
    qos: str = "default"


@dataclasses.dataclass(frozen=True)
class ReleaseContext:
    telemetry: Telemetry
    result: Any  # the completed RequestResult


#: The six decision points, in request-lifecycle order.
DECISION_POINTS = (
    "on_cold_start", "on_probe", "on_reuse", "on_admit", "on_failure",
    "on_release",
)


# ---------------------------------------------------------------------------
# The Controller protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class Controller(Protocol):
    """What the engines call. Controllers decide; engines act (lifecycle
    transitions, billing, requeues stay engine-owned — a controller that
    returns TERMINATE never touches instance state itself)."""

    name: str

    def on_cold_start(self, ctx: ColdStartContext) -> ProbeDecision: ...

    def on_probe(self, ctx: ProbeContext) -> Verdict: ...

    def on_reuse(self, ctx: ReuseContext) -> ReuseDecision: ...

    def on_admit(self, ctx: AdmitContext) -> AdmitDecision: ...

    def on_failure(self, ctx: "FailureContext") -> FailureDecision: ...

    def on_release(self, ctx: ReleaseContext) -> None: ...


class ControllerBase:
    """Shared plumbing: per-decision-point counters (``decisions``) and the
    default answers — probe everything, pass everything, keep warm
    instances, honor the static ``Stage.max_in_flight`` bound.

    ``decisions`` is incremented by the engines (one count per call), so
    sweeps can print which controller handled each decision point
    (``benchmarks/run.py`` per-arm summary)."""

    name = "controller"

    def __init__(self) -> None:
        self.decisions: dict[str, int] = {}

    # -- reporting -------------------------------------------------------
    def handler_name(self, point: str) -> str:
        """Which controller actually answers ``point`` (wrappers delegate)."""
        return self.name

    def decision_summary(self) -> str:
        """``point=handler×count`` per exercised decision point."""
        return "|".join(
            f"{p}={self.handler_name(p)}x{self.decisions[p]}"
            for p in DECISION_POINTS if p in self.decisions
        )

    # -- default decisions ----------------------------------------------
    def on_cold_start(self, ctx: ColdStartContext) -> ProbeDecision:
        return ProbeDecision.PROBE

    def on_probe(self, ctx: ProbeContext) -> Verdict:
        return Verdict.PASS

    def on_reuse(self, ctx: ReuseContext) -> ReuseDecision:
        return ReuseDecision.KEEP

    def on_admit(self, ctx: AdmitContext) -> AdmitDecision:
        # the static Stage.max_in_flight bound, as a controller decision
        if ctx.bound is not None and ctx.in_flight >= ctx.bound:
            return AdmitDecision.DEFER
        return AdmitDecision.ADMIT

    def on_failure(self, ctx: FailureContext) -> FailureDecision:
        # retry by default; the engine's RecoveryPolicy.max_attempts still
        # bounds total attempts regardless of this answer
        return FailureDecision.RETRY

    def on_release(self, ctx: ReleaseContext) -> None:
        return None


class DelegatingController(ControllerBase):
    """Base for wrapper controllers that override a single decision point
    and forward everything else (including attribute access — ``gate``,
    ``policy``, ``observations`` — so engine compatibility views keep
    working through any wrapper stack)."""

    def __init__(self, inner) -> None:
        super().__init__()
        self.inner = inner

    def __getattr__(self, name: str):
        # only reached for attributes not found on the wrapper itself
        return getattr(self.inner, name)

    def handler_name(self, point: str) -> str:
        return self.inner.handler_name(point) if hasattr(self.inner, "handler_name") \
            else getattr(self.inner, "name", type(self.inner).__name__)

    def on_cold_start(self, ctx: ColdStartContext) -> ProbeDecision:
        return self.inner.on_cold_start(ctx)

    def on_probe(self, ctx: ProbeContext) -> Verdict:
        return self.inner.on_probe(ctx)

    def on_reuse(self, ctx: ReuseContext) -> ReuseDecision:
        return self.inner.on_reuse(ctx)

    def on_admit(self, ctx: AdmitContext) -> AdmitDecision:
        return self.inner.on_admit(ctx)

    def on_failure(self, ctx: FailureContext) -> FailureDecision:
        # pre-faults controllers may not implement on_failure; default RETRY
        fn = getattr(self.inner, "on_failure", None)
        return fn(ctx) if fn is not None else FailureDecision.RETRY

    def on_release(self, ctx: ReleaseContext) -> None:
        return self.inner.on_release(ctx)


# ---------------------------------------------------------------------------
# ElysiumGate — now a thin adapter the classic controller wraps
# ---------------------------------------------------------------------------

_gate_kwarg_warned = False


class ElysiumGate:
    """The Minos pass/terminate decision point (paper §II–§IV).

    Owns the probe-observation stream: every cold-start probe result is
    recorded and — before judging — reported to the online controller
    (§IV: passing AND failing probes, otherwise the estimate is
    survivor-biased) or to an :class:`~repro_torch.core.policy.AdaptiveMinosPolicy`
    (anything with a ``report`` method — the policy IS the controller,
    DESIGN.md §6). The instance then judges itself against the latest
    published threshold.

    .. deprecated:: PR 4
        Constructing the gate directly with ``online_controller=...`` is
        deprecated — build a :class:`ClassicMinosController` (which owns a
        gate) and hand it to the engine instead; behavior is bit-identical.
    """

    def __init__(self, policy, online_controller=None, *,
                 _from_controller: bool = False) -> None:
        if online_controller is not None and not dataclasses.is_dataclass(policy):
            # judging with a separate controller rebinds the policy's
            # threshold via dataclasses.replace — impossible for a mutable
            # policy like AdaptiveMinosPolicy, which IS its own controller.
            raise TypeError(
                "online_controller requires a dataclass policy (e.g. "
                f"MinosPolicy); got {type(policy).__name__}. An adaptive "
                "policy already maintains its threshold online — pass it "
                "alone, without a separate controller."
            )
        if online_controller is not None and not _from_controller:
            global _gate_kwarg_warned
            if not _gate_kwarg_warned:
                _gate_kwarg_warned = True
                warnings.warn(
                    "ElysiumGate(online_controller=...) is deprecated; wrap "
                    "policy + controller in a ClassicMinosController and pass "
                    "it to the engine (behavior is identical).",
                    DeprecationWarning, stacklevel=2,
                )
        self.policy = policy
        self.online_controller = online_controller
        self.observations: list[float] = []

    def should_probe(self, retry_count: int, *, is_cold_start: bool = True) -> bool:
        return self.policy.should_benchmark(retry_count, is_cold_start=is_cold_start)

    def _effective_policy(self):
        """The policy at the latest published threshold (no reporting)."""
        if self.online_controller is not None:
            return dataclasses.replace(
                self.policy, elysium_threshold=self.online_controller.threshold
            )
        return self.policy

    @staticmethod
    def _effective_observation(policy, observed_ms: float, load_factor: float) -> float:
        """Fold pool occupancy into the judged value: durations inflate
        under load; throughput-style metrics deflate."""
        if load_factor == 1.0:
            return observed_ms
        if getattr(policy, "higher_is_better", False):
            return observed_ms / load_factor
        return observed_ms * load_factor

    def judge(
        self,
        inst: FunctionInstance,
        observed_ms: float,
        retry_count: int,
        *,
        load_factor: float = 1.0,
    ) -> Verdict:
        """Judge ``inst`` on its cold-start probe result.

        ``load_factor`` > 1 folds the pool's current occupancy into the
        decision (ROADMAP: concurrency-aware gating): the instance is
        judged on the *effective* duration ``observed × load_factor`` —
        the speed a request will actually see under the load-slowdown
        model — not the unloaded cold-start probe speed, so certification
        reflects what the replica can sustain at the occupancy it is about
        to serve. At load 1 this is exactly the paper's gate. The raw
        observation is what is recorded and reported to the controller, so
        threshold estimation stays in unloaded-probe units. The trade-off
        is measured in EXPERIMENTS.md: under frozen certified speeds
        (§Load-aware pipeline sweep) effective-speed gating preserves the
        body-latency gains under real self-contention; under per-serve
        contention drift with a long-lived concurrent pool (§Diurnal
        sweep, load arms) the extra selectivity cannot pay for its churn.
        """
        self.observations.append(observed_ms)
        if self.online_controller is not None:
            self.online_controller.report(observed_ms)
        elif hasattr(self.policy, "report"):
            self.policy.report(observed_ms)
        policy = self._effective_policy()  # threshold AFTER this report
        if load_factor != 1.0:
            inst.benchmark_result = self._effective_observation(
                policy, observed_ms, load_factor)
        return inst.judge(policy, retry_count)

    def rejudge(
        self,
        inst: FunctionInstance,
        observed_ms: float,
        retry_count: int,
        *,
        load_factor: float = 1.0,
    ) -> Verdict:
        """Judge a WARM instance's re-probe against the current threshold.

        Unlike :meth:`judge`, the observation is neither recorded nor
        reported: a re-probe measures a *drifted, in-service* instance,
        and feeding it to the threshold estimators would mix that
        population into the cold-start distribution the pass quantile is
        defined over. No lifecycle transition happens here either — the
        engine retires the instance if the verdict is TERMINATE."""
        policy = self._effective_policy()
        eff = self._effective_observation(policy, observed_ms, load_factor)
        inst.benchmark_result = eff
        if not getattr(policy, "enabled", True):
            return Verdict.PASS
        if retry_count >= getattr(policy, "max_retries", 0):
            return Verdict.FORCED_PASS
        return Verdict.PASS if policy.passes(eff) else Verdict.TERMINATE


# ---------------------------------------------------------------------------
# ClassicMinosController — the default; bit-identical to the old stack
# ---------------------------------------------------------------------------


class ClassicMinosController(ControllerBase):
    """The pre-control-plane decision stack as a :class:`Controller`.

    Policy (fixed or adaptive) + optional
    :class:`~repro_torch.core.elysium.OnlineElysiumController` + the
    ``gate_load_aware`` knob, expressed through the new API. This is the
    engine default; the seeded golden-parity digests
    (tests/test_unified_substrate.py) pin it to the old behavior
    bit-for-bit: same RNG stream, same verdicts, same timings."""

    def __init__(self, policy, online_controller=None) -> None:
        super().__init__()
        self.gate = ElysiumGate(policy, online_controller, _from_controller=True)
        self.name = f"classic[{type(policy).__name__}]"

    # -- compatibility views --------------------------------------------
    @property
    def policy(self):
        return self.gate.policy

    @property
    def online_controller(self):
        return self.gate.online_controller

    @property
    def observations(self) -> list[float]:
        return self.gate.observations

    # -- decisions -------------------------------------------------------
    def _load_factor(self, t: Telemetry) -> float:
        if t.knobs.gate_load_aware:
            # judge at the pool's current occupancy: the certified speed
            # must hold up under the load the replica will actually serve
            return t.knobs.load_multiplier(t.mean_load)
        return 1.0

    def on_cold_start(self, ctx: ColdStartContext) -> ProbeDecision:
        if self.gate.should_probe(ctx.retry_count, is_cold_start=True):
            return ProbeDecision.PROBE
        return ProbeDecision.SKIP

    def on_probe(self, ctx: ProbeContext) -> Verdict:
        lf = self._load_factor(ctx.telemetry)
        if ctx.is_cold:
            return self.gate.judge(ctx.instance, ctx.observed_ms,
                                   ctx.retry_count, load_factor=lf)
        return self.gate.rejudge(ctx.instance, ctx.observed_ms,
                                 ctx.retry_count, load_factor=lf)


# ---------------------------------------------------------------------------
# Lognormal selection math (shared by PassFractionController and tests)
# ---------------------------------------------------------------------------


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF by bisection (Φ is monotone; 60 steps
    give ~1e-16 interval width — far below what a threshold needs)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    lo, hi = -10.0, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _norm_cdf(mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def lognormal_pool_speedup(pass_fraction: float, log_sigma: float) -> float:
    """Mean-body-time speedup of keeping only the fastest ``pass_fraction``
    when probe/body durations are lognormal with log-std ``log_sigma``.

    For d ~ LogNormal(μ, σ²), E[d | d ≤ q_f] = e^{μ+σ²/2}·Φ(z_f − σ)/f with
    z_f = Φ⁻¹(f), so speedup(f) = E[d]/E[d | selected] = f / Φ(z_f − σ).
    Monotone in σ, → 1 as f → 1 or σ → 0 — the closed form of "mean speed
    of the top-f fraction" the §II-A trade-off needs, computable from two
    Welford moments instead of a stored sample."""
    if not 0.0 < pass_fraction < 1.0:
        raise ValueError("pass_fraction must be in (0,1)")
    if log_sigma <= 0.0:
        return 1.0
    z = _norm_ppf(pass_fraction)
    return pass_fraction / max(_norm_cdf(z - log_sigma), 1e-12)


# ---------------------------------------------------------------------------
# PassFractionController — ROADMAP: adaptive pass fraction
# ---------------------------------------------------------------------------


class PassFractionController(ControllerBase):
    """Closes the §II-A loop online: the pass *fraction* (not just the
    threshold) adapts to the live workload.

    Every ``update_every`` cold probes it re-solves
    :func:`~repro_torch.core.elysium.optimal_pass_fraction` with the engine's
    Welford estimates — probe mean (selection waste), body mean (the work
    a faster instance accelerates), reuse rate (how often certification
    amortizes) and the probe log-std (the platform's variability, feeding
    :func:`lognormal_pool_speedup`) — then republishes the threshold at
    the chosen quantile of the fitted lognormal probe distribution,
    EMA-smoothed. Duration metrics only (lower is better).

    This is "the optimal termination rate depends on the duration of the
    workload, the performance variability of the platform, and the
    relative time of the benchmark" (paper §II-A), closed with live data:
    high churn / low reuse pushes the fraction up (probing waste dominates),
    long bodies and high variability push it down (selectivity pays)."""

    def __init__(
        self,
        initial_pass_fraction: float = 0.4,
        *,
        max_retries: int = 5,
        warmup_reports: int = 5,
        update_every: int = 8,
        fractions: Optional[tuple[float, ...]] = None,
        smoothing_alpha: float = 0.5,
        min_fraction: float = 0.05,
        max_fraction: float = 0.95,
    ) -> None:
        super().__init__()
        if not 0.0 < initial_pass_fraction < 1.0:
            raise ValueError("initial_pass_fraction must be in (0,1)")
        if update_every < 1:
            raise ValueError("update_every must be >= 1")
        self.name = "pass-fraction"
        self.pass_fraction = initial_pass_fraction
        self.max_retries = max_retries
        self.warmup_reports = warmup_reports
        self.update_every = update_every
        self.fractions = tuple(fractions) if fractions is not None else tuple(
            float(f) for f in np.linspace(min_fraction, max_fraction, 19))
        self._ema = EMA(smoothing_alpha, None)
        self.threshold: Optional[float] = None
        self.observations: list[float] = []
        self.fraction_history: list[tuple[float, float]] = []  # (t_ms, fraction)

    def on_cold_start(self, ctx: ColdStartContext) -> ProbeDecision:
        if ctx.retry_count >= self.max_retries:
            return ProbeDecision.SKIP  # emergency exit: accept unjudged
        return ProbeDecision.PROBE

    def on_probe(self, ctx: ProbeContext) -> Verdict:
        t = ctx.telemetry
        if ctx.is_cold:
            self.observations.append(ctx.observed_ms)
            n = len(self.observations)
            if n >= self.warmup_reports and n % self.update_every == 0:
                self._update(t)
        if ctx.retry_count >= self.max_retries:
            return Verdict.FORCED_PASS
        if self.threshold is None:
            return Verdict.PASS  # warm-up: collecting the distribution
        eff = ElysiumGate._effective_observation(
            None, ctx.observed_ms,
            t.knobs.load_multiplier(t.mean_load) if t.knobs.gate_load_aware else 1.0)
        ctx.instance.benchmark_result = eff
        return Verdict.PASS if eff <= self.threshold else Verdict.TERMINATE

    def _update(self, t: Telemetry) -> None:
        sigma = t.probe_log_std
        body, bench = t.body_mean_ms, t.probe_mean_ms
        if sigma <= 0.0 or not math.isfinite(body) or not math.isfinite(bench):
            return  # not enough signal yet
        f = optimal_pass_fraction(
            benchmark_ms=bench,
            body_ms=body,
            expected_reuses=t.expected_reuses,
            speedup_at_fraction=lambda fr: lognormal_pool_speedup(fr, sigma),
            fractions=self.fractions,
        )
        self.pass_fraction = f
        self.fraction_history.append((t.now_ms, f))
        raw = math.exp(t.probe_log_mean + _norm_ppf(f) * sigma)
        self.threshold = self._ema.update(raw)


# ---------------------------------------------------------------------------
# QueueAwareAdmissionController — ROADMAP: dynamic per-stage admission
# ---------------------------------------------------------------------------


class QueueAwareAdmissionController(DelegatingController):
    """Dynamic per-stage admission: defer items while the stage's live
    demand (requests in flight + its own queue depth) exceeds a headroom
    multiple of its *certified* serving capacity.

    Capacity = replica budget × per-instance concurrency, where the
    budget is the pool cap (``SubstrateKnobs.max_pool``) when the backend
    has one, else the live instance count. Under an elastic cold-start
    supply a deep queue never forms — overload instead shows up as
    uncertified extra instances spawned past the pool cap, each paying
    prepare + probe and then being despawned at release (the
    queue-dominated latency of EXPERIMENTS.md §Load-aware pipeline
    sweep). Deferring at ``in_flight + queue_depth ≥ ⌈headroom ×
    capacity⌉`` keeps work on the gate-certified pool instead.

    The static ``Stage.max_in_flight`` bound (the wrapped controller's
    :meth:`on_admit`) still applies first. A deferral only ever happens
    with stage work in flight or queued, and the workflow layer re-offers
    deferred items on every completion of that stage, so progress is
    guaranteed — back-pressure, never deadlock."""

    def __init__(self, inner, *, headroom: float = 1.5,
                 min_slots: int = 4) -> None:
        super().__init__(inner)
        if headroom <= 0.0:
            raise ValueError("headroom must be > 0")
        if min_slots < 1:
            raise ValueError("min_slots must be >= 1")
        self.name = "queue-admission"
        self.headroom = headroom
        self.min_slots = min_slots
        self.deferred = 0  # decisions, not unique items

    def handler_name(self, point: str) -> str:
        if point == "on_admit":
            return self.name
        return super().handler_name(point)

    def on_admit(self, ctx: AdmitContext) -> AdmitDecision:
        if self.inner.on_admit(ctx) is AdmitDecision.DEFER:
            return AdmitDecision.DEFER  # static bound still respected
        t = ctx.telemetry
        if t.knobs.max_pool is not None:
            budget = t.knobs.max_pool
        elif getattr(t.knobs, "max_instances", None) is not None:
            # open-loop autoscaling cap (DESIGN.md §12): the supply the
            # stage can actually spawn, even before instances exist
            budget = t.knobs.max_instances
        else:
            budget = max(1, t.pool_instances)
        capacity = budget * t.knobs.per_instance_concurrency
        bound = max(self.min_slots, math.ceil(self.headroom * capacity))
        if t.total_in_flight + t.queue_depth >= bound:
            self.deferred += 1
            return AdmitDecision.DEFER
        return AdmitDecision.ADMIT


def static_admission_bound(knobs: Any, *, headroom: float = 2.0,
                           min_slots: int = 1) -> float:
    """Static in-flight cap matching :class:`QueueAwareAdmissionController`.

    The vectorized open-loop scan (``repro_torch.sim.vectorized``) cannot call a
    live controller per arrival, so it takes the admission bound as a
    number (``ArmParams.admit_bound``) and defers while
    ``in_flight >= bound``.  This helper derives that number from the same
    capacity formula the dynamic controller uses — replica budget
    (``max_pool``, else ``max_instances``) × per-instance concurrency ×
    headroom — minus the live-pool fallback, which has no static
    equivalent.  With no replica cap at all the supply is elastic and the
    bound is ``inf`` (admission never defers).
    """
    if headroom <= 0.0:
        raise ValueError("headroom must be > 0")
    if min_slots < 1:
        raise ValueError("min_slots must be >= 1")
    budget = getattr(knobs, "max_pool", None)
    if budget is None:
        budget = getattr(knobs, "max_instances", None)
    if budget is None:
        return math.inf
    capacity = budget * knobs.per_instance_concurrency
    return float(max(min_slots, math.ceil(headroom * capacity)))


# ---------------------------------------------------------------------------
# ReprobeController — ROADMAP: re-probing under drift
# ---------------------------------------------------------------------------


class ReprobeController(DelegatingController):
    """Warm re-benchmarking once a certification goes stale (ROADMAP:
    re-probing under drift).

    The paper skips warm re-benchmarking because FaaS instances are
    short-lived (§II-B); under per-serve contention drift
    (``contention_rho < 1``) and long-lived concurrent pools that
    assumption breaks — an instance out-serves its certified speed's
    half-life and the pool silently decays to the day mean (EXPERIMENTS.md
    §Diurnal sweep, load arms). This wrapper re-probes a warm instance
    after ``max_uses_since_probe`` serves and/or ``max_ms_since_probe``
    milliseconds; the inner controller judges the fresh observation
    against its current threshold (via ``on_probe(is_cold=False)``, which
    does NOT pollute the cold-probe estimators) and the engine retires the
    instance on TERMINATE. The re-probe runs concurrently with the
    prepare phase, so a passing instance usually pays nothing.

    The per-serve AR(1) drift model gives the natural trigger unit:
    log-relative speed decays by ρ per serve, so the half-life is
    ln(½)/ln(ρ) serves (ρ=0.95 → ≈13.5) — pick ``max_uses_since_probe``
    around that."""

    def __init__(self, inner, *, max_uses_since_probe: Optional[int] = None,
                 max_ms_since_probe: Optional[float] = None) -> None:
        super().__init__(inner)
        if max_uses_since_probe is None and max_ms_since_probe is None:
            raise ValueError("need max_uses_since_probe and/or max_ms_since_probe")
        if max_uses_since_probe is not None and max_uses_since_probe < 1:
            raise ValueError("max_uses_since_probe must be >= 1")
        self.name = "reprobe"
        self.max_uses_since_probe = max_uses_since_probe
        self.max_ms_since_probe = max_ms_since_probe

    @staticmethod
    def half_life_uses(contention_rho: float) -> int:
        """Serves until the certified log-advantage halves under AR(1)."""
        if not 0.0 < contention_rho < 1.0:
            raise ValueError("contention_rho must be in (0,1)")
        return max(1, round(math.log(0.5) / math.log(contention_rho)))

    def handler_name(self, point: str) -> str:
        if point == "on_reuse":
            return self.name
        return super().handler_name(point)

    def on_reuse(self, ctx: ReuseContext) -> ReuseDecision:
        if ctx.retry_count > 0:
            # a retried invocation has already paid selection waste; serve it
            return self.inner.on_reuse(ctx)
        stale = (
            self.max_uses_since_probe is not None
            and ctx.uses_since_probe >= self.max_uses_since_probe
        ) or (
            self.max_ms_since_probe is not None
            and ctx.ms_since_probe is not None
            and ctx.ms_since_probe >= self.max_ms_since_probe
        )
        if stale:
            return ReuseDecision.REPROBE
        return self.inner.on_reuse(ctx)


__all__ = [
    "AdmitContext",
    "AdmitDecision",
    "ClassicMinosController",
    "ColdStartContext",
    "Controller",
    "ControllerBase",
    "DECISION_POINTS",
    "DelegatingController",
    "ElysiumGate",
    "FailureContext",
    "FailureDecision",
    "FleetTelemetry",
    "PassFractionController",
    "ProbeContext",
    "ProbeDecision",
    "QueueAwareAdmissionController",
    "ReleaseContext",
    "ReprobeController",
    "ReuseContext",
    "ReuseDecision",
    "Telemetry",
    "lognormal_pool_speedup",
    "static_admission_bound",
]
