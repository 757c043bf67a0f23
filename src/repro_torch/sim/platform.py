"""Discrete-event FaaS platform simulator — the *simulated* backend of the
shared execution substrate (DESIGN.md §9).

Models the slice of platform behavior Minos interacts with:

* an elastic supply of worker slots; each new instance draws a hidden
  ``speed_factor`` from the day's :class:`VariationModel`;
* cold-start latency before user code runs;
* a per-function warm pool — idle instances are re-used LIFO (most recently
  used first, matching observed FaaS behavior) and reclaimed after an idle
  timeout;
* one concurrent request per instance (GCF gen1 semantics);
* the Minos path: on a cold start, the matmul probe runs concurrently with
  the function's network-bound prepare phase; the instance then judges
  itself against the elysium threshold and either proceeds, or re-queues
  the invocation and crashes.

The pool/gate/clock/queue machinery and the invocation-processing loop all
live in :mod:`repro_torch.core.substrate`; this module contributes only what is
simulation-specific — :class:`SimFunctionBackend` samples every duration
from a :class:`FunctionSpec` and speeds from the variation model. The
model-serving engine (``serving/engine.py``) is the other backend of the
same substrate, so both paths share identical execution semantics.

Time unit: milliseconds of simulated time. The simulator is fully
deterministic given a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.cost import Pricing
from repro_torch.core.lifecycle import FunctionInstance
from repro_torch.core.policy import MinosPolicy
from repro_torch.core.substrate import (
    RequestResult,
    SimClock,
    SubstrateEngine,
    SubstrateKnobs,
    ar1_drift,
    sample_jitter,
)
from .variation import VariationModel

# Re-exported for compatibility: the event loop lives in core.substrate now.
_EventLoop = SimClock


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """A deployed function. Durations are at unit speed (speed_factor 1.0).

    prepare is network-bound (does NOT scale with CPU speed); body is
    CPU-bound (scales 1/speed). benchmark is CPU-bound and runs in parallel
    with prepare on cold starts (paper Fig 2).
    """

    name: str
    prepare_ms: float = 600.0
    prepare_jitter: float = 0.10          # lognormal-ish network jitter
    body_ms: float = 2000.0
    body_jitter: float = 0.02             # residual (non-contention) noise
    benchmark_ms: float = 300.0
    benchmark_noise: float = 0.05         # probe observation noise (lognormal sigma)
    cold_start_ms: float = 250.0
    cold_start_jitter: float = 0.25
    # co-tenancy drift: per-serve AR(1) correlation of an instance's
    # (log-relative) speed. Neighbors on the worker node come and go, so a
    # fast-at-probe-time instance regresses toward the day mean; 1.0 =
    # frozen speeds (the idealized model).
    contention_rho: float = 0.98
    bill_cold_start: bool = True          # platform bills instance startup
    requeue_overhead_ms: float = 30.0     # queue round-trip after a crash
    idle_timeout_ms: float = 15 * 60 * 1000.0
    # platform-initiated instance recycling: exponential lifetime mean (ms).
    # FaaS platforms reclaim/rotate instances opportunistically; this churn
    # is what keeps cold starts (and thus Minos terminations) flowing after
    # the initial pool forms. None = instances live until idle-timeout.
    recycle_lifetime_ms: float | None = 7 * 60 * 1000.0


@dataclasses.dataclass(frozen=True)
class PlatformProfile:
    """Platform-level behavior knobs, separated from the function's own
    workload shape (DESIGN.md §7). A :class:`FunctionSpec` says what the
    *function* does (prepare/body/benchmark durations); the profile says how
    the *platform* hosts it: warm-pool reuse order, per-instance request
    concurrency, cold-start and recycle behavior, billing, and the pricing
    tier. When a profile is passed to :class:`FaaSPlatform` it overrides the
    spec's platform-level fields, so one scenario runs unchanged on several
    platform models.
    """

    name: str
    pricing: Pricing
    warm_pool_order: str = "lifo"          # "lifo" (MRU-first) | "fifo" (round-robin-ish)
    per_instance_concurrency: int = 1      # concurrent requests one warm instance takes
    cold_start_ms: float = 250.0
    cold_start_jitter: float = 0.25
    idle_timeout_ms: float = 15 * 60 * 1000.0
    recycle_lifetime_ms: float | None = 7 * 60 * 1000.0
    bill_cold_start: bool = True
    requeue_overhead_ms: float = 30.0
    # self-contention of concurrent requests on one instance: a request
    # sharing its instance with load-1 others runs load**alpha slower
    # (0.0 = the idealized free-concurrency model; DESIGN.md §9 load model)
    load_slowdown_alpha: float = 0.0
    # gate judges cold-start probes at the pool's current mean occupancy
    gate_load_aware: bool = False

    def __post_init__(self) -> None:
        if self.warm_pool_order not in ("lifo", "fifo", "spread"):
            raise ValueError(
                f"warm_pool_order must be 'lifo', 'fifo' or 'spread', "
                f"got {self.warm_pool_order!r}")
        if self.per_instance_concurrency < 1:
            raise ValueError("per_instance_concurrency must be >= 1")
        if self.load_slowdown_alpha < 0.0:
            raise ValueError("load_slowdown_alpha must be >= 0")

    def knobs(self, max_pool: Optional[int] = None) -> SubstrateKnobs:
        """The substrate's view of this profile."""
        return SubstrateKnobs(
            cold_start_ms=self.cold_start_ms,
            cold_start_jitter=self.cold_start_jitter,
            idle_timeout_ms=self.idle_timeout_ms,
            recycle_lifetime_ms=self.recycle_lifetime_ms,
            bill_cold_start=self.bill_cold_start,
            requeue_overhead_ms=self.requeue_overhead_ms,
            warm_pool_order=self.warm_pool_order,
            per_instance_concurrency=self.per_instance_concurrency,
            max_pool=max_pool,
            load_slowdown_alpha=self.load_slowdown_alpha,
            gate_load_aware=self.gate_load_aware,
        )

    @staticmethod
    def gcf_gen1(memory_mb: int = 256) -> "PlatformProfile":
        """The paper's platform: one request per instance, MRU reuse,
        cold starts billed, aggressive instance churn (EXPERIMENTS.md
        calibration)."""
        return PlatformProfile(
            name="gcf-gen1",
            pricing=Pricing.gcf(memory_mb),
            warm_pool_order="lifo",
            per_instance_concurrency=1,
            cold_start_ms=250.0,
            recycle_lifetime_ms=45_000.0,
        )

    @staticmethod
    def gcf_gen2(memory_mb: int = 1024, concurrency: int = 4) -> "PlatformProfile":
        """Cloud-Run-based gen2: request-concurrent instances, slower cold
        start (bigger runtime), request-time-only billing, FIFO-ish reuse
        (the load balancer spreads across the instance set)."""
        return PlatformProfile(
            name="gcf-gen2",
            pricing=Pricing.gcf(memory_mb),
            warm_pool_order="fifo",
            per_instance_concurrency=concurrency,
            cold_start_ms=400.0,
            recycle_lifetime_ms=90_000.0,
            bill_cold_start=False,
        )

    @staticmethod
    def gcf_gen2_loaded(
        memory_mb: int = 1024, concurrency: int = 4, alpha: float = 0.6,
    ) -> "PlatformProfile":
        """gen2 with self-contention made real: concurrent requests on one
        instance slow each other down (load**alpha) and the gate judges
        probes at the pool's live occupancy. The idealized ``gcf_gen2``
        preset (alpha=0, free concurrency) is what this arm is compared
        against in the load-aware sweeps (EXPERIMENTS.md)."""
        return PlatformProfile(
            name="gcf-gen2-loaded",
            pricing=Pricing.gcf(memory_mb),
            warm_pool_order="spread",
            per_instance_concurrency=concurrency,
            cold_start_ms=400.0,
            recycle_lifetime_ms=90_000.0,
            bill_cold_start=False,
            load_slowdown_alpha=alpha,
            gate_load_aware=True,
        )

    @staticmethod
    def aws_lambda(memory_mb: int = 1024) -> "PlatformProfile":
        """Lambda-like: one request per instance, MRU reuse, fast firecracker
        cold start, init phase unbilled, shorter idle reclaim."""
        return PlatformProfile(
            name="lambda",
            pricing=Pricing.aws_lambda(memory_mb),
            warm_pool_order="lifo",
            per_instance_concurrency=1,
            cold_start_ms=150.0,
            cold_start_jitter=0.20,
            idle_timeout_ms=7 * 60 * 1000.0,
            recycle_lifetime_ms=120_000.0,
            bill_cold_start=False,
        )


class SimFunctionBackend:
    """Substrate backend that *samples* every duration from a
    :class:`FunctionSpec` and instance speeds from a
    :class:`VariationModel` — the paper's evaluation world."""

    def __init__(self, spec: FunctionSpec, variation: VariationModel) -> None:
        self.spec = spec
        self.variation = variation
        self.name = spec.name

    def sample_speed(self, rng: np.random.RandomState, t_ms: float) -> float:
        return self.variation.sample_speed(rng, t_ms=t_ms)

    def reuse_drift(self, inst: FunctionInstance, rng: np.random.RandomState, t_ms: float) -> None:
        ar1_drift(
            inst, rng,
            day_mean=self.variation.day_factor * self.variation.diurnal(t_ms),
            sigma=self.variation.sigma,
            rho=self.spec.contention_rho,
        )

    def prepare_ms(self, rng: np.random.RandomState) -> float:
        return self.spec.prepare_ms * sample_jitter(rng, self.spec.prepare_jitter)

    def probe(self, inst: FunctionInstance, rng: np.random.RandomState) -> float:
        # The probe observes speed with noise (it is short), so selection is
        # imperfect; the noisy observation is what the instance judges on.
        bench = inst.run_benchmark(self.spec.benchmark_ms) * sample_jitter(
            rng, self.spec.benchmark_noise
        )
        inst.benchmark_result = bench
        return bench

    def reprobe(self, inst: FunctionInstance, rng: np.random.RandomState) -> float:
        """Warm re-benchmark (control plane, ReuseDecision.REPROBE): same
        work and observation noise as the cold probe, but measured at the
        instance's *current* (drifted) speed and without the COLD-only
        lifecycle transition."""
        return (self.spec.benchmark_ms / inst.speed_factor) * sample_jitter(
            rng, self.spec.benchmark_noise
        )

    def body(
        self,
        payload: Any,
        inst: FunctionInstance,
        rng: np.random.RandomState,
        *,
        load: int = 1,
    ) -> tuple[float, Any]:
        # load is accounted by the engine's load-slowdown curve; a sampled
        # duration has nothing batched to compute, so it is unused here
        analysis = (
            self.spec.body_ms * sample_jitter(rng, self.spec.body_jitter)
            / inst.speed_factor
        )
        return analysis, None

    def requeue_penalty_ms(self, payload: Any) -> float:
        return 0.0  # stateless function: nothing to migrate


class FaaSPlatform(SubstrateEngine):
    """One function deployment on a simulated region: a
    :class:`~repro_torch.core.substrate.SubstrateEngine` over a
    :class:`SimFunctionBackend`."""

    def __init__(
        self,
        spec: FunctionSpec,
        variation: VariationModel,
        policy: MinosPolicy,
        pricing: Pricing | None = None,
        seed: int = 0,
        online_controller=None,
        profile: Optional[PlatformProfile] = None,
        controller=None,
        knobs: Optional[SubstrateKnobs] = None,
        clock: Optional[SimClock] = None,
        fault_plan=None,
        recovery=None,
    ) -> None:
        """online_controller: an OnlineElysiumController (paper §IV future
        work, implemented here): every cold-start probe result is reported
        to it and the effective elysium threshold follows its estimate —
        the platform keeps working (stale threshold) if it dies.

        An AdaptiveMinosPolicy (anything with a ``report`` method) is fed
        the same probe stream directly — the §IV wiring without a separate
        controller object.

        profile: platform-level overrides (pool order, concurrency, cold
        start, recycling, billing). Without one, those knobs come from the
        spec and the platform behaves exactly like GCF gen1 (LIFO pool, one
        request per instance).

        controller: a :class:`~repro_torch.core.control.Controller` that replaces
        the whole policy stack (pass ``policy=None`` then); the legacy
        arguments build the default ClassicMinosController.

        knobs: explicit :class:`~repro_torch.core.substrate.SubstrateKnobs`,
        overriding both profile and spec — how open-loop drivers set the
        ``max_instances`` / ``queue_capacity`` traffic knobs on top of a
        profile (``dataclasses.replace(profile.knobs(), ...)``).

        clock: a shared :class:`~repro_torch.core.substrate.SimClock` — the
        fleet meta-scheduler (``repro_torch.fleet``) composes several platforms
        on one event loop this way. None builds a private clock.

        fault_plan / recovery: a :class:`~repro_torch.faults.FaultPlan` and
        :class:`~repro_torch.faults.RecoveryPolicy` (DESIGN.md §15). None/None
        is the historical fault-free at-least-once platform."""
        if pricing is None:
            if profile is None:
                raise ValueError("pricing is required when no profile is given")
            pricing = profile.pricing
        if knobs is not None:
            pass  # explicit knobs win
        elif profile is not None:
            knobs = profile.knobs()
        else:
            knobs = SubstrateKnobs(
                cold_start_ms=spec.cold_start_ms,
                cold_start_jitter=spec.cold_start_jitter,
                idle_timeout_ms=spec.idle_timeout_ms,
                recycle_lifetime_ms=spec.recycle_lifetime_ms,
                bill_cold_start=spec.bill_cold_start,
                requeue_overhead_ms=spec.requeue_overhead_ms,
                warm_pool_order="lifo",
                per_instance_concurrency=1,
            )
        super().__init__(
            SimFunctionBackend(spec, variation), policy, pricing,
            knobs=knobs, seed=seed, online_controller=online_controller,
            controller=controller, clock=clock,
            fault_plan=fault_plan, recovery=recovery,
        )
        self.spec = spec
        self.variation = variation
        self.profile = profile

    @property
    def warm_pool(self) -> list[FunctionInstance]:
        return self.pool.available

__all__ = [
    "FaaSPlatform",
    "FunctionSpec",
    "PlatformProfile",
    "RequestResult",
    "SimFunctionBackend",
    "_EventLoop",
]
