"""The paper's evaluation protocol (§III), end to end.

Per day:
  1. **Pre-testing** (§III-A): 10 VUs × 1 min against an unguarded
     deployment; the elysium threshold is the 60th percentile of observed
     probe durations (⇒ fastest 40 % pass).
  2. **Baseline arm**: identical function, all Minos components disabled,
     10 VUs × 30 min.
  3. **Minos arm**: elysium gate active, same workload, same day variation.

Outputs map 1:1 onto the paper's figures:
  Fig 4 — mean/median analysis duration per day, both arms
  Fig 5 — successful requests per day
  Fig 6 — cost per million successful requests per day
  Fig 7 — running cost per successful request over elapsed time
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost import Pricing
from repro_torch.core.elysium import pretest_threshold, run_pretest
from repro_torch.core.policy import AdaptiveMinosPolicy, MinosPolicy
from .metrics import ArmSummary, cost_timeline, improvement
from .platform import FaaSPlatform, FunctionSpec
from .variation import VariationModel, paper_week
from .workload import run_closed_loop

# The paper's workload scales (§III-A, Figs 4-7), calibrated so the
# simulated platform reproduces the paper's measurements (see
# EXPERIMENTS.md): regression step lands in the 1-3 s band (Fig 4),
# ~4-5 k successful requests/day per 10 VUs (Fig 5), ~$11-13 per million
# successful requests at the GCF 256 MB tier (Fig 6).
PAPER_SPEC = FunctionSpec(
    name="weather-linreg",
    prepare_ms=1500.0,        # weather-CSV download (network-bound)
    body_ms=1800.0,           # linear-regression analysis (CPU-bound)
    benchmark_ms=450.0,       # matmul probe, hidden under the download
    cold_start_ms=250.0,
    recycle_lifetime_ms=45_000.0,   # platform instance churn
    contention_rho=0.95,            # co-tenancy drift per serve
    benchmark_noise=0.08,           # probe observation noise
)
PAPER_PRICING = Pricing.gcf(256)
PASS_FRACTION = 0.4  # 60th-percentile elysium threshold

ARMS = ("disabled", "fixed", "adaptive")


def make_arm_policy(
    arm: str,
    *,
    threshold: float | None = None,
    pass_fraction: float = PASS_FRACTION,
    max_retries: int = 5,
    warmup_reports: int = 5,
    initial_threshold: float | None = None,
):
    """Policy for one experiment arm.

    * ``disabled`` — the paper's baseline: every instance passes.
    * ``fixed`` — the paper's prototype: a pre-tested elysium threshold
      (§III-A), supplied via ``threshold``.
    * ``adaptive`` — the §IV protocol: :class:`AdaptiveMinosPolicy`
      maintains the threshold online from the probe stream; no pre-test
      phase exists (warm-up passes everything while the estimators fill).
    """
    if arm == "disabled":
        return MinosPolicy(elysium_threshold=float("inf"), enabled=False)
    if arm == "fixed":
        if threshold is None:
            raise ValueError("fixed arm needs a pre-tested threshold")
        return MinosPolicy(elysium_threshold=threshold, max_retries=max_retries)
    if arm == "adaptive":
        return AdaptiveMinosPolicy(
            pass_fraction,
            max_retries=max_retries,
            warmup_reports=warmup_reports,
            initial_threshold=initial_threshold,
        )
    raise ValueError(f"unknown arm {arm!r}; expected one of {ARMS}")


def workflow_arm_factory(
    arm: str,
    variation: VariationModel,
    *,
    pass_fraction: float = PASS_FRACTION,
    max_retries: int = 5,
    warmup_reports: int = 5,
    pricing: Pricing = PAPER_PRICING,
    pretest_seed: int = 1234,
):
    """Per-stage policy factory for :class:`~repro_torch.sim.workflow_dag.WorkflowEngine`.

    The ``fixed`` arm pre-tests each stage's function separately (a stage's
    threshold is in units of its own probe duration); the ``adaptive`` arm
    gets one independent online estimator per stage and skips pre-testing
    entirely. Stage ``max_retries`` overrides the default bound.
    """
    _cache: dict[str, float] = {}

    def factory(stage):
        mr = stage.max_retries if stage.max_retries is not None else max_retries
        if arm == "fixed":
            if stage.name not in _cache:
                import zlib
                _cache[stage.name] = run_pretest_phase(
                    variation, stage.spec, pricing,
                    seed=pretest_seed + zlib.crc32(stage.name.encode()) % 7919,
                    pass_fraction=pass_fraction,
                )
            return make_arm_policy(
                "fixed", threshold=_cache[stage.name],
                pass_fraction=pass_fraction, max_retries=mr,
            )
        return make_arm_policy(
            arm, pass_fraction=pass_fraction, max_retries=mr,
            warmup_reports=warmup_reports,
        )

    return factory


@dataclasses.dataclass
class DayResult:
    day: int
    variation: VariationModel
    elysium_threshold: float
    baseline: ArmSummary
    minos: ArmSummary
    timeline_baseline: tuple[np.ndarray, np.ndarray]
    timeline_minos: tuple[np.ndarray, np.ndarray]
    # §IV arm (no pre-test; threshold maintained online) — populated when
    # run_day(include_adaptive=True)
    adaptive: ArmSummary | None = None

    @property
    def analysis_improvement(self) -> float:
        return improvement(self.baseline.mean_analysis_ms, self.minos.mean_analysis_ms)

    @property
    def successful_requests_delta(self) -> float:
        return (self.minos.n_successful - self.baseline.n_successful) / self.baseline.n_successful

    @property
    def cost_saving(self) -> float:
        return improvement(self.baseline.cost_per_million, self.minos.cost_per_million)


@dataclasses.dataclass
class WeekResult:
    days: list[DayResult]

    @property
    def overall_analysis_improvement(self) -> float:
        b = np.mean([d.baseline.mean_analysis_ms for d in self.days])
        m = np.mean([d.minos.mean_analysis_ms for d in self.days])
        return improvement(b, m)

    @property
    def overall_successful_delta(self) -> float:
        b = sum(d.baseline.n_successful for d in self.days)
        m = sum(d.minos.n_successful for d in self.days)
        return (m - b) / b

    @property
    def overall_cost_saving(self) -> float:
        b = sum(d.baseline.cost.total for d in self.days) / max(
            1, sum(d.baseline.cost.n_successful for d in self.days))
        m = sum(d.minos.cost.total for d in self.days) / max(
            1, sum(d.minos.cost.n_successful for d in self.days))
        return improvement(b, m)


def run_pretest_phase(
    variation: VariationModel,
    spec: FunctionSpec = PAPER_SPEC,
    pricing: Pricing = PAPER_PRICING,
    *,
    n_vus: int = 10,
    duration_ms: float = 60_000.0,
    seed: int = 1234,
    pass_fraction: float = PASS_FRACTION,
) -> float:
    """§III-A: measure the elysium threshold with a short unguarded run."""
    disabled = MinosPolicy(elysium_threshold=float("inf"), enabled=False)
    plat = FaaSPlatform(spec, variation, disabled, pricing, seed=seed)
    run_closed_loop(plat, n_vus=n_vus, duration_ms=duration_ms)
    # the unguarded platform never benchmarks; probe durations are what the
    # probe WOULD have shown: work / speed of each started instance. During
    # pre-testing we benchmark explicitly (it is the pre-test's purpose).
    speeds = [r.instance_speed for r in plat.results if r.served_by_cold]
    if not speeds:
        speeds = [r.instance_speed for r in plat.results]
    probes = [spec.benchmark_ms / s for s in speeds]
    return pretest_threshold(probes, pass_fraction)


def run_day(
    day: int,
    variation: VariationModel,
    *,
    spec: FunctionSpec = PAPER_SPEC,
    pricing: Pricing = PAPER_PRICING,
    n_vus: int = 10,
    duration_ms: float = 30 * 60 * 1000.0,
    max_retries: int = 5,
    seed: int = 0,
    threshold: float | None = None,
    include_adaptive: bool = False,
) -> DayResult:
    if threshold is None:
        threshold = run_pretest_phase(variation, spec, pricing, seed=seed * 7919 + day)

    base_policy = make_arm_policy("disabled")
    base_plat = FaaSPlatform(spec, variation, base_policy, pricing, seed=seed * 31 + day)
    base_results = run_closed_loop(base_plat, n_vus=n_vus, duration_ms=duration_ms)

    minos_policy = make_arm_policy("fixed", threshold=threshold, max_retries=max_retries)
    minos_plat = FaaSPlatform(spec, variation, minos_policy, pricing, seed=seed * 37 + day)
    minos_results = run_closed_loop(minos_plat, n_vus=n_vus, duration_ms=duration_ms)

    adaptive_summary = None
    if include_adaptive:
        ad_policy = make_arm_policy("adaptive", max_retries=max_retries)
        ad_plat = FaaSPlatform(spec, variation, ad_policy, pricing, seed=seed * 41 + day)
        ad_results = run_closed_loop(ad_plat, n_vus=n_vus, duration_ms=duration_ms)
        adaptive_summary = ArmSummary.from_platform("adaptive", ad_plat, ad_results)

    return DayResult(
        day=day,
        variation=variation,
        elysium_threshold=threshold,
        baseline=ArmSummary.from_platform("baseline", base_plat, base_results),
        minos=ArmSummary.from_platform("minos", minos_plat, minos_results),
        timeline_baseline=cost_timeline(
            base_results, base_plat.cost, duration_ms,
            termination_events=base_plat.termination_events),
        timeline_minos=cost_timeline(
            minos_results, minos_plat.cost, duration_ms,
            termination_events=minos_plat.termination_events),
        adaptive=adaptive_summary,
    )


def run_week(
    seed: int = 0,
    n_days: int = 7,
    *,
    spec: FunctionSpec = PAPER_SPEC,
    pricing: Pricing = PAPER_PRICING,
    n_vus: int = 10,
    duration_ms: float = 30 * 60 * 1000.0,
    stale_threshold: bool = False,
) -> WeekResult:
    """The full 7-day experiment (paper: 2025-02-03 .. 02-09, 3-4 pm UTC).

    ``stale_threshold=False`` (default) pre-tests before each day's run —
    the paper repeats the experiment "every day at the same time", with the
    threshold measured by a short pre-test before the runs. This is the
    robust protocol: across seeds it lands on the paper's numbers (analysis
    ~7-9 % faster, cost ~+1 %, max day ~3.3 %).

    ``stale_threshold=True`` pre-tests ONCE and reuses the threshold all
    week; day-to-day platform drift then de-calibrates the gate — a fast
    day passes nearly everyone (little benefit), a slow day terminates
    excessively (waste, emergency exits). Used by the ablation benchmark to
    show why the §IV online recalculation matters."""
    week = paper_week(seed=seed, n_days=n_days)
    threshold = (
        run_pretest_phase(week[0], spec, pricing, seed=seed * 7919)
        if stale_threshold
        else None
    )
    days = []
    for day, variation in enumerate(week):
        days.append(
            run_day(day, variation, spec=spec, pricing=pricing,
                    n_vus=n_vus, duration_ms=duration_ms, seed=seed,
                    threshold=threshold)
        )
    return WeekResult(days)
