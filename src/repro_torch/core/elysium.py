"""Elysium-threshold calculation (paper §II-B, §III-A, §IV).

Two modes:

* **Pre-testing** (what the paper's prototype does): run a short unguarded
  workload (e.g. 10 VUs × 1 min), collect benchmark durations, and set the
  threshold at the p-th percentile (paper: 60th ⇒ only the fastest 40 % of
  fresh instances pass). The threshold is then passed to the function as
  configuration.

* **Online controller** (paper §IV future work): instances report benchmark
  results to a (non-critical) centralized component that maintains the
  percentile with O(1)-memory streaming estimators (P² [12], Welford [13])
  and periodically republishes the threshold. Its failure only degrades
  optimality, never correctness.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from .estimators import EMA, P2Quantile, Welford


def pretest_threshold(benchmark_results: Sequence[float], pass_fraction: float = 0.4) -> float:
    """Threshold such that approximately ``pass_fraction`` of the observed
    population passes (durations: lower is better ⇒ threshold is the
    (pass_fraction)-quantile; paper's 60th percentile == pass_fraction 0.4).
    """
    if not 0.0 < pass_fraction < 1.0:
        raise ValueError("pass_fraction must be in (0,1)")
    results = np.asarray(list(benchmark_results), dtype=np.float64)
    if results.size == 0:
        raise ValueError("pre-testing produced no benchmark results")
    return float(np.quantile(results, pass_fraction))


@dataclasses.dataclass
class PretestReport:
    threshold: float
    pass_fraction: float
    n_samples: int
    mean: float
    std: float
    p50: float
    p90: float


def run_pretest(
    benchmark_results: Iterable[float], pass_fraction: float = 0.4
) -> PretestReport:
    results = np.asarray(list(benchmark_results), dtype=np.float64)
    return PretestReport(
        threshold=pretest_threshold(results, pass_fraction),
        pass_fraction=pass_fraction,
        n_samples=int(results.size),
        mean=float(results.mean()),
        std=float(results.std(ddof=1)) if results.size > 1 else 0.0,
        p50=float(np.quantile(results, 0.5)),
        p90=float(np.quantile(results, 0.9)),
    )


class OnlineElysiumController:
    """§IV online threshold recalculation with O(1) memory.

    Not a single point of failure: consumers cache the last published
    threshold; if the controller dies, behavior degrades to stale-threshold
    Minos, which is exactly the pre-testing prototype.
    """

    def __init__(
        self,
        pass_fraction: float = 0.4,
        republish_every: int = 32,
        smoothing_alpha: float = 0.3,
        initial_threshold: float | None = None,
    ) -> None:
        if not 0.0 < pass_fraction < 1.0:
            raise ValueError("pass_fraction must be in (0,1)")
        self.pass_fraction = pass_fraction
        self.republish_every = republish_every
        self._p2 = P2Quantile(pass_fraction)
        self._welford = Welford()
        self._ema = EMA(smoothing_alpha, initial_threshold)
        self._since_publish = 0
        self._published = initial_threshold
        self.n_reports = 0

    def report(self, benchmark_result: float) -> None:
        """An instance reports its cold-start benchmark result.

        IMPORTANT: both passing and failing instances report, otherwise the
        estimate is survivor-biased and the threshold ratchets downward
        forever.
        """
        self._p2.update(benchmark_result)
        self._welford.update(benchmark_result)
        self.n_reports += 1
        self._since_publish += 1
        if self._since_publish >= self.republish_every:
            self._publish()

    def _publish(self) -> None:
        self._published = self._ema.update(self._p2.value)
        self._since_publish = 0

    @property
    def threshold(self) -> float:
        if self._published is None:
            if self.n_reports == 0:
                raise ValueError("no benchmark reports yet and no initial threshold")
            return self._p2.value
        return self._published

    @property
    def population_mean(self) -> float:
        return self._welford.mean

    @property
    def population_std(self) -> float:
        return self._welford.std


def optimal_pass_fraction(
    *,
    benchmark_ms: float,
    body_ms: float,
    expected_reuses: float,
    speedup_at_fraction,
    fractions: Sequence[float] = tuple(np.linspace(0.05, 0.95, 19)),
) -> float:
    """Cost-optimal pass fraction (paper §II-A trade-off), by direct search.

    Keeping only the fastest ``f`` fraction costs
        E[starts] ≈ 1/f  cold starts (each wasting ~benchmark_ms)
    but every subsequent execution runs at speedup ``speedup_at_fraction(f)``
    (mean speed of the top-f fraction of the speed distribution).

    total(f) ≈ (1/f) * benchmark_ms + (1 + expected_reuses) * body_ms / speedup(f)

    Returns the argmin over the candidate grid. This is the quantitative
    form of "the optimal termination rate depends on the duration of the
    workload, the performance variability of the platform, and the relative
    time of the benchmark".
    """
    best_f, best_cost = None, float("inf")
    for f in fractions:
        waste = benchmark_ms / f
        work = (1.0 + expected_reuses) * body_ms / float(speedup_at_fraction(f))
        cost = waste + work
        if cost < best_cost:
            best_f, best_cost = float(f), cost
    assert best_f is not None
    return best_f
