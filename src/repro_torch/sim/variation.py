"""Performance-variation models for simulated worker nodes.

The paper attributes instance-to-instance variation to co-tenancy on shared
worker nodes (Fig 1) and cites prior work for diurnal platform-level
variation ("night shift" [8]: >10 % faster at night) and day-to-day drift
(Figs 4–6 show the same experiment landing differently across 7 days).

We model an instance's *speed factor* (relative throughput; 1.0 nominal,
higher = faster) as:

    speed = day_factor * diurnal(t) * lognormal(0, sigma_day)

* ``sigma_day`` — contention spread; drawn per day in [0.05, 0.15]. With a
  60th-percentile elysium gate this reproduces the paper's observed
  analysis-step improvement band (4.3 %–13 %): for LogNormal(0, σ), the
  mean speed of the fastest 40 % is E[X]·Φ(σ−z₀.₆)/0.4, i.e. +4.6 % at
  σ=0.05 and +14.7 % at σ=0.15 over the population mean.
* ``day_factor`` — AR(1) day-to-day platform drift.
* ``diurnal`` — low-amplitude time-of-day modulation (experiments all ran
  3–4 pm UTC, so this mostly matters for the longer syntheses).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import stats


@dataclasses.dataclass(frozen=True)
class VariationModel:
    """Per-day node-speed distribution."""

    sigma: float = 0.10           # contention lognormal spread
    day_factor: float = 1.0       # platform-wide multiplicative drift
    diurnal_amplitude: float = 0.0
    diurnal_phase_h: float = 4.0  # peak speed hour (UTC) — night

    def sample_speed(self, rng: np.random.RandomState, t_ms: float = 0.0) -> float:
        base = math.exp(rng.normal(0.0, self.sigma))
        return base * self.day_factor * self.diurnal(t_ms)

    def diurnal(self, t_ms: float) -> float:
        if self.diurnal_amplitude == 0.0:
            return 1.0
        hour = (t_ms / 3.6e6) % 24.0
        return 1.0 + self.diurnal_amplitude * math.cos(
            2.0 * math.pi * (hour - self.diurnal_phase_h) / 24.0
        )

    # ---- analytic properties (used for calibration + tests) ----

    @property
    def mean_speed(self) -> float:
        return math.exp(self.sigma**2 / 2.0) * self.day_factor

    def top_fraction_mean_speed(self, pass_fraction: float) -> float:
        """E[speed | speed above the (1-pass_fraction) speed quantile].

        For X ~ LogNormal(0, σ): E[X | X > q] = E[X] · Φ(σ − z) / f where
        z = Φ⁻¹(1 − f). This is the analytic speed of the Minos-selected
        pool; tests check the simulator converges to it.
        """
        f = pass_fraction
        z = stats.norm.ppf(1.0 - f)
        return self.mean_speed * stats.norm.cdf(self.sigma - z) / f

    def expected_improvement(self, pass_fraction: float) -> float:
        """Expected relative reduction of the CPU-bound step duration when
        only the fastest ``pass_fraction`` of instances serve requests."""
        return 1.0 - self.mean_speed / self.top_fraction_mean_speed(pass_fraction)

    def speed_quantile(self, q: float) -> float:
        """q-quantile of the speed distribution."""
        return math.exp(stats.norm.ppf(q) * self.sigma) * self.day_factor


def paper_week(
    seed: int = 0,
    n_days: int = 7,
    sigma_lo: float = 0.09,
    sigma_hi: float = 0.22,
    drift_rho: float = 0.6,
    drift_scale: float = 0.04,
) -> list[VariationModel]:
    """Seven daily variation models mimicking the paper's experiment week:
    per-day contention sigma (uniform) + AR(1) platform drift."""
    rng = np.random.RandomState(seed)
    models = []
    drift = 0.0
    for _ in range(n_days):
        drift = drift_rho * drift + rng.normal(0.0, drift_scale)
        sigma = rng.uniform(sigma_lo, sigma_hi)
        models.append(VariationModel(sigma=sigma, day_factor=math.exp(drift)))
    return models
