"""Online statistical estimators used for elysium-threshold maintenance.

The paper (§IV, "Online calculation of the elysium threshold") proposes
updating the threshold live from streaming benchmark results without storing
observations: the mean can be maintained exactly online, the standard
deviation via Welford's algorithm [13, Welford 1962], and percentiles via
the P² algorithm [12, Jain & Chlamtac 1985].

This module holds the plain-Python forms that the controller and the
substrate use, copied from ``repro.core.estimators``. The batched forms that
fold a fleet of simulated instances into one program (``WelfordState``,
``P2State`` and their update functions) belong to the vectorized path and are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# ---------------------------------------------------------------------------
# Welford mean / variance
# ---------------------------------------------------------------------------


class Welford:
    """Exact online mean and variance (Welford 1962).

    Stores O(1) state: count, running mean, and M2 (sum of squared
    deviations). ``variance`` is the unbiased sample variance.
    """

    __slots__ = ("count", "mean", "m2")

    def __init__(self) -> None:
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)

    def update_many(self, xs) -> None:
        for x in xs:
            self.update(float(x))

    @property
    def variance(self) -> float:
        if self.count < 2:
            return 0.0
        return self.m2 / (self.count - 1)

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)

    def merge(self, other: "Welford") -> "Welford":
        """Chan et al. parallel merge — lets distributed collectors combine."""
        out = Welford()
        n = self.count + other.count
        if n == 0:
            return out
        delta = other.mean - self.mean
        out.count = n
        out.mean = self.mean + delta * other.count / n
        out.m2 = self.m2 + other.m2 + delta * delta * self.count * other.count / n
        return out




# ---------------------------------------------------------------------------
# P² quantile estimator (Jain & Chlamtac 1985)
# ---------------------------------------------------------------------------


class P2Quantile:
    """P² dynamic quantile estimation without storing observations.

    Maintains 5 markers whose heights converge to the (0, p/2, p, (1+p)/2, 1)
    quantiles. After the first five observations the estimate is available in
    O(1) memory. This is the paper's cited mechanism for online percentile
    estimation of benchmark results.
    """

    __slots__ = ("p", "n_obs", "heights", "positions", "desired", "increments")

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0,1), got {p}")
        self.p = p
        self.n_obs = 0
        self.heights: list[float] = []
        self.positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.desired = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p, 3.0 + 2.0 * p, 5.0]
        self.increments = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def update(self, x: float) -> None:
        x = float(x)
        if self.n_obs < 5:
            self.heights.append(x)
            self.n_obs += 1
            if self.n_obs == 5:
                self.heights.sort()
            return
        self.n_obs += 1
        q = self.heights
        # locate cell k such that q[k] <= x < q[k+1]
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= q[i]:
                    k = i
        for i in range(k + 1, 5):
            self.positions[i] += 1.0
        for i in range(5):
            self.desired[i] += self.increments[i]
        # adjust interior markers 1..3
        for i in range(1, 4):
            d = self.desired[i] - self.positions[i]
            n_i, n_im, n_ip = self.positions[i], self.positions[i - 1], self.positions[i + 1]
            if (d >= 1.0 and n_ip - n_i > 1.0) or (d <= -1.0 and n_im - n_i < -1.0):
                d_sign = 1.0 if d >= 0 else -1.0
                # parabolic (P²) prediction
                q_new = q[i] + d_sign / (n_ip - n_im) * (
                    (n_i - n_im + d_sign) * (q[i + 1] - q[i]) / (n_ip - n_i)
                    + (n_ip - n_i - d_sign) * (q[i] - q[i - 1]) / (n_i - n_im)
                )
                if q[i - 1] < q_new < q[i + 1]:
                    q[i] = q_new
                else:  # linear fallback
                    j = i + int(d_sign)
                    q[i] = q[i] + d_sign * (q[j] - q[i]) / (self.positions[j] - n_i)
                self.positions[i] += d_sign

    def update_many(self, xs) -> None:
        for x in xs:
            self.update(float(x))

    @property
    def value(self) -> float:
        if self.n_obs == 0:
            raise ValueError("no observations")
        if self.n_obs < 5:
            # exact small-sample quantile
            return float(np.quantile(np.asarray(self.heights[: self.n_obs]), self.p))
        return self.heights[2]




# ---------------------------------------------------------------------------
# Exponential moving average (used for drift-tracking thresholds)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EMA:
    alpha: float
    value: float | None = None

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else self.alpha * x + (1 - self.alpha) * self.value
        return self.value
