"""Online statistical estimators used for elysium-threshold maintenance.

The paper (§IV, "Online calculation of the elysium threshold") proposes
updating the threshold live from streaming benchmark results without storing
observations: the mean can be maintained exactly online, the standard
deviation via Welford's algorithm [13, Welford 1962], and percentiles via
the P² algorithm [12, Jain & Chlamtac 1985].

Every estimator is provided in two forms:

* a plain-Python class (used by the controller / simulator hot path), copied
  from ``repro.core.estimators``, and
* a batched torch form (a NamedTuple state of tensors + ``update``
  functions), the counterpart of the reference's pure-JAX pytree form. Every
  field has the lane axes leading (any shape, ``()`` included; P² keeps its
  five markers on a trailing axis), and every update is elementwise and
  branch-free, so the vectorized simulator folds a fleet of lanes in one
  step with no host sync and the step can be captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

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


class WelfordState(NamedTuple):
    """Batched Welford state: ``count``, ``mean`` and ``m2`` share one shape
    (the lane axes), float32 unless asked otherwise."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(shape=(), dtype=torch.float32, device=None) -> WelfordState:
    """Welford state of ``shape`` independent streams, all empty."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return WelfordState(count=z, mean=z, m2=z)


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_update_masked(
    state: WelfordState, x: torch.Tensor, mask: torch.Tensor
) -> WelfordState:
    """:func:`welford_update` where ``mask`` is true, identity where not —
    arithmetic masking, as the reference's, so the lanes that skip the
    observation keep their state bit for bit."""
    m = mask.to(state.count.dtype)
    count = state.count + m
    delta = x - state.mean
    mean = state.mean + m * delta / torch.clamp(count, min=1.0)
    m2 = state.m2 + m * delta * (x - mean)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_variance(state: WelfordState) -> torch.Tensor:
    return torch.where(state.count < 2.0, 0.0,
                       state.m2 / torch.clamp(state.count - 1.0, min=1.0))


def welford_std(state: WelfordState) -> torch.Tensor:
    return torch.sqrt(welford_variance(state))


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan et al. parallel merge, lane by lane; two empty sides give an
    empty state."""
    n = a.count + b.count
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * b.count / safe_n
    m2 = a.m2 + b.m2 + delta * delta * a.count * b.count / safe_n
    return WelfordState(count=n, mean=torch.where(n == 0, 0.0, mean),
                        m2=torch.where(n == 0, 0.0, m2))


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


class P2State(NamedTuple):
    """Batched P² state. ``n_obs`` (int32) and ``p`` have the lane shape;
    ``heights``, ``positions`` and ``desired`` add a trailing axis of 5."""

    n_obs: torch.Tensor
    heights: torch.Tensor     # first 5 observations stored raw until full
    positions: torch.Tensor
    desired: torch.Tensor
    p: torch.Tensor


def p2_init(p, device=None) -> P2State:
    """Empty P² state for quantile ``p`` (a float, or a tensor of the lane
    shape: one quantile per lane)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=p.device)
    pe = p[..., None]
    return P2State(
        n_obs=torch.zeros(p.shape, dtype=torch.int32, device=p.device),
        heights=torch.zeros(p.shape + (5,), **f32),
        positions=torch.arange(1.0, 6.0, **f32).expand(p.shape + (5,)).clone(),
        desired=torch.tensor([1.0, 0.0, 0.0, 0.0, 5.0], **f32)
        + torch.tensor([0.0, 2.0, 4.0, 2.0, 0.0], **f32) * pe
        + torch.tensor([0.0, 1.0, 1.0, 3.0, 0.0], **f32),
        p=p,
    )


def _p2_increments(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.zeros_like(p), p / 2.0, p, (1.0 + p) / 2.0,
                        torch.ones_like(p)], dim=-1)


def p2_update(state: P2State, x: torch.Tensor) -> P2State:
    """One P² update of every lane, branch-free. Lanes still in warm-up
    (fewer than 5 observations) store ``x`` raw and sort at the fifth; the
    others move their markers. Both forms are computed for every lane and
    selected per lane, as the reference's ``lax.cond`` does under ``vmap``;
    the warm-up write is a one-hot select, so a lane in the steady state
    (``n_obs >= 5``) writes nothing, as JAX drops that out-of-bounds write."""
    x = torch.as_tensor(x, dtype=torch.float32, device=state.heights.device)
    idx = torch.arange(5, device=state.heights.device)

    # warm-up
    h_w = torch.where(idx == state.n_obs[..., None], x[..., None], state.heights)
    n_w = state.n_obs + 1
    h_w = torch.where((n_w >= 5)[..., None], torch.sort(h_w, dim=-1).values, h_w)

    # steady state
    q = state.heights
    below = x < q[..., 0]
    above = x >= q[..., 4]
    q = torch.cat([torch.where(below, x, q[..., 0])[..., None], q[..., 1:4],
                   torch.where(above, x, q[..., 4])[..., None]], dim=-1)
    # cell index k in [0,3]
    k_mid = (x[..., None] >= q[..., 1:4]).to(torch.int32).sum(-1, dtype=torch.int32)
    k = torch.where(below, 0, torch.where(above, 3, k_mid))
    pos = state.positions + (idx > k[..., None]).to(torch.float32)
    des = state.desired + _p2_increments(state.p)
    qs = [q[..., j] for j in range(5)]
    ps = [pos[..., j] for j in range(5)]
    for i in range(1, 4):
        d = des[..., i] - ps[i]
        n_i, n_im, n_ip = ps[i], ps[i - 1], ps[i + 1]
        move_up = (d >= 1.0) & (n_ip - n_i > 1.0)
        move_dn = (d <= -1.0) & (n_im - n_i < -1.0)
        do = move_up | move_dn
        s_ = torch.where(move_up, 1.0, -1.0)
        denom_hi = torch.where(n_ip - n_i == 0, 1.0, n_ip - n_i)
        denom_lo = torch.where(n_i - n_im == 0, 1.0, n_i - n_im)
        q_par = qs[i] + s_ / (n_ip - n_im) * (
            (n_i - n_im + s_) * (qs[i + 1] - qs[i]) / denom_hi
            + (n_ip - n_i - s_) * (qs[i] - qs[i - 1]) / denom_lo
        )
        ok = (qs[i - 1] < q_par) & (q_par < qs[i + 1])
        q_j = torch.where(move_up, qs[i + 1], qs[i - 1])
        pos_j = torch.where(move_up, ps[i + 1], ps[i - 1])
        denom_lin = torch.where(pos_j - n_i == 0, 1.0, pos_j - n_i)
        q_lin = qs[i] + s_ * (q_j - qs[i]) / denom_lin
        q_new = torch.where(ok, q_par, q_lin)
        qs[i] = torch.where(do, q_new, qs[i])
        ps[i] = torch.where(do, n_i + s_, n_i)
    h_s = torch.stack(qs, dim=-1)
    pos_s = torch.stack(ps, dim=-1)

    warm = state.n_obs < 5
    warm5 = warm[..., None]
    return P2State(
        n_obs=state.n_obs + 1,
        heights=torch.where(warm5, h_w, h_s),
        positions=torch.where(warm5, state.positions, pos_s),
        desired=torch.where(warm5, state.desired, des),
        p=state.p,
    )


def p2_value(state: P2State) -> torch.Tensor:
    """Current quantile estimate of every lane. In warm-up (<5 obs) the
    p-quantile of the raw stored observations, linearly interpolated."""
    n = state.n_obs
    idx = torch.arange(5, device=state.heights.device)
    h = torch.sort(torch.where(idx < torch.clamp(n, min=1)[..., None],
                               state.heights, torch.inf), dim=-1).values
    pos = state.p * (n.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int32), 0, 4)
    hi = torch.minimum(torch.clamp(lo + 1, 0, 4), torch.clamp(n - 1, min=0))
    frac = pos - torch.floor(pos)
    lo_v = torch.gather(h, -1, lo.long()[..., None])[..., 0]
    hi_v = torch.gather(h, -1, hi.long()[..., None])[..., 0]
    warm = lo_v * (1 - frac) + hi_v * frac
    return torch.where(n < 5, warm, state.heights[..., 2])


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
