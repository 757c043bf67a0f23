"""Fleet-level failure resilience: per-fleet circuit breakers
(DESIGN.md §15).

The engine-level :class:`~repro_torch.faults.RecoveryPolicy` retries *within*
a fleet; the breaker is the cross-fleet complement — when one fleet's
platform is failing (crash storm, outage window), retrying into it
wastes attempts the router could spend on a healthy fleet. Classic
three-state machine:

* **CLOSED** — traffic flows; outcomes feed a sliding window. When the
  window holds at least ``min_samples`` outcomes and the failure
  fraction reaches ``failure_threshold``, the breaker OPENs.
* **OPEN** — the fleet is skipped (the router fails over through the
  routing policy's ``exclude`` mechanism). After ``open_ms`` the next
  :meth:`allow` probe transitions to HALF_OPEN.
* **HALF_OPEN** — up to ``trial_requests`` trial requests are let
  through. ``trial_requests`` consecutive successes re-CLOSE (window
  cleared — the fleet starts fresh); any failure re-OPENs.

Deliberately clockless-and-RNG-free: simulated time is passed into every
method (the fleet runs on one :class:`~repro_torch.core.substrate.SimClock`),
and state transitions are pure functions of the outcome stream — the
breaker adds zero RNG draws, so arming it cannot shift any seeded
stream. :meth:`allow` is a non-consuming query (safe to ask for several
candidate fleets while failing over); only :meth:`on_route` — called for
the fleet actually routed to — consumes a HALF_OPEN trial slot.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from enum import Enum


class BreakerState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Sliding-window circuit-breaker knobs."""

    window: int = 20              # outcomes the failure rate is judged over
    failure_threshold: float = 0.5
    min_samples: int = 5          # don't judge an almost-empty window
    open_ms: float = 5_000.0      # how long an OPEN breaker rejects
    trial_requests: int = 3       # HALF_OPEN probes before re-closing

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not 0.0 < self.failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got "
                f"{self.failure_threshold}")
        if not 1 <= self.min_samples <= self.window:
            raise ValueError(
                f"min_samples must be in [1, window], got {self.min_samples}")
        if self.open_ms <= 0.0:
            raise ValueError(f"open_ms must be > 0, got {self.open_ms}")
        if self.trial_requests < 1:
            raise ValueError(
                f"trial_requests must be >= 1, got {self.trial_requests}")


class CircuitBreaker:
    """One fleet's breaker. All times are simulated ms, passed in."""

    def __init__(self, config: BreakerConfig = BreakerConfig()) -> None:
        self.config = config
        self.state = BreakerState.CLOSED
        self._outcomes: deque[int] = deque(maxlen=config.window)  # 1 ok / 0 fail
        self._opened_at_ms = 0.0
        self._trials_started = 0
        self._trials_ok = 0
        self.n_opens = 0  # OPEN transitions (observability / sweep rows)

    @property
    def failure_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return 1.0 - sum(self._outcomes) / len(self._outcomes)

    def allow(self, now_ms: float) -> bool:
        """May a request be routed to this fleet right now? Non-consuming
        (lazily performs the timed OPEN → HALF_OPEN transition)."""
        if self.state is BreakerState.OPEN:
            if now_ms - self._opened_at_ms >= self.config.open_ms:
                self.state = BreakerState.HALF_OPEN
                self._trials_started = 0
                self._trials_ok = 0
            else:
                return False
        if self.state is BreakerState.HALF_OPEN:
            return self._trials_started < self.config.trial_requests
        return True

    def on_route(self, now_ms: float) -> None:
        """The router chose this fleet: consume a HALF_OPEN trial slot."""
        if self.state is BreakerState.HALF_OPEN:
            self._trials_started += 1

    def record_success(self, now_ms: float) -> None:
        if self.state is BreakerState.HALF_OPEN:
            self._trials_ok += 1
            if self._trials_ok >= self.config.trial_requests:
                self.state = BreakerState.CLOSED
                self._outcomes.clear()  # recovered: judge the fleet fresh
            return
        self._outcomes.append(1)

    def record_failure(self, now_ms: float) -> None:
        if self.state is BreakerState.HALF_OPEN:
            # a trial failed: straight back to OPEN for another window
            self._open(now_ms)
            return
        if self.state is BreakerState.OPEN:
            return  # stragglers from before the trip change nothing
        self._outcomes.append(0)
        if (len(self._outcomes) >= self.config.min_samples
                and self.failure_rate >= self.config.failure_threshold):
            self._open(now_ms)

    def _open(self, now_ms: float) -> None:
        self.state = BreakerState.OPEN
        self._opened_at_ms = now_ms
        self.n_opens += 1
        self._outcomes.clear()


__all__ = [
    "BreakerConfig",
    "BreakerState",
    "CircuitBreaker",
]
