"""Seeded, deterministic platform-fault injection (DESIGN.md §15).

Minos *deliberately* crashes instances (the self-crash + re-queue loop),
but real platforms also fail involuntarily: Night Shift (PAPERS.md)
documents failure-laced variability across providers, and "Unveiling
Overlooked Performance Variance in Serverless Computing" catalogs
variance sources well beyond instance speed. This package injects those
platform-side faults into the substrate in a bit-reproducible way:

* a :class:`FaultPlan` owns a **private** seeded RNG stream — it never
  draws from the engine's RNG, so enabling/disabling faults cannot shift
  any other sampled quantity (the golden-digest bit-identity criterion);
* every fault class is gated behind its own rate knob, and a rate of
  zero draws **nothing** — the fault-free path performs zero extra RNG
  draws (same zero-draw contract as
  :func:`repro_torch.core.substrate.sample_jitter`);
* fleet-scope brownout/outage windows are *schedule*, not randomness:
  :meth:`FaultPlan.speed_multiplier` and :meth:`FaultPlan.unavailable`
  are pure functions of simulated time.

Fault taxonomy (where the engine consults the plan — DESIGN.md §15):

==================  =====================================================
``crash``           instance dies mid-body; work lost, the *partial*
                    duration is billed (Fig-3 ``d_term``), request
                    re-queued or dead-lettered
``cold_start``      instance never comes up; cold-start time billed if
                    the platform bills cold starts
``probe_timeout``   the benchmark probe hangs; the instance is killed
                    after ``probe_timeout_ms`` and that wait is billed
``throttle``        transient admission rejection at submit time
``lost``            body ran (and is billed), but the completion
                    notification is dropped — only a timeout recovers it
``brownout``        windowed speed collapse (body-time multiplier)
``outage``          windowed full unavailability (submits rejected)
==================  =====================================================

:class:`RecoveryPolicy` is the engine-side answer: per-request timeout
budgets (abandon-and-requeue), capped exponential backoff with
decorrelated jitter (:func:`decorrelated_jitter_ms`), and bounded
attempts with a dead-letter terminal state. Static rule R6
(``repro_torch.analysis``) enforces that fault classes draw randomness only
from their injected seeded RNG — no host clock/RNG/IO.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

_WINDOW_KINDS = ("brownout", "outage")


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """A fleet-scope degradation window in simulated time.

    ``brownout`` multiplies body time by ``severity`` (>= 1) for work
    *started* inside the window; ``outage`` rejects submits arriving
    inside it. Windows are half-open ``[start_ms, end_ms)``.
    """

    start_ms: float
    end_ms: float
    kind: str = "brownout"
    severity: float = 2.0

    def __post_init__(self) -> None:
        if self.kind not in _WINDOW_KINDS:
            raise ValueError(
                f"kind must be one of {_WINDOW_KINDS}, got {self.kind!r}")
        if not self.end_ms > self.start_ms >= 0.0:
            raise ValueError(
                f"need 0 <= start_ms < end_ms, got [{self.start_ms}, {self.end_ms})")
        if self.kind == "brownout" and self.severity < 1.0:
            raise ValueError(
                f"brownout severity is a slowdown multiplier, must be >= 1, "
                f"got {self.severity}")

    def active(self, t_ms: float) -> bool:
        return self.start_ms <= t_ms < self.end_ms


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Engine-side failure recovery knobs (DESIGN.md §15).

    ``timeout_ms``: per-*request* end-to-end budget measured from first
    enqueue. When an execution would finish past the deadline the engine
    abandons it (the in-flight work becomes a billed zombie) and
    re-queues the request. ``None`` disables timeouts.

    ``max_attempts``: total dispatch attempts (including the first)
    before the request is dead-lettered — the terminal failure state.

    ``backoff_base_ms`` / ``backoff_cap_ms``: capped exponential backoff
    with decorrelated jitter applied to each re-queue after a failure
    (AWS architecture-blog variant: ``sleep = min(cap, uniform(base,
    prev * 3))``). A base of 0 disables backoff (and draws no RNG).
    """

    timeout_ms: Optional[float] = None
    max_attempts: int = 5
    backoff_base_ms: float = 10.0
    backoff_cap_ms: float = 1000.0

    def __post_init__(self) -> None:
        if self.timeout_ms is not None and self.timeout_ms <= 0.0:
            raise ValueError(f"timeout_ms must be > 0, got {self.timeout_ms}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base_ms < 0.0 or self.backoff_cap_ms < 0.0:
            raise ValueError("backoff base/cap must be >= 0")
        if self.backoff_cap_ms < self.backoff_base_ms:
            raise ValueError(
                f"backoff_cap_ms {self.backoff_cap_ms} < backoff_base_ms "
                f"{self.backoff_base_ms}")


class FaultPlan:
    """Bit-reproducible fault schedule consulted by the engine.

    Owns a private ``RandomState(seed)`` stream: the engine's own RNG is
    never touched, and any fault class with rate 0 draws nothing, so a
    plan with all rates at 0 and no windows is behaviorally invisible.
    """

    def __init__(
        self,
        *,
        seed: int,
        crash_rate: float = 0.0,
        cold_fail_rate: float = 0.0,
        probe_timeout_rate: float = 0.0,
        probe_timeout_ms: float = 1000.0,
        throttle_rate: float = 0.0,
        lost_completion_rate: float = 0.0,
        windows: Sequence[FaultWindow] = (),
    ) -> None:
        for name, rate in (
            ("crash_rate", crash_rate),
            ("cold_fail_rate", cold_fail_rate),
            ("probe_timeout_rate", probe_timeout_rate),
            ("throttle_rate", throttle_rate),
            ("lost_completion_rate", lost_completion_rate),
        ):
            if not 0.0 <= rate < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {rate}")
        if probe_timeout_ms <= 0.0:
            raise ValueError(f"probe_timeout_ms must be > 0, got {probe_timeout_ms}")
        self.seed = seed
        self.crash_rate = crash_rate
        self.cold_fail_rate = cold_fail_rate
        self.probe_timeout_rate = probe_timeout_rate
        self.probe_timeout_ms = probe_timeout_ms
        self.throttle_rate = throttle_rate
        self.lost_completion_rate = lost_completion_rate
        self.windows = tuple(windows)
        # The *only* randomness source this class may touch (rule R6).
        self._rng = np.random.RandomState(seed)

    # -- stochastic fault classes (each rate-gated; 0 -> zero draws) -------

    def _hit(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        return bool(self._rng.random_sample() < rate)

    def crash_mid_body(self, t_ms: float) -> Optional[float]:
        """None, or the fraction of the body completed before the crash
        (uniform in [0, 1) — the partial duration that gets billed)."""
        if not self._hit(self.crash_rate):
            return None
        return float(self._rng.random_sample())

    def cold_start_fails(self, t_ms: float) -> bool:
        return self._hit(self.cold_fail_rate)

    def probe_times_out(self, t_ms: float) -> bool:
        return self._hit(self.probe_timeout_rate)

    def throttled(self, t_ms: float) -> bool:
        return self._hit(self.throttle_rate)

    def completion_lost(self, t_ms: float) -> bool:
        return self._hit(self.lost_completion_rate)

    # -- scheduled degradation windows (pure functions of sim time) --------

    def unavailable(self, t_ms: float) -> bool:
        for w in self.windows:
            if w.kind == "outage" and w.active(t_ms):
                return True
        return False

    def speed_multiplier(self, t_ms: float) -> float:
        mult = 1.0
        for w in self.windows:
            if w.kind == "brownout" and w.active(t_ms):
                mult *= w.severity
        return mult

    def __repr__(self) -> str:  # keeps sweep arm labels readable
        parts = [f"seed={self.seed}"]
        for name in ("crash_rate", "cold_fail_rate", "probe_timeout_rate",
                     "throttle_rate", "lost_completion_rate"):
            v = getattr(self, name)
            if v:
                parts.append(f"{name}={v}")
        if self.windows:
            parts.append(f"windows={len(self.windows)}")
        return f"FaultPlan({', '.join(parts)})"


def decorrelated_jitter_ms(
    rng: np.random.RandomState,
    prev_ms: float,
    *,
    base_ms: float,
    cap_ms: float,
) -> float:
    """One step of capped decorrelated-jitter backoff.

    ``sleep = min(cap, uniform(base, max(base, prev * 3)))`` — each delay
    is drawn relative to the *previous* delay, which de-synchronizes
    retry storms better than plain exponential-with-jitter. ``base <= 0``
    disables backoff and draws nothing.
    """
    if base_ms <= 0.0:
        return 0.0
    hi = max(base_ms, prev_ms * 3.0)
    delay = base_ms + rng.random_sample() * (hi - base_ms)
    return float(min(cap_ms, delay))


__all__ = [
    "FaultPlan",
    "FaultWindow",
    "RecoveryPolicy",
    "decorrelated_jitter_ms",
]
