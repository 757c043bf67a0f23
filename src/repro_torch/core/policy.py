"""MinosPolicy — the local pass/terminate decision (paper §II-A, §II-B).

A newly started instance runs a benchmark and compares the result against a
single scalar, the *elysium threshold*, stored in the function
configuration. No outside communication is needed during the call.

Conventions: benchmark results are *durations* (lower is better) by default;
``higher_is_better=True`` flips the comparison for throughput-style metrics.

The *emergency exit* (§II-A) prevents infinite requeue loops: if an
invocation has already been requeued ``max_retries`` times, the instance
accepts it without benchmarking. Sizing it means picking the termination
rate the bound must survive. With the repo's default gate — threshold at
the 40th percentile, i.e. a 40 % *pass* rate — the termination rate is
60 % and P(5 consecutive terminations) = 0.6^5 ≈ 8 % of invocations hit
the exit. The paper's own example instead assumes a 40 % *termination*
rate (a laxer, 60 %-pass gate), giving 0.4^5 ≈ 1 %. Same formula,
different operating point: max_retries=5 is comfortable for a lax gate
but spends the exit on ~1 in 12 invocations at pass fraction 0.4 — use
:func:`retries_for_runaway_budget` to size it for your gate.
"""
from __future__ import annotations

import dataclasses
import math
from enum import Enum


class Verdict(Enum):
    PASS = "pass"            # instance joins the known-good pool
    TERMINATE = "terminate"  # requeue invocation, crash instance
    FORCED_PASS = "forced_pass"  # emergency exit — accepted without/despite benchmark


@dataclasses.dataclass(frozen=True)
class MinosPolicy:
    """The instance-local decision rule.

    elysium_threshold: benchmark result an instance must beat to live.
    max_retries: emergency-exit bound on requeues per invocation.
    higher_is_better: metric direction (False for durations).
    enabled: with False, every instance passes (the paper's baseline arm).
    """

    elysium_threshold: float
    max_retries: int = 5
    higher_is_better: bool = False
    enabled: bool = True

    def passes(self, benchmark_result: float) -> bool:
        if self.higher_is_better:
            return benchmark_result >= self.elysium_threshold
        return benchmark_result <= self.elysium_threshold

    def judge(self, benchmark_result: float, retry_count: int) -> Verdict:
        """Decide the fate of a cold-started instance.

        retry_count is the number of times THIS invocation has already been
        requeued by terminated instances.
        """
        if not self.enabled:
            return Verdict.PASS
        if retry_count >= self.max_retries:
            return Verdict.FORCED_PASS
        return Verdict.PASS if self.passes(benchmark_result) else Verdict.TERMINATE

    def should_benchmark(self, retry_count: int, is_cold_start: bool) -> bool:
        """Warm instances are never re-benchmarked (paper §II-B: short-lived
        instances make re-running benchmarks unnecessary); emergency-exit
        invocations skip the benchmark entirely."""
        if not self.enabled or not is_cold_start:
            return False
        return retry_count < self.max_retries


class AdaptiveMinosPolicy:
    """The §IV policy: elysium threshold maintained *online* from streaming
    probe results — no pre-test phase (DESIGN.md §6).

    Drop-in for :class:`MinosPolicy` at the platform boundary (``judge`` /
    ``passes`` / ``should_benchmark`` / ``elysium_threshold``), but mutable:
    the platform calls :meth:`report` with every cold-start probe result
    (passing AND failing — a survivor-only stream ratchets the threshold
    down forever), and the threshold follows an
    :class:`~repro_torch.core.elysium.OnlineElysiumController` (P² percentile +
    Welford moments + EMA republish, all O(1) memory).

    Warm-up replaces pre-testing: until ``warmup_reports`` probes have been
    observed the policy passes every instance (it is *collecting* the
    distribution, exactly what the pre-test did — but on production traffic,
    so no separate unguarded phase is billed). The default is P²'s minimum
    (5): every instance admitted unjudged during warm-up pollutes the warm
    pool until platform churn evicts it, so the gate should arm as early as
    the estimate exists (EXPERIMENTS.md §Workflow sweep quantifies this).
    With ``initial_threshold`` set, the warm-up gate uses it instead of
    passing everyone (the stale-threshold degraded mode the paper requires
    on controller failure).
    """

    def __init__(
        self,
        pass_fraction: float = 0.4,
        *,
        max_retries: int = 5,
        warmup_reports: int = 5,
        republish_every: int = 4,
        smoothing_alpha: float = 0.7,
        initial_threshold: float | None = None,
        higher_is_better: bool = False,
    ) -> None:
        from .elysium import OnlineElysiumController  # avoid import cycle at module load

        if warmup_reports < 5:
            raise ValueError("warmup_reports must be >= 5 (P² needs 5 markers)")
        self.pass_fraction = pass_fraction
        self.max_retries = max_retries
        self.warmup_reports = warmup_reports
        self.higher_is_better = higher_is_better
        self.enabled = True
        self._initial_threshold = initial_threshold
        # durations: pass the fastest pass_fraction ⇒ threshold at the
        # pass_fraction quantile; throughput-style (higher is better):
        # passing the top pass_fraction needs the (1 - pass_fraction) one
        self.controller = OnlineElysiumController(
            pass_fraction=(1.0 - pass_fraction) if higher_is_better else pass_fraction,
            republish_every=republish_every,
            smoothing_alpha=smoothing_alpha,
            initial_threshold=initial_threshold,
        )

    # -- streaming input ------------------------------------------------
    def report(self, benchmark_result: float) -> None:
        """Feed one cold-start probe observation to the estimators. The
        platform calls this for every probed instance before judging it."""
        self.controller.report(benchmark_result)

    @property
    def warmed_up(self) -> bool:
        return self.controller.n_reports >= self.warmup_reports

    @property
    def elysium_threshold(self) -> float:
        """Current effective threshold. During warm-up: the initial
        threshold if one was given, else pass-everything (the estimate off
        a handful of probes is not worth terminating on)."""
        if not self.warmed_up and self._initial_threshold is None:
            return -math.inf if self.higher_is_better else math.inf
        return self.controller.threshold

    # -- MinosPolicy-compatible decision surface ------------------------
    def passes(self, benchmark_result: float) -> bool:
        thr = self.elysium_threshold
        if self.higher_is_better:
            return benchmark_result >= thr
        return benchmark_result <= thr

    def judge(self, benchmark_result: float, retry_count: int) -> Verdict:
        if not self.enabled:
            return Verdict.PASS
        if retry_count >= self.max_retries:
            return Verdict.FORCED_PASS
        return Verdict.PASS if self.passes(benchmark_result) else Verdict.TERMINATE

    def should_benchmark(self, retry_count: int, is_cold_start: bool) -> bool:
        # identical to MinosPolicy — warm-up instances still benchmark (the
        # probe result is the estimator's training signal) but always pass.
        if not self.enabled or not is_cold_start:
            return False
        return retry_count < self.max_retries


def runaway_probability(termination_rate: float, retries: int) -> float:
    """P(an invocation is terminated ``retries`` times in a row).

    Paper example: at an expected termination rate of 40 %
    (``termination_rate=0.4``, i.e. a gate that passes 60 % of fresh
    instances), 0.4^5 ≈ 1 %. At the repo default pass fraction 0.4 the
    termination rate is 0.6 and the same bound gives 0.6^5 ≈ 8 % (see the
    module docstring).
    """
    if not 0.0 <= termination_rate <= 1.0:
        raise ValueError("termination_rate must be in [0,1]")
    return termination_rate**retries


def retries_for_runaway_budget(termination_rate: float, budget: float) -> int:
    """Smallest max_retries such that P(runaway) <= budget."""
    if termination_rate <= 0.0:
        return 1
    if termination_rate >= 1.0:
        raise ValueError("termination_rate 1.0 never converges")
    if not 0.0 < budget < 1.0:
        raise ValueError("budget must be in (0,1)")
    return max(1, math.ceil(math.log(budget) / math.log(termination_rate)))


def expected_cold_start_attempts(termination_rate: float, max_retries: int) -> float:
    """Expected number of instance starts per invocation under the policy
    (geometric, truncated by the emergency exit).

    E[starts] = sum_{k=0}^{r-1} t^k  (+ the forced-pass attempt when all
    r retries terminated is already counted by the k=r-1 term's requeue).
    """
    t = termination_rate
    if t == 1.0:
        return float(max_retries + 1)
    # attempts: 1 + t + t^2 + ... + t^max_retries (forced pass at the end)
    return (1.0 - t ** (max_retries + 1)) / (1.0 - t)
