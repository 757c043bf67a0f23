r"""Function-instance lifecycle state machine (paper Fig. 2).

COLD --prepare+benchmark--> BENCHMARKING --pass--> WARM --reuse*--> EXPIRED
                                  \--fail--> TERMINATED (requeue first)

The platform only ever routes new invocations to WARM instances or starts a
new COLD one; every WARM instance has, by construction, passed the benchmark
on its first invocation — this is the invariant that produces the
known-good pool.
"""
from __future__ import annotations

import dataclasses
import itertools
from enum import Enum
from typing import Optional

from .policy import MinosPolicy, Verdict

_ids = itertools.count()


class InstanceState(Enum):
    COLD = "cold"
    BENCHMARKING = "benchmarking"
    WARM = "warm"
    TERMINATED = "terminated"
    EXPIRED = "expired"


class LifecycleError(RuntimeError):
    pass


@dataclasses.dataclass
class FunctionInstance:
    """One function instance. ``speed_factor`` is the (hidden, platform-
    determined) relative performance of the worker node slot this instance
    landed on — 1.0 is nominal, >1 faster. The instance itself never reads
    it directly; it only observes it through the benchmark."""

    speed_factor: float
    created_at_ms: float = 0.0
    idle_timeout_ms: float = 15 * 60 * 1000.0  # GCF-ish idle reclaim
    state: InstanceState = InstanceState.COLD
    instance_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    benchmark_result: Optional[float] = None
    verdict: Optional[Verdict] = None
    invocations_served: int = 0
    last_used_ms: float = 0.0
    # certification age, read by the control plane's on_reuse decision
    # (ReprobeController): when the instance was last benchmarked (None =
    # never, e.g. forced pass) and how many serves it has since absorbed —
    # the unit the per-serve AR(1) drift model decays in.
    last_probe_ms: Optional[float] = None
    serves_since_probe: int = 0

    def run_benchmark(self, work_ms_at_unit_speed: float) -> float:
        """Execute the probe: observed duration = work / speed."""
        if self.state is not InstanceState.COLD:
            raise LifecycleError(f"benchmark only allowed from COLD, got {self.state}")
        self.state = InstanceState.BENCHMARKING
        self.benchmark_result = work_ms_at_unit_speed / self.speed_factor
        return self.benchmark_result

    def judge(self, policy: MinosPolicy, retry_count: int) -> Verdict:
        if self.state is not InstanceState.BENCHMARKING:
            raise LifecycleError(f"judge only allowed from BENCHMARKING, got {self.state}")
        assert self.benchmark_result is not None
        self.verdict = policy.judge(self.benchmark_result, retry_count)
        if self.verdict is Verdict.TERMINATE:
            self.state = InstanceState.TERMINATED
        else:
            self.state = InstanceState.WARM
        return self.verdict

    def accept_without_benchmark(self) -> None:
        """Emergency-exit path and the baseline (Minos disabled) path."""
        if self.state not in (InstanceState.COLD, InstanceState.BENCHMARKING):
            raise LifecycleError(f"cannot accept from {self.state}")
        self.verdict = Verdict.FORCED_PASS
        self.state = InstanceState.WARM

    def serve(self, now_ms: float) -> None:
        if self.state is not InstanceState.WARM:
            raise LifecycleError(f"serve only allowed from WARM, got {self.state}")
        self.invocations_served += 1
        self.serves_since_probe += 1
        self.last_used_ms = now_ms

    def maybe_expire(self, now_ms: float) -> bool:
        if self.state is InstanceState.WARM and now_ms - self.last_used_ms > self.idle_timeout_ms:
            self.state = InstanceState.EXPIRED
            return True
        return False

    @property
    def is_warm(self) -> bool:
        return self.state is InstanceState.WARM

    @property
    def is_dead(self) -> bool:
        return self.state in (InstanceState.TERMINATED, InstanceState.EXPIRED)
