"""The Minos cost model (paper Fig. 3) and provider pricing tables.

    c_total = c_exec * (sum d_term + sum d_pass + sum d_reuse)
            + c_inv  * (n_term + n_pass + n_reuse)

where *term* are invocations whose instance failed the benchmark and was
terminated (their duration is prepare+benchmark only), *pass* are cold-start
invocations that passed and ran the full body, and *reuse* are warm-instance
invocations (no benchmark at all).

Pricing is parameterized so the same model covers Google Cloud Functions
(the paper's platform), AWS-Lambda-style pricing, and an accelerator
"chip-second" model used by the serving integration.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

# Google Cloud Functions pricing (europe-west Tier-1 list prices):
#   invocations $0.40/1M; compute $2.5e-6/GiB-s + $1.0e-5/GHz-s (gen1
#   CPU allocation per tier), large tiers per Cloud-Run-style vCPU-s.
# Folded into one $/ms rate per tier. The paper's observation holds: the
# per-invocation fee is worth only a handful-to-tens of ms of execution,
# shrinking as the tier grows (<3 ms at 32 GB), so execution cost dominates
# and Minos' extra terminated invocations amortize quickly (§II-A, Fig 3).
_GCF_PER_INVOCATION = 0.4e-6  # $ per invocation ($0.40 / 1M)
_GCF_GEN1 = {
    # memory_mb: (mem_gib, cpu_ghz)
    128: (0.125, 0.2),
    256: (0.25, 0.4),
    512: (0.5, 0.8),
    1024: (1.0, 1.4),
    2048: (2.0, 2.4),
    4096: (4.0, 4.8),
    8192: (8.0, 4.8),
}
_GCF_TIERS_MS = {
    mb: (gib * 2.5e-6 + ghz * 1.0e-5) / 1000.0 for mb, (gib, ghz) in _GCF_GEN1.items()
}
# gen2 tiers (vCPU-s $2.4e-5, GiB-s $2.5e-6)
_GCF_TIERS_MS[16384] = (16.0 * 2.5e-6 + 4.0 * 2.4e-5) / 1000.0
_GCF_TIERS_MS[32768] = (32.0 * 2.5e-6 + 8.0 * 2.4e-5) / 1000.0


@dataclasses.dataclass(frozen=True)
class Pricing:
    """Linear pay-per-use pricing: fixed per-invocation fee + per-ms rate."""

    cost_per_invocation: float
    cost_per_ms: float
    name: str = "custom"

    @staticmethod
    def gcf(memory_mb: int = 256) -> "Pricing":
        if memory_mb not in _GCF_TIERS_MS:
            raise ValueError(f"unknown GCF tier {memory_mb} MB; tiers: {sorted(_GCF_TIERS_MS)}")
        return Pricing(
            cost_per_invocation=_GCF_PER_INVOCATION,
            cost_per_ms=_GCF_TIERS_MS[memory_mb],
            name=f"gcf-{memory_mb}mb",
        )

    @staticmethod
    def aws_lambda(memory_mb: int = 1024) -> "Pricing":
        """AWS-Lambda-style pricing: $0.20/1M requests + $1.66667e-5/GiB-s,
        CPU allocation proportional to memory (no separate GHz term)."""
        if memory_mb < 128 or memory_mb > 10240:
            raise ValueError(f"Lambda memory must be in [128, 10240] MB, got {memory_mb}")
        return Pricing(
            cost_per_invocation=0.2e-6,
            cost_per_ms=(memory_mb / 1024.0) * 1.66667e-5 / 1000.0,
            name=f"lambda-{memory_mb}mb",
        )

    @staticmethod
    def tpu_chip_seconds(chips: int, usd_per_chip_hour: float = 1.2) -> "Pricing":
        """Accelerator-serving analogue: a replica of ``chips`` chips billed
        per ms of occupancy; 'invocations' (request dispatches) are free."""
        return Pricing(
            cost_per_invocation=0.0,
            cost_per_ms=chips * usd_per_chip_hour / 3600.0 / 1000.0,
            name=f"tpu-{chips}chips",
        )

    @property
    def invocation_break_even_ms(self) -> float:
        """How many ms of execution cost the same as one invocation fee.

        Paper §II-A: ~50 ms at 128 MB, <3 ms at 32 GB. Used to reason about
        when Minos' extra (terminated) invocations amortize.
        """
        if self.cost_per_ms == 0.0:
            return float("inf")
        return self.cost_per_invocation / self.cost_per_ms

    def invocation_cost(self, duration_ms: float) -> float:
        return self.cost_per_invocation + self.cost_per_ms * duration_ms


@dataclasses.dataclass
class WorkflowCost:
    """Accumulates Fig-3 terms over a workflow run."""

    pricing: Pricing
    n_term: int = 0
    n_pass: int = 0
    n_reuse: int = 0
    d_term_ms: float = 0.0
    d_pass_ms: float = 0.0
    d_reuse_ms: float = 0.0

    def record_terminated(self, duration_ms: float) -> None:
        self.n_term += 1
        self.d_term_ms += duration_ms

    def record_passed(self, duration_ms: float) -> None:
        self.n_pass += 1
        self.d_pass_ms += duration_ms

    def record_reused(self, duration_ms: float) -> None:
        self.n_reuse += 1
        self.d_reuse_ms += duration_ms

    @property
    def n_invocations(self) -> int:
        return self.n_term + self.n_pass + self.n_reuse

    @property
    def n_successful(self) -> int:
        """Invocations that actually ran the function body."""
        return self.n_pass + self.n_reuse

    @property
    def exec_cost(self) -> float:
        return self.pricing.cost_per_ms * (self.d_term_ms + self.d_pass_ms + self.d_reuse_ms)

    @property
    def invocation_fees(self) -> float:
        return self.pricing.cost_per_invocation * self.n_invocations

    @property
    def total(self) -> float:
        return self.exec_cost + self.invocation_fees

    @property
    def cost_per_successful(self) -> float:
        if self.n_successful == 0:
            return float("nan")
        return self.total / self.n_successful

    def cost_per_million_successful(self) -> float:
        return self.cost_per_successful * 1e6

    def merge(self, other: "WorkflowCost") -> "WorkflowCost":
        assert self.pricing == other.pricing
        return WorkflowCost(
            self.pricing,
            self.n_term + other.n_term,
            self.n_pass + other.n_pass,
            self.n_reuse + other.n_reuse,
            self.d_term_ms + other.d_term_ms,
            self.d_pass_ms + other.d_pass_ms,
            self.d_reuse_ms + other.d_reuse_ms,
        )


def total_cost(
    pricing: Pricing,
    d_term: Iterable[float],
    d_pass: Iterable[float],
    d_reuse: Iterable[float],
) -> float:
    """Direct transliteration of Fig. 3 for tests/docs."""
    d_term, d_pass, d_reuse = list(d_term), list(d_pass), list(d_reuse)
    exec_cost = pricing.cost_per_ms * (sum(d_term) + sum(d_pass) + sum(d_reuse))
    inv_cost = pricing.cost_per_invocation * (len(d_term) + len(d_pass) + len(d_reuse))
    return exec_cost + inv_cost
