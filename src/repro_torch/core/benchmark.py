"""The Minos benchmark harness (paper §II-C).

The paper uses matrix multiplication as the CPU probe [10] and runs it
during the function's network-bound *prepare* phase so it does not extend
the critical path. Here the probe is the hand-written matmul kernel
(``kernels/csrc/matmul_probe.cu``, f32 in IEEE FFMA); the harness is
pluggable so use-case-specific probes (memory streams, collective pings)
can be swapped in.

In *simulation*, the observed probe duration is ``work_ms / speed_factor``
— the harness computes ``work_ms`` (the probe's duration at unit speed)
once from its FLOP count so simulated and real probes share a scale.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Protocol

import torch

from .._device import resolve_device


class Probe(Protocol):
    name: str

    def work_ms_at_unit_speed(self) -> float: ...

    def run(self) -> float:
        """Execute the probe for real; returns observed duration in ms."""
        ...


@dataclasses.dataclass
class MatmulProbe:
    """Matrix-multiplication probe (paper's choice, ref. [10]).

    n: square matrix dimension. repeats: back-to-back matmuls to push
    duration above timer noise. ``unit_speed_flops_per_ms`` anchors the
    simulated-time scale (0.167 vCPU at ~1 GFLOP/s ≈ the paper's 256 MB GCF
    tier). ``use_kernel=False`` runs the plain PyTorch product instead of
    the kernel. ``device=None`` means the card.
    """

    n: int = 512
    repeats: int = 8
    unit_speed_flops_per_ms: float = 1.0e6 * 167  # 0.167 GFLOP/ms nominal
    use_kernel: bool = True
    name: str = "matmul"
    device: Optional[str] = None

    def __post_init__(self) -> None:
        self.device = str(resolve_device(self.device))

    @property
    def flops(self) -> float:
        return 2.0 * self.n**3 * self.repeats

    def work_ms_at_unit_speed(self) -> float:
        return self.flops / self.unit_speed_flops_per_ms

    def _compute(self) -> torch.Tensor:
        from ..kernels import ops

        a = torch.full((self.n, self.n), 0.5, dtype=torch.float32, device=self.device)
        b = torch.full((self.n, self.n), 0.25, dtype=torch.float32, device=self.device)
        out = a
        for _ in range(self.repeats):
            if self.use_kernel:
                out = ops.matmul(out, b)
            else:
                out = out @ b
        return out

    def run(self) -> float:
        """Host wall time in ms from before the first launch until the
        device has finished (``torch.cuda.synchronize``), as
        ``repro.core.benchmark.MatmulProbe.run`` reads the host clock around
        ``block_until_ready``; launch and host time are in it. Work queued
        before the call is finished first and not counted."""
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self._compute()
        if cuda:
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass
class CallableProbe:
    """Wrap any zero-arg callable returning observed duration in ms."""

    fn: Callable[[], float]
    work_ms: float
    name: str = "custom"

    def work_ms_at_unit_speed(self) -> float:
        return self.work_ms

    def run(self) -> float:
        return self.fn()


def overlap_fraction(prepare_ms: float, benchmark_ms: float) -> float:
    """Fraction of the benchmark hidden under the prepare phase. 1.0 means
    the probe is free (fully overlapped with e.g. the download); <1 means
    the probe extends the critical path by (1-f)*benchmark_ms."""
    if benchmark_ms <= 0:
        return 1.0
    return min(1.0, prepare_ms / benchmark_ms)


def effective_cold_start_overhead_ms(prepare_ms: float, benchmark_ms: float) -> float:
    """Extra wall time a cold start pays for benchmarking (0 when hidden)."""
    return max(0.0, benchmark_ms - prepare_ms)
