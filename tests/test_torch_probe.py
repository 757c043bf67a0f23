"""The port's MatmulProbe against ``repro.core.benchmark.MatmulProbe``.

``flops`` and ``work_ms_at_unit_speed()`` anchor simulated time, so they are
equal exactly. ``_compute`` is held against the JAX probe's plain path
(``use_pallas=False``) at n=256, repeats=2 — the weather workflow's size; the
values are exact in f32 (0.5 * (0.25 * 256)^2), so the match is exact too.
"""
import _torch_cpu  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.benchmark import MatmulProbe as JaxProbe
from repro_torch.core.benchmark import (
    CallableProbe,
    MatmulProbe,
    effective_cold_start_overhead_ms,
    overlap_fraction,
)
from repro_torch.kernels import ops


@pytest.mark.parametrize("n,repeats", [(512, 8), (256, 2)])
def test_flops_and_unit_work_equal_reference(n, repeats):
    port, ref = MatmulProbe(n=n, repeats=repeats, device="cpu"), JaxProbe(n=n, repeats=repeats)
    assert port.flops == ref.flops == 2.0 * n**3 * repeats
    assert port.work_ms_at_unit_speed() == ref.work_ms_at_unit_speed()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_compute_matches_reference(use_kernel):
    ref = np.asarray(JaxProbe(n=256, repeats=2, use_pallas=False)._compute())
    out = MatmulProbe(n=256, repeats=2, use_kernel=use_kernel, device="cpu")._compute()
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref)


def test_run_returns_positive_ms_and_goes_through_the_dispatcher():
    ops.reset_counters()
    ms = MatmulProbe(n=64, repeats=3, device="cpu").run()
    assert ms > 0.0
    assert ops.plain["matmul"] == 3 and ops.launches["matmul"] == 0
    ops.reset_counters()


def test_run_is_the_host_clock_around_the_work(monkeypatch):
    """``run()`` reads the host clock before the first launch and after the
    work has finished, as ``repro``'s ``run()`` reads it around
    ``block_until_ready``; it returns the difference in ms."""
    import repro_torch.core.benchmark as bench

    reads = []

    def clock():
        reads.append(ops.plain["matmul"])  # launches made when the clock was read
        return 10.0 + 0.25 * (len(reads) - 1)

    ops.reset_counters()
    monkeypatch.setattr(bench.time, "perf_counter", clock)
    assert MatmulProbe(n=32, repeats=3, device="cpu").run() == 250.0
    assert reads == [0, 3]
    ops.reset_counters()


def test_callable_probe_and_overlap_helpers():
    p = CallableProbe(fn=lambda: 12.5, work_ms=10.0)
    assert p.run() == 12.5 and p.work_ms_at_unit_speed() == 10.0
    assert overlap_fraction(400.0, 200.0) == 1.0
    assert overlap_fraction(100.0, 200.0) == 0.5
    assert overlap_fraction(100.0, 0.0) == 1.0
    assert effective_cold_start_overhead_ms(100.0, 250.0) == 150.0
    assert effective_cold_start_overhead_ms(400.0, 250.0) == 0.0
