"""A whole run of each cell on the CPU at small sizes (the chip check
skipped): set-up, warm-up, window, check, result; and the run's faults."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in json.loads((harness.Path(__file__).resolve().parents[2]
                                         / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_run_is_correct(tree, workload):
    torch.set_num_threads(2)
    res = harness.run(tree, workload, 2**31 + 7, 1.0, False, device="cpu", settle_s=(0.5, 2.0))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert {"req_ms_p50", "req_ms_p90", "out_tok_per_s", "setup_s"} == set(res["metrics"])
    assert res["check"]["gap_mean"]["value"] < 1e-4


class _FakeClock:
    """A clock that only serving moves: each request takes ``slow`` seconds
    until ``step_at``, then ``fast``."""

    def __init__(self, slow: float, fast: float, step_at: float) -> None:
        self.now, self.slow, self.fast, self.step_at = 0.0, slow, fast, step_at

    def perf_counter(self) -> float:
        return self.now

    def serve(self, reqs):
        self.now += self.slow if self.now < self.step_at else self.fast
        return [None]


@pytest.mark.parametrize("step_at", [0.0, 12.0, 40.0])
def test_settle_waits_out_a_slow_level(tree, monkeypatch, step_at):
    """A slow level that holds steady for a while and then steps down is
    not taken for the settled one before the least time; one that holds
    past the least time is (what the least time is chosen against)."""
    clock = _FakeClock(slow=1.1, fast=1.0, step_at=step_at)
    monkeypatch.setattr(harness, "time", clock)
    cell = harness.load_cell(tree, "zamba2_docs")
    blocks = harness.settle(clock, cell, 5, min_s=30.0, max_s=60.0)
    n = len(harness.warmup_requests(cell, 5))
    assert clock.now >= 30.0
    if step_at < 30.0:
        assert blocks[-1] == blocks[-2] == pytest.approx(n * 1.0) and clock.now < 30.0 + 3 * n
    else:
        assert blocks[-1] == blocks[-2] == pytest.approx(n * 1.1) and clock.now < 30.0 + 3 * n
