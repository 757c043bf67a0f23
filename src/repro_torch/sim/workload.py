"""Workload generators (paper §III-A) and workflow DAG driving.

* :func:`run_closed_loop` — the paper's workload: N virtual users, each
  sends a request, waits for completion, sleeps 1 s, repeats; for a fixed
  experiment window.
* :class:`WorkflowSpec` / :func:`run_workflow` — multi-stage chains
  ("data processing and machine learning workflows"); each stage is its own
  function with its own warm pool, so longer workflows re-use the fast pool
  more often — the paper's compounding argument.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .platform import FaaSPlatform, RequestResult


def run_closed_loop(
    platform: FaaSPlatform,
    *,
    n_vus: int = 10,
    think_time_ms: float = 1000.0,
    duration_ms: float = 30 * 60 * 1000.0,
    start_ms: float = 0.0,
) -> list[RequestResult]:
    """Drive ``platform`` with closed-loop VUs; returns results completed
    inside the window. Requests still in flight at the window end are
    discarded (the paper counts successful requests per 30-min window)."""
    window_end = start_ms + duration_ms
    completed: list[RequestResult] = []

    def make_vu(vu_id: int):
        def on_complete(res: RequestResult) -> None:
            if res.t_completed_ms <= window_end:
                completed.append(res)
            next_t = res.t_completed_ms + think_time_ms
            if next_t < window_end:
                platform.loop.at(next_t, lambda: platform.submit({"vu": vu_id}, on_complete))

        return on_complete

    for vu in range(n_vus):
        cb = make_vu(vu)
        platform.loop.at(start_ms, lambda cb=cb, vu=vu: platform.submit({"vu": vu}, cb))

    platform.loop.run_until(window_end)
    # drain without counting (in-flight at window end)
    platform.loop.run_all(hard_limit_ms=window_end + 10 * 60 * 1000.0)
    return completed


@dataclasses.dataclass(frozen=True)
class WorkflowSpec:
    """A linear chain of stage functions (DAG support reduces to chains for
    the paper's use case; each stage may have its own spec)."""

    stage_platforms: Sequence[FaaSPlatform]

    def __len__(self) -> int:
        return len(self.stage_platforms)


def run_workflow(
    workflow: WorkflowSpec,
    *,
    n_items: int,
    inter_arrival_ms: float = 500.0,
) -> list[list[RequestResult]]:
    """Push ``n_items`` through the stage chain; stage k+1 is submitted when
    stage k completes. All stages share one simulated clock (stage 0's loop
    drives; stages must be constructed with the same loop — see
    :func:`make_chain`). Returns per-stage results."""
    loop = workflow.stage_platforms[0].loop
    for p in workflow.stage_platforms:
        if p.loop is not loop:
            raise ValueError("all workflow stages must share one event loop")
    per_stage: list[list[RequestResult]] = [[] for _ in workflow.stage_platforms]

    def submit_stage(k: int, item: int) -> None:
        plat = workflow.stage_platforms[k]

        def on_complete(res: RequestResult) -> None:
            per_stage[k].append(res)
            if k + 1 < len(workflow.stage_platforms):
                submit_stage(k + 1, item)

        plat.submit({"item": item, "stage": k}, on_complete)

    for i in range(n_items):
        loop.at(i * inter_arrival_ms, lambda i=i: submit_stage(0, i))

    loop.run_all(hard_limit_ms=1e12)
    return per_stage


def make_chain(specs, variation, policy, pricing, seed: int = 0) -> WorkflowSpec:
    """Build a stage chain sharing one event loop."""
    plats = []
    for i, spec in enumerate(specs):
        p = FaaSPlatform(spec, variation, policy, pricing, seed=seed + 97 * i)
        if plats:
            p.loop = plats[0].loop
        plats.append(p)
    return WorkflowSpec(tuple(plats))
