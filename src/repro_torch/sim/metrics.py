"""Metric aggregation for experiment arms (paper Figs 4-7)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost import WorkflowCost
from .platform import FaaSPlatform, RequestResult


@dataclasses.dataclass
class ArmSummary:
    """One experiment arm (baseline or Minos) on one day."""

    name: str
    n_successful: int
    n_instance_starts: int
    n_terminated: int
    mean_analysis_ms: float
    median_analysis_ms: float
    mean_download_ms: float
    mean_latency_ms: float
    total_cost: float
    cost_per_million: float
    mean_retries: float
    warm_pool_mean_speed: float
    cost: WorkflowCost

    @staticmethod
    def from_platform(name: str, platform: FaaSPlatform, results: list[RequestResult]) -> "ArmSummary":
        analysis = np.array([r.analysis_ms for r in results]) if results else np.array([np.nan])
        download = np.array([r.download_ms for r in results]) if results else np.array([np.nan])
        latency = np.array([r.latency_ms for r in results]) if results else np.array([np.nan])
        retries = np.array([r.retries for r in results]) if results else np.array([0.0])
        pool = platform.warm_pool_speeds  # cached immutable view — not ours to mutate
        return ArmSummary(
            name=name,
            n_successful=len(results),
            n_instance_starts=platform.instances_started,
            n_terminated=platform.instances_terminated,
            mean_analysis_ms=float(analysis.mean()),
            median_analysis_ms=float(np.median(analysis)),
            mean_download_ms=float(download.mean()),
            mean_latency_ms=float(latency.mean()),
            total_cost=platform.cost.total,
            cost_per_million=platform.cost.cost_per_million_successful(),
            mean_retries=float(retries.mean()),
            warm_pool_mean_speed=float(np.mean(pool)) if pool else float("nan"),
            cost=platform.cost,
        )


def improvement(baseline: float, treatment: float) -> float:
    """Relative improvement (positive = treatment better/lower)."""
    return (baseline - treatment) / baseline


def slo_attainment_by_class(result_classes, latencies_ms, qos_classes) -> tuple:
    """Per-class SLO attainment: fraction of COMPLETED requests of each
    class finishing within its :attr:`~repro_torch.sim.arrivals.QoSClass.slo_ms`.

    Classes without an SLO are skipped. Completed-only carries the same
    survivorship caveat as the latency percentiles (see
    :class:`OpenLoopSummary`): dropped / dead-lettered / still-pending
    requests never appear, so under overload read attainment alongside
    ``drop_rate`` — 100% attainment over 10% of the traffic is not an
    SLO win. A class with an SLO but no completions reports NaN."""
    if not qos_classes:
        return ()
    cls = np.asarray(list(result_classes))
    lat = np.asarray(list(latencies_ms), float)
    out = []
    for c in qos_classes:
        slo = getattr(c, "slo_ms", None)
        if slo is None:
            continue
        mine = lat[cls == c.name] if cls.size else np.empty(0)
        out.append({
            "qos": c.name,
            "slo_ms": float(slo),
            "n_completed": int(mine.size),
            "attainment": float((mine <= slo).mean()) if mine.size
            else float("nan"),
        })
    return tuple(out)


@dataclasses.dataclass
class WorkflowSummary:
    """One (workflow × platform × arm) cell of the sweep
    (EXPERIMENTS.md §Workflow sweep)."""

    name: str
    arm: str
    n_items: int
    mean_item_latency_ms: float
    median_item_latency_ms: float
    mean_item_analysis_ms: float
    total_cost: float
    cost_per_million_items: float
    n_instance_starts: int
    n_terminated: int
    mean_item_retries: float

    @staticmethod
    def from_run(arm: str, run) -> "WorkflowSummary":
        """``run`` is a :class:`~repro_torch.sim.workflow_dag.WorkflowRunResult`
        (duck-typed to keep this module free of a workflow_dag import)."""
        retries = (
            float(np.mean([i.total_retries for i in run.items])) if run.items else 0.0
        )
        return WorkflowSummary(
            name=run.dag.name,
            arm=arm,
            n_items=run.n_items,
            mean_item_latency_ms=run.mean_item_latency_ms,
            median_item_latency_ms=run.median_item_latency_ms,
            mean_item_analysis_ms=run.mean_item_analysis_ms,
            total_cost=run.cost.total,
            cost_per_million_items=run.cost_per_million_items,
            n_instance_starts=run.engine.instances_started,
            n_terminated=run.engine.instances_terminated,
            mean_item_retries=retries,
        )


@dataclasses.dataclass
class OpenLoopSummary:
    """One open-loop arm (EXPERIMENTS.md §Open-loop sweep).

    Latency percentiles are over COMPLETED requests — the usual SLO view,
    and under queue blow-up a survivorship-biased one: requests still
    stuck in the queue (or parked at admission) when the run ends never
    reach the completed set, so completed-only P99 can *fall* as overload
    worsens. ``wait_p99_ms`` is therefore computed over ALL arrived
    requests' queue waits: completed requests' waits, the censored waits
    of everything still pending at the end, and 0.0 for each dropped
    request (a drop is refused instantly; it appears as ``drop_rate``,
    not as wait). Regression-tested in tests/test_arrivals.py."""

    name: str
    process: str
    n_arrived: int
    n_completed: int
    n_dropped: int
    n_deferred: int
    drop_rate: float
    defer_rate: float
    mean_latency_ms: float
    p50_latency_ms: float
    p95_latency_ms: float
    p99_latency_ms: float
    completed_wait_p99_ms: float   # the survivorship-biased version
    wait_p99_ms: float             # over ALL arrived requests
    mean_system_population: float  # time-averaged L (Little's law)
    total_cost: float
    cost_per_1k: float
    n_instance_starts: int
    n_terminated: int
    # retries exhausted under fault injection (DESIGN.md §15); 0 fault-free
    n_dead_lettered: int = 0
    # per-class SLO attainment rows (slo_attainment_by_class); () when no
    # class defines an slo_ms or qos_classes was not passed to from_run
    slo_attainment: tuple = ()

    @staticmethod
    def from_run(name: str, engine, run,
                 qos_classes=None) -> "OpenLoopSummary":
        """``engine`` is a :class:`~repro_torch.core.substrate.SubstrateEngine`,
        ``run`` an :class:`~repro_torch.sim.arrivals.OpenLoopRun` (duck-typed,
        as elsewhere in this module). ``qos_classes`` (the same sequence
        handed to run_open_loop) enables per-class SLO attainment."""
        lat = np.asarray([r.latency_ms for r in run.results]) \
            if run.results else np.asarray([np.nan])
        completed_waits = np.asarray(
            [r.queue_wait_ms for r in run.results]) \
            if run.results else np.asarray([0.0])
        all_waits = np.concatenate([
            completed_waits if run.results else np.empty(0),
            np.asarray(run.censored_waits_ms, float),
            np.zeros(run.n_dropped),
        ]) if (run.results or run.censored_waits_ms or run.n_dropped) \
            else np.asarray([0.0])
        return OpenLoopSummary(
            name=name,
            process=getattr(run, "process_name", "?"),
            n_arrived=run.n_arrived,
            n_completed=run.n_completed,
            n_dropped=run.n_dropped,
            n_deferred=run.n_deferred_items,
            drop_rate=run.drop_rate,
            defer_rate=run.defer_rate,
            mean_latency_ms=float(lat.mean()),
            p50_latency_ms=float(np.percentile(lat, 50)),
            p95_latency_ms=float(np.percentile(lat, 95)),
            p99_latency_ms=float(np.percentile(lat, 99)),
            completed_wait_p99_ms=float(np.percentile(completed_waits, 99)),
            wait_p99_ms=float(np.percentile(all_waits, 99)),
            mean_system_population=run.mean_system_population(),
            total_cost=engine.cost.total,
            cost_per_1k=engine.cost.total / max(run.n_completed, 1) * 1e3,
            n_instance_starts=engine.instances_started,
            n_terminated=engine.instances_terminated,
            n_dead_lettered=getattr(run, "n_dead_lettered", 0),
            slo_attainment=slo_attainment_by_class(
                run.result_classes,
                [r.latency_ms for r in run.results], qos_classes),
        )

    @staticmethod
    def from_vec(name: str, result, arm: int = 0, *,
                 process: str = "poisson") -> "OpenLoopSummary":
        """Summarize one arm of a vectorized open-loop run
        (:func:`repro_torch.sim.vectorized.simulate_open_arms` with
        ``collect_requests=True``), pooled across seeds.

        Mirrors :meth:`from_run` with one censoring caveat: the scan does
        not expose per-request censored waits for requests still parked
        when the horizon ends (``n_parked_end``), so ``wait_p99_ms`` here
        pools completed requests' waits plus a zero per drop — the parked
        tail is omitted rather than guessed. ``n_parked_end`` is small at
        the calibrated loads (≲1 per lane; tests/test_vectorized_parity.py)
        and the omission biases ``wait_p99_ms`` *down*, so treat it as a
        floor under heavy overload. ``mean_system_population`` is Little's
        L from completed work only: Σ latency / horizon, per seed, then
        averaged."""
        if result.requests is None:
            raise ValueError(
                "OpenLoopSummary.from_vec needs per-request rows; rerun "
                "simulate_open_arms with collect_requests=True")
        s = {k: np.asarray(v[arm], float) for k, v in result.summary.items()}
        # (n_seeds, n_steps, D+1) rows; only `completed` rows carry a request
        comp = np.asarray(result.requests["completed"][arm]).astype(bool)
        lat = np.asarray(result.requests["latency_ms"][arm], float)
        wait = np.asarray(result.requests["wait_ms"][arm], float)
        n_arrived = int(s["n_requests"].sum())
        n_completed = int(s["n_completed"].sum())
        n_dropped = int(s["n_dropped"].sum())
        lat_c = lat[comp] if comp.any() else np.asarray([np.nan])
        wait_c = wait[comp] if comp.any() else np.asarray([0.0])
        all_waits = np.concatenate([wait_c, np.zeros(n_dropped)]) \
            if (comp.any() or n_dropped) else np.asarray([0.0])
        # per-seed Little's L, then mean over seeds
        horizon = np.maximum(s["horizon_ms"], 1.0)
        lat_sum = np.where(comp, lat, 0.0).sum(axis=(1, 2))
        total_cost = float(s["cost"].sum())
        return OpenLoopSummary(
            name=name,
            process=process,
            n_arrived=n_arrived,
            n_completed=n_completed,
            n_dropped=n_dropped,
            n_deferred=int(s["n_deferred"].sum()),
            drop_rate=n_dropped / max(n_arrived, 1),
            defer_rate=int(s["n_deferred"].sum()) / max(n_arrived, 1),
            mean_latency_ms=float(lat_c.mean()),
            p50_latency_ms=float(np.percentile(lat_c, 50)),
            p95_latency_ms=float(np.percentile(lat_c, 95)),
            p99_latency_ms=float(np.percentile(lat_c, 99)),
            completed_wait_p99_ms=float(np.percentile(wait_c, 99)),
            wait_p99_ms=float(np.percentile(all_waits, 99)),
            mean_system_population=float((lat_sum / horizon).mean()),
            total_cost=total_cost,
            cost_per_1k=total_cost / max(n_completed, 1) * 1e3,
            n_instance_starts=int(s["n_started"].sum()),
            n_terminated=int(s["n_terminated"].sum()),
        )


@dataclasses.dataclass
class FleetSummary:
    """One fleet-router arm (EXPERIMENTS.md §Fleet sweep).

    Latency percentiles pool the *logical winners* across fleets — each
    hedged request counts exactly once, at its first completion.
    ``total_cost`` is the router's accounting (honest by default: both
    copies of a hedged request are billed; see
    :class:`~repro_torch.fleet.router.FleetRouter.count_hedge_waste`), so a
    policy cannot look cheap by paying for speculation off the books.
    ``per_fleet`` rows expose where the policy actually sent traffic."""

    name: str
    process: str
    n_arrived: int
    n_completed: int
    n_dropped: int
    drop_rate: float
    mean_latency_ms: float
    p50_latency_ms: float
    p95_latency_ms: float
    p99_latency_ms: float
    total_cost: float
    cost_per_1k: float
    n_hedges: int
    n_hedge_wins: int
    hedge_waste_cost: float
    per_fleet: tuple
    # -- failure resilience (DESIGN.md §15); zeros/() fault-free --
    n_rejected: int = 0
    n_shed: int = 0
    n_dead_lettered: int = 0
    breaker_opens: tuple = ()
    slo_attainment: tuple = ()

    @staticmethod
    def from_run(name: str, router, run, qos_classes=None) -> "FleetSummary":
        """``router`` is a :class:`~repro_torch.fleet.router.FleetRouter`,
        ``run`` a :class:`~repro_torch.fleet.router.FleetRunResult` (duck-typed,
        as elsewhere in this module). ``qos_classes`` (the sequence handed
        to run_fleet_open_loop) enables per-class SLO attainment."""
        lat = np.asarray([r.latency_ms for r in run.results]) \
            if run.results else np.asarray([np.nan])
        fleet_idx = np.asarray(run.result_fleets, int) \
            if run.result_fleets else np.empty(0, int)
        per_fleet = []
        for i, fname in enumerate(run.fleet_names):
            mine = fleet_idx == i
            mine_lat = lat[mine] if mine.any() else np.asarray([np.nan])
            engine = router.engines[i]
            per_fleet.append({
                "fleet": fname,
                "share": float(mine.sum()) / max(run.n_completed, 1),
                "completed": int(mine.sum()),
                "dropped": int(run.per_fleet["per_fleet_dropped"][i]),
                "parked": int(run.per_fleet["per_fleet_parked"][i]),
                "p95_ms": float(np.percentile(mine_lat, 95)),
                "cost": float(engine.cost.total),
            })
        return FleetSummary(
            name=name,
            process=getattr(run, "process_name", "?"),
            n_arrived=run.n_arrived,
            n_completed=run.n_completed,
            n_dropped=run.n_dropped,
            drop_rate=run.drop_rate,
            mean_latency_ms=float(lat.mean()),
            p50_latency_ms=float(np.percentile(lat, 50)),
            p95_latency_ms=float(np.percentile(lat, 95)),
            p99_latency_ms=float(np.percentile(lat, 99)),
            total_cost=run.total_cost,
            cost_per_1k=run.total_cost / max(run.n_completed, 1) * 1e3,
            n_hedges=run.n_hedges,
            n_hedge_wins=run.n_hedge_wins,
            hedge_waste_cost=run.hedge_waste_cost,
            per_fleet=tuple(per_fleet),
            n_rejected=getattr(run, "n_rejected", 0),
            n_shed=getattr(run, "n_shed", 0),
            n_dead_lettered=getattr(run, "n_dead_lettered", 0),
            breaker_opens=tuple(getattr(run, "breaker_opens", ())),
            slo_attainment=slo_attainment_by_class(
                run.result_classes,
                [r.latency_ms for r in run.results], qos_classes),
        )


def cost_timeline(
    results: list[RequestResult],
    cost: WorkflowCost,
    window_end_ms: float,
    n_points: int = 200,
    termination_events: list[tuple[float, float]] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Running average cost per successful request over elapsed time (Fig 7).

    Cost accrues time-locally: each successful request is billed at its
    completion; each terminated instance is billed at crash time. This
    reproduces the paper's shape — Minos more expensive in the first ~200 s
    (cold-start termination burst), crossing under the baseline later."""
    if not results:
        return np.array([]), np.array([])
    order = np.argsort([r.t_completed_ms for r in results])
    times = np.array([results[i].t_completed_ms for i in order])
    per_req = np.array(
        [
            cost.pricing.cost_per_invocation
            + cost.pricing.cost_per_ms * (results[i].download_ms + results[i].analysis_ms)
            for i in order
        ]
    )
    grid = np.linspace(times[0], window_end_ms, n_points)
    idx = np.clip(np.searchsorted(times, grid, side="right"), 1, len(per_req))
    cum_cost = np.cumsum(per_req)[idx - 1]
    cum_n = np.arange(1, len(per_req) + 1)[idx - 1]
    if termination_events:
        t_term = np.array([t for t, _ in termination_events])
        c_term = np.array(
            [
                cost.pricing.cost_per_invocation + cost.pricing.cost_per_ms * billed
                for _, billed in termination_events
            ]
        )
        o = np.argsort(t_term)
        t_term, c_term = t_term[o], np.cumsum(c_term[o])
        j = np.searchsorted(t_term, grid, side="right")
        cum_cost = cum_cost + np.where(j > 0, c_term[np.clip(j - 1, 0, None)], 0.0)
    return grid, cum_cost / cum_n
