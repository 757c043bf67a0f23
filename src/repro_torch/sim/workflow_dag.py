"""Multi-stage workflow DAG engine (paper §V; DESIGN.md §5).

The paper's headline scaling claim is that "longer and complex workflows
lead to increased savings, as the pool of fast instances is re-used more
often". This module makes that claim testable: a :class:`WorkflowDAG` of
:class:`~repro_torch.sim.platform.FunctionSpec` stages with fan-out/fan-in edges,
where every stage invocation flows through the existing Minos gate on its
own :class:`~repro_torch.sim.platform.FaaSPlatform` — so each stage keeps a
per-stage warm pool of benchmark-certified instances, and pool re-use
compounds across stages.

Execution model (all stages share ONE simulated clock):

* an *item* is one end-to-end workflow execution;
* a stage is submitted for an item as soon as ALL of its parent stages
  have completed for that item (fan-in barrier); source stages are
  submitted at item arrival; the item completes when every sink stage has
  completed;
* a terminated (benchmark-failed) instance re-queues its stage invocation
  on the stage's own queue — downstream stages never observe the retry,
  only the delay; each stage may bound its own emergency exit via
  ``Stage.max_retries``.

Scenario builders: :func:`etl_chain` and :func:`etl_suite` construct the
3-/5-/7-stage ETL workflows used by ``benchmarks/workflow_sweep.py`` and
``examples/etl_workflows.py`` (protocol: EXPERIMENTS.md §Workflow sweep).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.control import AdmitContext, AdmitDecision
from repro_torch.core.cost import Pricing, WorkflowCost
from repro_torch.core.substrate import SubstrateEngine
from .platform import FaaSPlatform, FunctionSpec, PlatformProfile, RequestResult
from .variation import VariationModel


# ---------------------------------------------------------------------------
# DAG structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One node of the workflow: an execution binding plus its dependencies.

    A stage is bound to exactly one of:

    * ``spec`` — a simulated :class:`FunctionSpec` (body durations are
      sampled; the paper's evaluation world), or
    * ``backend`` — any :class:`~repro_torch.core.substrate.Backend`, e.g. a
      :class:`~repro_torch.serving.backend.ModelServingBackend` whose body is
      real JAX prefill/decode. The engine runs it on its own Minos-gated
      pool with the same fan-in semantics.

    ``max_retries`` optionally overrides the policy's emergency-exit bound
    for this stage only (e.g. an idempotent transform tolerates more
    re-selection than a stage with external side effects).

    ``max_in_flight`` optionally bounds items concurrently admitted to this
    stage (submitted but not completed, retries included). When a requeue
    storm inflates a stage's queue, further items wait at admission instead
    of piling onto the stage queue — back-pressure, not just latency.

    ``make_request`` adapts the item payload for this stage's backend:
    called with ``(item_payload, parent_results)`` where ``parent_results``
    maps each dependency name to its completed
    :class:`~repro_torch.core.substrate.RequestResult` (whose ``output`` carries
    a serving backend's tokens). Without it, the raw item payload is
    forwarded — simulated stages ignore payloads entirely.
    """

    spec: Optional[FunctionSpec] = None
    deps: tuple[str, ...] = ()
    max_retries: Optional[int] = None
    backend: Optional[object] = None
    max_in_flight: Optional[int] = None
    make_request: Optional[Callable[[Any, Dict[str, RequestResult]], Any]] = None

    def __post_init__(self) -> None:
        if (self.spec is None) == (self.backend is None):
            raise ValueError("a Stage needs exactly one of spec= or backend=")
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")

    @property
    def name(self) -> str:
        return self.spec.name if self.spec is not None else self.backend.name


class WorkflowDAG:
    """A validated DAG of stages, keyed by stage (function) name."""

    def __init__(self, stages: Sequence[Stage], name: str = "workflow") -> None:
        self.name = name
        self.stages: Dict[str, Stage] = {}
        for s in stages:
            if s.name in self.stages:
                raise ValueError(f"duplicate stage name {s.name!r}")
            self.stages[s.name] = s
        for s in stages:
            for d in s.deps:
                if d not in self.stages:
                    raise ValueError(f"stage {s.name!r} depends on unknown stage {d!r}")
        self.children: Dict[str, tuple[str, ...]] = {n: () for n in self.stages}
        for s in stages:
            for d in s.deps:
                self.children[d] = self.children[d] + (s.name,)
        self.order = self._topo_sort()
        self.sources = tuple(n for n, s in self.stages.items() if not s.deps)
        self.sinks = tuple(n for n in self.stages if not self.children[n])
        if not self.sources:
            raise ValueError("workflow has no source stage")

    def _topo_sort(self) -> tuple[str, ...]:
        indeg = {n: len(s.deps) for n, s in self.stages.items()}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in self.children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.stages):
            cyc = sorted(set(self.stages) - set(order))
            raise ValueError(f"workflow DAG has a cycle through {cyc}")
        return tuple(order)

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self):
        return iter(self.order)

    @staticmethod
    def chain(specs: Sequence[FunctionSpec], name: str = "chain") -> "WorkflowDAG":
        """Linear pipeline: each stage depends on the previous one."""
        stages = []
        prev: tuple[str, ...] = ()
        for spec in specs:
            stages.append(Stage(spec=spec, deps=prev))
            prev = (spec.name,)
        return WorkflowDAG(stages, name=name)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ItemResult:
    """One completed end-to-end workflow execution."""

    item_id: int
    t_submitted_ms: float
    t_completed_ms: float
    stage_results: Dict[str, RequestResult]

    @property
    def latency_ms(self) -> float:
        return self.t_completed_ms - self.t_submitted_ms

    @property
    def total_analysis_ms(self) -> float:
        return sum(r.analysis_ms for r in self.stage_results.values())

    @property
    def total_retries(self) -> int:
        return sum(r.retries for r in self.stage_results.values())


class _ItemState:
    __slots__ = ("item_id", "t0", "waiting", "results", "on_complete", "payload")

    def __init__(self, item_id: int, t0: float, dag: WorkflowDAG, on_complete,
                 payload: Any = None) -> None:
        self.item_id = item_id
        self.t0 = t0
        self.waiting = {n: len(s.deps) for n, s in dag.stages.items()}
        self.results: Dict[str, RequestResult] = {}
        self.on_complete = on_complete
        self.payload = payload


class WorkflowEngine:
    """Per-stage substrate engines sharing one event loop, plus the fan-in
    and admission logic. A :class:`Stage` bound to a ``spec`` gets a
    :class:`~repro_torch.sim.platform.FaaSPlatform`; one bound to a ``backend``
    (e.g. model serving) gets a bare
    :class:`~repro_torch.core.substrate.SubstrateEngine` — both are the same
    substrate, so mixed simulated/serving pipelines share identical pool,
    gate, and requeue semantics on one clock.

    ``policy_factory`` builds one policy object *per stage* — required for
    :class:`~repro_torch.core.policy.AdaptiveMinosPolicy`, whose threshold is in
    units of the stage's own probe duration and must never be shared across
    stages with different ``benchmark_ms``. It receives the :class:`Stage`
    so it can honor per-stage ``max_retries``.

    ``controller_factory`` instead builds one
    :class:`~repro_torch.core.control.Controller` per stage — the control-plane
    surface (DESIGN.md §10); it supersedes ``policy_factory`` (pass None).
    Item admission to a stage flows through the stage controller's
    ``on_admit`` decision point: the static ``Stage.max_in_flight`` bound
    is the default controller's answer, and a
    :class:`~repro_torch.core.control.QueueAwareAdmissionController` turns it
    into a dynamic bound driven by the stage's live queue depth and pool
    occupancy. Deferred items are re-offered on every completion of that
    stage (a deferral always has work in flight or queued, so progress is
    guaranteed).
    """

    def __init__(
        self,
        dag: WorkflowDAG,
        variation: VariationModel,
        policy_factory: Optional[Callable[[Stage], object]] = None,
        *,
        profile: Optional[PlatformProfile] = None,
        pricing: Optional[Pricing] = None,
        seed: int = 0,
        controller_factory: Optional[Callable[[Stage], object]] = None,
    ) -> None:
        if profile is None and pricing is None:
            raise ValueError("need a PlatformProfile or an explicit Pricing")
        if (policy_factory is None) == (controller_factory is None):
            raise ValueError(
                "need exactly one of policy_factory= or controller_factory=")
        self.dag = dag
        self.variation = variation
        self.profile = profile
        self.platforms: Dict[str, SubstrateEngine] = {}
        self.items: List[ItemResult] = []
        self._next_item = 0
        self._in_flight = {n: 0 for n in dag.order}
        self._admission: Dict[str, collections.deque] = {
            n: collections.deque() for n in dag.order
        }
        loop = None
        for i, name in enumerate(dag.order):
            stage = dag.stages[name]
            policy = policy_factory(stage) if policy_factory is not None else None
            ctrl = controller_factory(stage) if controller_factory is not None else None
            if stage.spec is not None:
                plat: SubstrateEngine = FaaSPlatform(
                    stage.spec, variation, policy,
                    pricing=pricing, seed=seed + 97 * i, profile=profile,
                    controller=ctrl,
                )
            else:
                # a profile overrides hosting knobs but must not silently
                # drop the backend's replica-pool cap
                knobs = (
                    profile.knobs(max_pool=getattr(stage.backend, "max_pool", None))
                    if profile is not None
                    else stage.backend.default_knobs()
                )
                plat = SubstrateEngine(
                    stage.backend, policy,
                    pricing if pricing is not None else profile.pricing,
                    knobs=knobs, seed=seed + 97 * i, controller=ctrl,
                )
            if loop is None:
                loop = plat.loop
            else:
                plat.loop = loop  # all stages share stage-0's clock
            self.platforms[name] = plat
        assert loop is not None
        self.loop = loop

    # -- item flow ------------------------------------------------------
    def submit_item(
        self,
        on_complete: Optional[Callable[[ItemResult], None]] = None,
        payload: Any = None,
    ) -> int:
        """Start one workflow execution now; returns the item id."""
        item_id = self._next_item
        self._next_item += 1
        state = _ItemState(item_id, self.loop.now, self.dag, on_complete, payload)
        for src in self.dag.sources:
            self._submit_stage(state, src)
        return item_id

    def in_flight(self, stage_name: str) -> int:
        """Items admitted to ``stage_name`` and not yet completed."""
        return self._in_flight[stage_name]

    def admission_queue_depth(self, stage_name: str) -> int:
        """Items waiting at ``stage_name``'s admission bound."""
        return len(self._admission[stage_name])

    def stage_pool_load(self, stage_name: str) -> float:
        """Mean in-flight requests per live instance of the stage's pool
        (>= 1.0) — the occupancy the load-slowdown model charges and the
        load-aware gate judges at (DESIGN.md §9 load model). The hook for
        queue-depth-aware dynamic admission (ROADMAP)."""
        return self.platforms[stage_name].pool.mean_load()

    def stage_queue_depth(self, stage_name: str) -> int:
        """Invocations waiting on the stage's own queue (requeues included) —
        distinct from the admission queue, which holds not-yet-admitted
        items."""
        return len(self.platforms[stage_name].queue)

    def _admission_allows(self, name: str) -> bool:
        """Ask the stage controller's on_admit decision point. The default
        (classic) controller answers with the static ``Stage.max_in_flight``
        bound; queue-aware controllers read the live telemetry."""
        stage = self.dag.stages[name]
        plat = self.platforms[name]
        plat._decide("on_admit")
        decision = plat.controller.on_admit(AdmitContext(
            telemetry=plat.telemetry,
            in_flight=self._in_flight[name],
            bound=stage.max_in_flight,
            admission_queue_depth=len(self._admission[name]),
        ))
        return decision is AdmitDecision.ADMIT

    def _submit_stage(self, state: _ItemState, name: str) -> None:
        if not self._admission_allows(name):
            self._admission[name].append(state)  # back-pressure at admission
            return
        self._admit(state, name)

    def _admit(self, state: _ItemState, name: str) -> None:
        stage = self.dag.stages[name]
        plat = self.platforms[name]
        self._in_flight[name] += 1
        if stage.make_request is not None:
            payload = stage.make_request(
                state.payload, {d: state.results[d] for d in stage.deps})
        else:
            payload = state.payload

        def done(res: RequestResult) -> None:
            self._in_flight[name] -= 1
            # a completion may free admission capacity: re-offer deferred
            # items until the controller defers again (the static bound
            # admits exactly one per completion, as before)
            while self._admission[name] and self._admission_allows(name):
                self._admit(self._admission[name].popleft(), name)
            state.results[name] = res
            for child in self.dag.children[name]:
                state.waiting[child] -= 1
                if state.waiting[child] == 0:  # fan-in: ALL parents arrived
                    self._submit_stage(state, child)
            if all(s in state.results for s in self.dag.sinks):
                item = ItemResult(
                    item_id=state.item_id,
                    t_submitted_ms=state.t0,
                    t_completed_ms=self.loop.now,
                    stage_results=dict(state.results),
                )
                self.items.append(item)
                if state.on_complete is not None:
                    state.on_complete(item)

        plat.submit(payload, done)

    # -- aggregates -----------------------------------------------------
    @property
    def cost(self) -> WorkflowCost:
        merged: Optional[WorkflowCost] = None
        for p in self.platforms.values():
            merged = p.cost if merged is None else merged.merge(p.cost)
        assert merged is not None
        return merged

    @property
    def instances_started(self) -> int:
        return sum(p.instances_started for p in self.platforms.values())

    @property
    def instances_terminated(self) -> int:
        return sum(p.instances_terminated for p in self.platforms.values())

    def per_stage_results(self) -> Dict[str, List[RequestResult]]:
        return {n: list(p.results) for n, p in self.platforms.items()}


@dataclasses.dataclass
class WorkflowRunResult:
    """Everything a sweep needs from one workflow run.

    ``items`` are the executions completing inside the measurement window
    (latency statistics); ``n_items_costed`` additionally counts items that
    completed while draining, because the cost ledgers accrue through the
    drain too — dividing drain-inclusive cost by window-only items would
    overstate cost per item, and by more for slower arms.
    """

    dag: WorkflowDAG
    items: List[ItemResult]
    engine: WorkflowEngine

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_items_costed(self) -> int:
        return len(self.engine.items)

    @property
    def mean_item_latency_ms(self) -> float:
        return float(np.mean([i.latency_ms for i in self.items])) if self.items else float("nan")

    @property
    def median_item_latency_ms(self) -> float:
        return float(np.median([i.latency_ms for i in self.items])) if self.items else float("nan")

    @property
    def mean_item_analysis_ms(self) -> float:
        return float(np.mean([i.total_analysis_ms for i in self.items])) if self.items else float("nan")

    @property
    def cost(self) -> WorkflowCost:
        return self.engine.cost

    @property
    def cost_per_million_items(self) -> float:
        if not self.engine.items:
            return float("nan")
        return self.engine.cost.total / self.n_items_costed * 1e6


def run_workflow_closed_loop(
    engine: WorkflowEngine,
    *,
    n_vus: int = 10,
    think_time_ms: float = 1000.0,
    duration_ms: float = 10 * 60 * 1000.0,
    start_ms: float = 0.0,
    payload_fn: Optional[Callable[[int], Any]] = None,
) -> WorkflowRunResult:
    """The paper's closed-loop workload lifted to whole workflows: each VU
    submits an item, waits for the full DAG to complete, thinks, repeats.
    Item-level concurrency is what bounds total pool size across stages —
    the amortization the paper's workflow argument rests on.
    ``payload_fn(item_seq)`` builds the item payload (serving pipelines);
    None submits payload-less items (simulated stages ignore payloads)."""
    window_end = start_ms + duration_ms
    completed: List[ItemResult] = []
    seq = itertools.count()

    def submit(cb) -> None:
        payload = payload_fn(next(seq)) if payload_fn is not None else None
        engine.submit_item(cb, payload=payload)

    def make_vu():
        def on_complete(item: ItemResult) -> None:
            if item.t_completed_ms <= window_end:
                completed.append(item)
            next_t = item.t_completed_ms + think_time_ms
            if next_t < window_end:
                engine.loop.at(next_t, lambda: submit(on_complete))

        return on_complete

    for _ in range(n_vus):
        cb = make_vu()
        engine.loop.at(start_ms, lambda cb=cb: submit(cb))

    engine.loop.run_until(window_end)
    engine.loop.run_all(hard_limit_ms=window_end + 20 * 60 * 1000.0)
    return WorkflowRunResult(dag=engine.dag, items=completed, engine=engine)


def run_workflow_batch(
    engine: WorkflowEngine,
    *,
    n_items: int,
    inter_arrival_ms: float = 500.0,
    payload_fn: Optional[Callable[[int], Any]] = None,
) -> WorkflowRunResult:
    """Open-loop: push a fixed batch of items at a fixed rate and drain."""
    for i in range(n_items):
        payload = payload_fn(i) if payload_fn is not None else None
        engine.loop.at(
            i * inter_arrival_ms,
            lambda payload=payload: engine.submit_item(None, payload=payload),
        )
    engine.loop.run_all(hard_limit_ms=1e12)
    return WorkflowRunResult(dag=engine.dag, items=list(engine.items), engine=engine)


def run_workflow_open_loop(
    engine: WorkflowEngine,
    process,
    *,
    rng: np.random.RandomState,
    duration_ms: float,
    payload_fn: Optional[Callable[[int], Any]] = None,
    drain_limit_ms: float = 20 * 60 * 1000.0,
) -> WorkflowRunResult:
    """Open-loop workflow traffic: item arrivals follow an
    :class:`~repro_torch.sim.arrivals.ArrivalProcess` realization instead of the
    fixed rate of :func:`run_workflow_batch` — arrivals are independent of
    completions, so stage admission (``Stage.max_in_flight`` or a
    :class:`~repro_torch.core.control.QueueAwareAdmissionController`) is what
    absorbs bursts. Items arriving within ``duration_ms`` are measured;
    the run drains up to ``drain_limit_ms`` past the horizon."""
    from .arrivals import arrival_times_ms  # local: avoid a module cycle

    times = arrival_times_ms(process, rng, duration_ms)
    for i, t in enumerate(times):
        payload = payload_fn(i) if payload_fn is not None else None
        engine.loop.at(
            float(t),
            lambda payload=payload: engine.submit_item(None, payload=payload),
        )
    engine.loop.run_until(duration_ms)
    engine.loop.run_all(hard_limit_ms=duration_ms + drain_limit_ms)
    return WorkflowRunResult(dag=engine.dag, items=list(engine.items), engine=engine)


# ---------------------------------------------------------------------------
# ETL scenario suite (EXPERIMENTS.md §Workflow sweep)
# ---------------------------------------------------------------------------

# Stage archetypes. The extract stage is network-bound (the paper's weather
# CSV download); transforms are CPU-bound — the Minos-improvable share of an
# item's latency therefore GROWS with workflow length, which is what makes
# the paper's "longer workflows save more" claim come out monotone.
_EXTRACT = dict(prepare_ms=1200.0, body_ms=500.0, benchmark_ms=300.0)
_TRANSFORM = dict(prepare_ms=150.0, body_ms=1300.0, benchmark_ms=300.0)
_LOAD = dict(prepare_ms=300.0, body_ms=800.0, benchmark_ms=300.0)
_COMMON = dict(
    cold_start_ms=250.0,
    recycle_lifetime_ms=45_000.0,
    # higher persistence than the single-function calibration: workflow
    # items re-visit the per-stage pools quickly, so the certified speed
    # must survive long enough for re-use to compound (EXPERIMENTS.md
    # §Workflow sweep documents this choice and its sensitivity)
    contention_rho=0.995,
    benchmark_noise=0.05,
)


def _spec(name: str, archetype: dict) -> FunctionSpec:
    return FunctionSpec(name=name, **archetype, **_COMMON)


def etl_chain(n_stages: int, name: Optional[str] = None) -> WorkflowDAG:
    """Linear ETL pipeline: extract → transform×(n-2) → load. ``n_stages=1``
    degenerates to the paper's single-function scenario shape."""
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_stages == 1:
        specs = [_spec("extract", _EXTRACT)]
    else:
        specs = (
            [_spec("extract", _EXTRACT)]
            + [_spec(f"transform{i}", _TRANSFORM) for i in range(1, n_stages - 1)]
            + [_spec("load", _LOAD)]
        )
    return WorkflowDAG.chain(specs, name=name or f"etl-{n_stages}")


def etl_suite() -> Dict[str, WorkflowDAG]:
    """The 3-/5-/7-stage ETL workflows. The 3-stage is a pure chain; the
    5- and 7-stage add fan-out/fan-in (parallel transforms joined before
    load), exercising the DAG barrier."""
    three = etl_chain(3, name="etl-3")

    five = WorkflowDAG(
        [
            Stage(_spec("extract", _EXTRACT)),
            Stage(_spec("clean", _TRANSFORM), deps=("extract",)),
            Stage(_spec("enrich", _TRANSFORM), deps=("extract",)),
            Stage(_spec("join", _TRANSFORM), deps=("clean", "enrich")),
            Stage(_spec("load", _LOAD), deps=("join",)),
        ],
        name="etl-5",
    )

    seven = WorkflowDAG(
        [
            Stage(_spec("extract", _EXTRACT)),
            Stage(_spec("validate", _TRANSFORM), deps=("extract",)),
            Stage(_spec("clean", _TRANSFORM), deps=("validate",)),
            Stage(_spec("enrich", _TRANSFORM), deps=("validate",)),
            Stage(_spec("aggregate", _TRANSFORM), deps=("validate",)),
            Stage(_spec("join", _TRANSFORM), deps=("clean", "enrich", "aggregate")),
            Stage(_spec("load", _LOAD), deps=("join",)),
        ],
        name="etl-7",
    )
    return {"etl-3": three, "etl-5": five, "etl-7": seven}
