"""The shared execution substrate (DESIGN.md §9).

One copy of the machinery that used to exist twice — once in
``sim/platform.py`` and again, divergently, in ``serving/engine.py``:

* :class:`SimClock` — the discrete event loop (simulated milliseconds);
* :class:`InstancePool` — the warm pool: LIFO/FIFO reuse order,
  per-instance request concurrency, idle-timeout reclaim, and
  platform-initiated recycling;
* :class:`SubstrateEngine` — the generic invocation-processing loop
  (queue → dispatch → warm reuse | gated cold start → complete/requeue)
  with the Fig-3 cost accounting.

Every *decision* in that loop — probe or not, pass or terminate, keep /
re-probe / retire a warm instance, admit an item to a stage — is delegated
to a single :class:`~repro_torch.core.control.Controller` (DESIGN.md §10). The
default :class:`~repro_torch.core.control.ClassicMinosController` wraps the
:class:`~repro_torch.core.control.ElysiumGate` + policy stack and is pinned
bit-identical to the pre-control-plane engine by the seeded golden digests
in tests/test_unified_substrate.py; the engine hands every decision point a
read-only :class:`~repro_torch.core.control.Telemetry` view (pool load, queue
depth, clock, Welford reuse/probe/body estimates) and owns all side effects
itself (lifecycle transitions, billing, requeues).

What *differs* between the simulator and the model-serving engine is
isolated behind the :class:`Backend` protocol: where fresh-instance speeds
come from, how the prepare phase and probe are observed, and — crucially —
what the body *is*: a sampled duration for a simulated
:class:`~repro_torch.sim.platform.FunctionSpec`, real JAX prefill/decode for a
serving replica (``serving/backend.py``). Everything else (pool dynamics,
gating, billing, requeue semantics, contention drift hooks) is shared, so
behavior can no longer drift between the two paths.

Time unit: milliseconds of simulated time; deterministic given a seed.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Any, Callable, Optional, Protocol

import numpy as np

from .control import (
    ClassicMinosController,
    ColdStartContext,
    ElysiumGate,  # noqa: F401 — re-exported; the gate now lives in control.py
    FailureContext,
    FailureDecision,
    ProbeContext,
    ProbeDecision,
    ReleaseContext,
    ReuseContext,
    ReuseDecision,
    Telemetry,
)
from .cost import Pricing, WorkflowCost
from .estimators import Welford
from .lifecycle import FunctionInstance, InstanceState
from .policy import Verdict
from .queue import Invocation, InvocationQueue
from ..faults import decorrelated_jitter_ms


# ---------------------------------------------------------------------------
# Clock
# ---------------------------------------------------------------------------


class SimClock:
    """Discrete event loop over simulated milliseconds."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, t_ms: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t_ms, next(self._seq), fn))

    def after(self, dt_ms: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt_ms, fn)

    def run_until(self, t_end_ms: float) -> None:
        while self._heap and self._heap[0][0] <= t_end_ms:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        self.now = max(self.now, t_end_ms)

    def run_all(self, hard_limit_ms: float = float("inf")) -> None:
        while self._heap and self._heap[0][0] <= hard_limit_ms:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()


def sample_jitter(rng: np.random.RandomState, scale: float) -> float:
    """Multiplicative lognormal jitter; scale<=0 draws nothing (exactly 1.0),
    so disabling a noise term also removes its RNG consumption."""
    if scale <= 0.0:
        return 1.0
    return float(np.exp(rng.normal(0.0, scale)))


def ar1_drift(
    inst: FunctionInstance,
    rng: np.random.RandomState,
    *,
    day_mean: float,
    sigma: float,
    rho: float,
) -> None:
    """Co-tenancy drift, shared by both backends: AR(1) on the instance's
    log-relative speed. The benchmark certified the speed at cold-start
    time, but node neighbors change, so the advantage decays toward the
    day mean. rho>=1 is the frozen (idealized) model and draws nothing."""
    if rho >= 1.0:
        return
    log_rel = math.log(inst.speed_factor / day_mean)
    noise = rng.normal(0.0, sigma)
    log_rel = rho * log_rel + math.sqrt(1.0 - rho * rho) * noise
    inst.speed_factor = day_mean * math.exp(log_rel)


# ---------------------------------------------------------------------------
# Warm pool
# ---------------------------------------------------------------------------


class InstancePool:
    """WARM instances with spare request capacity, in reuse order.

    * ``order`` — "lifo": most recently used first (GCF gen1 / Lambda MRU
      reuse); "fifo": oldest available first (round-robin-ish);
      "spread": least-loaded first (Cloud-Run-style concurrency target —
      the order that actually relieves per-instance load when
      ``concurrency > 1``; ties fall back to FIFO).
    * ``concurrency`` — requests one warm instance serves at once; an
      instance at capacity leaves the available list until a slot frees.
    * ``recycle_lifetime_ms`` — platform-initiated instance rotation:
      each cold start draws an exponential lifetime deadline from ``rng``.
    * ``max_size`` — optional cap on *available* instances (serving
      replica pools); a release that would exceed it expires the instance.

    Invariants (tested in tests/test_unified_substrate.py): an instance
    with requests in flight is never reclaimed; every pooled instance is
    WARM, i.e. passed the gate (or was force-accepted) on its first
    invocation.

    Hot-path aggregates (PR 5): ``total_in_flight``/``n_instances``/
    ``mean_load`` are O(1) incremental counters (they are read per gate
    judgment under ``gate_load_aware``); :meth:`take` skips the
    available-list rebuild entirely while no pooled idle instance can have
    reached its idle/recycle deadline (``_next_deadline`` lower bound);
    ``order="spread"`` keeps a lazily-invalidated min-load heap instead of
    an O(n) argmin scan per take; :meth:`speeds_view` is a cached tuple.
    Equivalence with the plain O(n) scans is property-tested
    (tests/test_pool_fastpath.py). All mutation must go through the pool's
    methods — external code seeds instances with :meth:`add_warm`, never by
    appending to ``available`` directly.
    """

    def __init__(
        self,
        *,
        order: str = "lifo",
        concurrency: int = 1,
        recycle_lifetime_ms: float | None = None,
        rng: Optional[np.random.RandomState] = None,
        max_size: Optional[int] = None,
    ) -> None:
        if order not in ("lifo", "fifo", "spread"):
            raise ValueError(f"order must be 'lifo', 'fifo' or 'spread', got {order!r}")
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        self.order = order
        self.concurrency = concurrency
        self.recycle_lifetime_ms = recycle_lifetime_ms
        self.max_size = max_size
        self._rng = rng
        self.available: list[FunctionInstance] = []
        self._active: dict[int, int] = {}  # instance_id -> in-flight requests
        self._recycle_deadline: dict[int, float] = {}
        # -- incremental aggregates (kept equal to the O(n) recomputes) --
        self._in_flight = 0                       # sum(_active.values())
        self._live_ids: set[int] = set()          # avail ids | _active keys
        self._avail_seq: dict[int, int] = {}      # id -> stable position seq
        self._pos_seq = itertools.count()         # grows with each append
        # earliest idle/recycle deadline among *idle* pooled instances — a
        # lower bound: removals leave it stale-low (spurious sweep, never a
        # missed one)
        self._next_deadline = math.inf
        # (load, seq, push_id, inst) entries; only an instance's LATEST
        # push is ever valid (plus load/seq currency), so duplicates from
        # repeated take/release cycles go stale and pop lazily instead of
        # accumulating as equally-valid twins — keeps the heap bounded
        self._spread_heap: list[tuple[int, int, int, FunctionInstance]] = []
        self._spread_push = itertools.count()
        self._spread_latest: dict[int, int] = {}  # iid -> latest push id
        self._version = 0                         # bumped on any mutation
        self._speeds_cache: tuple[float, ...] = ()
        self._speeds_version = -1

    # -- lifecycle entry points ----------------------------------------
    def admit_cold(self, inst: FunctionInstance, now: float) -> None:
        """Register a freshly started instance with one request in flight
        (it is serving the invocation that caused the cold start)."""
        self._active[inst.instance_id] = 1
        self._in_flight += 1
        self._live_ids.add(inst.instance_id)
        self._version += 1
        if self.recycle_lifetime_ms is not None:
            assert self._rng is not None, "recycling requires an rng"
            self._recycle_deadline[inst.instance_id] = now + float(
                self._rng.exponential(self.recycle_lifetime_ms)
            )

    def add_warm(self, inst: FunctionInstance, *, in_flight: int = 0) -> None:
        """Admit an externally built WARM instance (tests, pool seeding) at
        ``in_flight`` requests. The instance joins ``available`` unless it
        is already at capacity — the state a normal admit+take sequence
        would have produced."""
        iid = inst.instance_id
        if in_flight:
            self._active[iid] = in_flight
            self._in_flight += in_flight
        self._version += 1
        if in_flight < self.concurrency:
            self._append_available(inst)
        self._sync_live(iid)

    def take(self, now: float) -> Optional[FunctionInstance]:
        """Reserve one request slot on a warm instance, or None."""
        # reclaim idle-expired and platform-recycled instances (never ones
        # with requests in flight). Skipped — O(1) — while no pooled idle
        # instance can have reached a deadline yet.
        if self.available and now >= self._next_deadline:
            self._sweep(now)
        if not self.available:
            return None
        if self.order == "lifo":
            idx = len(self.available) - 1
            inst = self.available[idx]
        elif self.order == "spread":
            inst = self._spread_min()
            idx = None  # resolved only if the instance must leave the list
        else:
            idx = 0
            inst = self.available[idx]
        iid = inst.instance_id
        n = self._active.get(iid, 0) + 1
        self._active[iid] = n
        self._in_flight += 1
        self._live_ids.add(iid)
        self._version += 1
        if n >= self.concurrency:  # at capacity: no longer available
            if idx is None:
                self.available.remove(inst)
            else:
                self.available.pop(idx)
            del self._avail_seq[iid]
            self._spread_latest.pop(iid, None)
        elif self.order == "spread":
            self._spread_push_entry(inst, n)
        return inst

    def release(self, inst: FunctionInstance, now: Optional[float] = None) -> None:
        """A request on ``inst`` completed: free one concurrency slot and
        return the instance to the available pool if it left it.

        Readmission applies the same reclaim filter as :meth:`take`: an
        instance whose recycle deadline (or idle timeout) has passed while
        it was serving must NOT re-enter the pool — it would inflate the
        pool views (``speeds``/``len``) until the next ``take`` swept it.
        ``now=None`` (pool used standalone) skips the time-based checks.
        """
        iid = inst.instance_id
        had = self._active.get(iid, 0)
        n = had - 1
        if n <= 0:
            self._active.pop(iid, None)
        else:
            self._active[iid] = n
        if had > 0:
            self._in_flight -= 1
        self._version += 1
        in_avail = iid in self._avail_seq
        if inst.state is InstanceState.WARM and not in_avail:
            if n <= 0 and now is not None and (
                inst.maybe_expire(now) or self._recycled(inst, now)
            ):
                self._sync_live(iid)
                return  # past its deadline while serving: reclaim, not readmit
            if self.max_size is not None and len(self.available) >= self.max_size:
                if n <= 0:
                    inst.state = InstanceState.EXPIRED  # pool full: despawn
                # else: requests still in flight — an instance is never
                # killed under live work (same invariant as take's reclaim);
                # it stays out of the available list and is re-offered when
                # its last request completes
                self._sync_live(iid)
                return
            self._append_available(inst)
        elif in_avail:
            # still pooled: refresh its min-load entry; once it drains to
            # idle, its deadline starts gating the take fast path
            if self.order == "spread":
                self._spread_push_entry(inst, max(n, 0))
            if n <= 0:
                self._fold_deadline(inst)
        self._sync_live(iid)

    def drop(self, inst: FunctionInstance) -> None:
        """A terminated (gate-failed) instance leaves without serving."""
        had = self._active.pop(inst.instance_id, None)
        if had:
            self._in_flight -= had
        self._version += 1
        self._sync_live(inst.instance_id)

    def retire(self, inst: FunctionInstance) -> None:
        """Remove ``inst`` from the pool entirely — controller-initiated
        retirement (:class:`~repro_torch.core.control.ReuseDecision` RETIRE, or a
        failed warm re-probe). The caller must ensure no *other* requests
        are in flight on it (the engine only offers reuse decisions at
        instance load 1, preserving the never-kill-under-live-work
        invariant)."""
        iid = inst.instance_id
        had = self._active.pop(iid, None)
        if had:
            self._in_flight -= had
        self._recycle_deadline.pop(iid, None)
        if iid in self._avail_seq:
            self.available.remove(inst)
            del self._avail_seq[iid]
        self._spread_latest.pop(iid, None)
        self._version += 1
        self._sync_live(iid)

    # -- internal bookkeeping -------------------------------------------
    def _sync_live(self, iid: int) -> None:
        if iid in self._active or iid in self._avail_seq:
            self._live_ids.add(iid)
        else:
            self._live_ids.discard(iid)

    def _append_available(self, inst: FunctionInstance) -> None:
        iid = inst.instance_id
        seq = next(self._pos_seq)
        self._avail_seq[iid] = seq
        self.available.append(inst)
        load = self._active.get(iid, 0)
        if self.order == "spread":
            self._spread_push_entry(inst, load)
        if load == 0:
            self._fold_deadline(inst)
        self._live_ids.add(iid)

    def _spread_push_entry(self, inst: FunctionInstance, load: int) -> None:
        pid = next(self._spread_push)
        self._spread_latest[inst.instance_id] = pid
        heapq.heappush(
            self._spread_heap,
            (load, self._avail_seq[inst.instance_id], pid, inst))
        # stale entries ABOVE the current min never surface to be popped
        # lazily, so compact once the heap outgrows the live set — O(n)
        # at a geometric trigger = amortized O(1) per operation
        if len(self._spread_heap) > 4 * len(self.available) + 8:
            self._spread_heap = [
                (self._active.get(i.instance_id, 0),
                 self._avail_seq[i.instance_id],
                 self._spread_latest[i.instance_id], i)
                for i in self.available]
            heapq.heapify(self._spread_heap)

    def _fold_deadline(self, inst: FunctionInstance) -> None:
        """Fold an idle pooled instance's reclaim deadline into the take
        fast-path bound. ``maybe_expire`` fires strictly after
        last_used + idle_timeout, so sweeping at >= the bound never misses."""
        d = inst.last_used_ms + inst.idle_timeout_ms
        rd = self._recycle_deadline.get(inst.instance_id)
        if rd is not None and rd < d:
            d = rd
        if d < self._next_deadline:
            self._next_deadline = d

    def _sweep(self, now: float) -> None:
        """The old per-take reclaim filter, now run only when a deadline
        may actually have passed. Bit-identical membership/mutation order:
        busy instances are protected (and not state-checked), idle ones
        run maybe_expire then _recycled."""
        kept: list[FunctionInstance] = []
        next_deadline = math.inf
        removed = False
        for inst in self.available:
            iid = inst.instance_id
            if self._active.get(iid, 0) > 0:
                kept.append(inst)  # in-flight: protected, drains via release
            elif not inst.maybe_expire(now) and not self._recycled(inst, now):
                kept.append(inst)
                d = inst.last_used_ms + inst.idle_timeout_ms
                rd = self._recycle_deadline.get(iid)
                if rd is not None and rd < d:
                    d = rd
                if d < next_deadline:
                    next_deadline = d
            else:
                removed = True
                del self._avail_seq[iid]
                self._spread_latest.pop(iid, None)
                self._sync_live(iid)
        if removed:
            self.available = kept
            self._version += 1
        self._next_deadline = next_deadline

    def _spread_min(self) -> FunctionInstance:
        """Current least-loaded available instance, FIFO among ties —
        identical choice to ``min(range(len(available)), key=load)`` since
        position seqs grow in list order. Amortized O(log n): stale heap
        entries (load or membership changed since push) pop lazily."""
        h = self._spread_heap
        while True:
            while h:
                load, seq, pid, inst = h[0]
                iid = inst.instance_id
                if self._avail_seq.get(iid) == seq \
                        and self._active.get(iid, 0) == load \
                        and self._spread_latest.get(iid) == pid:
                    return inst
                heapq.heappop(h)
            # heap drained (never populated for this membership): rebuild.
            # Entries pushed here are valid by construction, so the outer
            # loop terminates on the next pass.
            for inst in self.available:
                iid = inst.instance_id
                if iid not in self._avail_seq:  # seeded out-of-band
                    self._avail_seq[iid] = next(self._pos_seq)
                self._spread_push_entry(inst, self._active.get(iid, 0))

    def _recycled(self, inst: FunctionInstance, now: float) -> bool:
        deadline = self._recycle_deadline.get(inst.instance_id)
        if deadline is not None and now >= deadline:
            inst.state = InstanceState.EXPIRED
            return True
        return False

    # -- views ----------------------------------------------------------
    def speeds_view(self) -> tuple[float, ...]:
        """Certified speeds of pooled instances, as a cached immutable
        tuple — safe to hand to controllers/telemetry without a per-read
        list rebuild. The cache keys on the pool's mutation version;
        ``speed_factor`` drift always follows a ``take`` (backends drift on
        reuse), so a bumped version covers it."""
        if self._speeds_version != self._version:
            self._speeds_cache = tuple(
                i.speed_factor for i in self.available
                if i.state is InstanceState.WARM)
            self._speeds_version = self._version
        return self._speeds_cache

    @property
    def speeds(self) -> list[float]:
        """Mutable copy of :meth:`speeds_view` (compat; hot readers use the
        cached view so a caller mutating this list cannot corrupt it)."""
        return list(self.speeds_view())

    @property
    def n_warm(self) -> int:
        """Pooled WARM instances — the count the gate actually needs."""
        return len(self.speeds_view())

    def certified_speed_quantile(self, q: float) -> float:
        """q-quantile of the pooled certified speeds (nan when empty)."""
        view = self.speeds_view()
        if not view:
            return float("nan")
        return float(np.quantile(np.asarray(view), q))

    def load(self, inst: FunctionInstance) -> int:
        """Requests currently in flight on ``inst`` (0 if idle)."""
        return self._active.get(inst.instance_id, 0)

    @property
    def total_in_flight(self) -> int:
        """Requests in flight across every instance of this pool. O(1)."""
        return self._in_flight

    @property
    def n_instances(self) -> int:
        """Live instances: available + at-capacity ones serving requests.
        O(1) (was an O(pool) set rebuild per Telemetry read)."""
        return len(self._live_ids)

    def mean_load(self) -> float:
        """Mean in-flight requests per live instance, floored at 1.0 — the
        occupancy a new request should expect; the gate uses it to judge
        *effective* speed under the load-slowdown model (ROADMAP:
        concurrency-aware gating). An idle pool reports 1.0: a request never
        runs at less than single occupancy. O(1) per gate judgment."""
        n = len(self._live_ids)
        if n == 0:
            return 1.0
        return max(1.0, self._in_flight / n)

    def __len__(self) -> int:
        return len(self.available)


# ---------------------------------------------------------------------------
# Backend protocol
# ---------------------------------------------------------------------------


class Backend(Protocol):
    """What an execution backend must supply; everything else is shared.

    Durations are *observed* milliseconds (jitter/noise already applied);
    every random draw must come from the ``rng`` argument so runs stay
    deterministic per seed.
    """

    name: str

    def sample_speed(self, rng: np.random.RandomState, t_ms: float) -> float:
        """Hidden speed factor of a freshly placed instance."""
        ...

    def reuse_drift(self, inst: FunctionInstance, rng: np.random.RandomState, t_ms: float) -> None:
        """Mutate ``inst.speed_factor`` for co-tenancy drift on reuse."""
        ...

    def prepare_ms(self, rng: np.random.RandomState) -> float:
        """Observed prepare-phase duration (network-bound: does not scale
        with instance speed). Runs concurrently with the probe."""
        ...

    def probe(self, inst: FunctionInstance, rng: np.random.RandomState) -> float:
        """Run the benchmark probe on ``inst``; returns the observed
        duration and leaves it in ``inst.benchmark_result``."""
        ...

    def body(
        self,
        payload: Any,
        inst: FunctionInstance,
        rng: np.random.RandomState,
        *,
        load: int = 1,
    ) -> tuple[float, Any]:
        """Execute the body work for ``payload`` on ``inst``; returns
        (observed duration at single occupancy, output). The output rides on
        the :class:`RequestResult` (None for simulated functions).

        ``load`` is the instance's in-flight request count at body start
        (>= 1, including this request). A backend may use it to make the
        compute real — the serving backend batches its decode across the
        replica's concurrent streams — but must NOT fold it into the
        returned duration: the engine applies the platform-level
        load-slowdown curve (``SubstrateKnobs.load_slowdown_alpha``) so the
        model stays backend-independent."""
        ...

    def requeue_penalty_ms(self, payload: Any) -> float:
        """Extra delay when ``payload`` migrates to another instance after
        a termination (e.g. KV-cache re-prefill for attention families)."""
        ...

    # Optional hook (the engine probes for it with getattr):
    #   reprobe(inst, rng) -> float
    # Re-benchmark a WARM instance in place (no lifecycle transition) and
    # return the observed duration — what ReuseDecision.REPROBE runs. A
    # backend without it opts out: REPROBE quietly degrades to KEEP.


@dataclasses.dataclass
class RequestResult:
    invocation_id: int
    t_submitted_ms: float
    t_completed_ms: float
    download_ms: float        # observed prepare duration
    analysis_ms: float        # observed body duration
    retries: int              # terminated instances this request caused
    served_by_cold: bool      # final (serving) instance was a cold start
    instance_speed: float
    benchmark_ms: Optional[float] = None  # probe duration on serving instance
    output: Any = None                    # backend body output (serving: tokens)
    # time from submission (arrival / deferred-arrival time) to the FIRST
    # dispatch attempt — the open-loop queue wait. Closed-loop submits
    # dispatch immediately, so this stays 0.0 there.
    queue_wait_ms: float = 0.0

    @property
    def latency_ms(self) -> float:
        return self.t_completed_ms - self.t_submitted_ms


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubstrateKnobs:
    """Platform-level hosting knobs, backend-independent (the overlap of
    :class:`~repro_torch.sim.platform.PlatformProfile` and the serving engine's
    constructor arguments)."""

    cold_start_ms: float = 250.0
    cold_start_jitter: float = 0.25
    idle_timeout_ms: float = 15 * 60 * 1000.0
    recycle_lifetime_ms: float | None = 7 * 60 * 1000.0
    bill_cold_start: bool = True
    requeue_overhead_ms: float = 30.0
    warm_pool_order: str = "lifo"
    per_instance_concurrency: int = 1
    max_pool: Optional[int] = None
    # Self-contention: a request sharing its instance with load-1 others
    # runs load**alpha slower (alpha=0: the idealized free-concurrency
    # model; alpha=1: perfect serialization; batched serving replicas sit
    # in between — see ModelServingBackend.calibrate_load_slowdown).
    load_slowdown_alpha: float = 0.0
    # With True, the elysium gate judges a cold-start probe at the pool's
    # current mean occupancy (effective speed), not at single occupancy.
    gate_load_aware: bool = False
    # -- open-loop traffic knobs (DESIGN.md §12) ----------------------------
    # Autoscaling supply cap: live instances (busy + pooled) this deployment
    # may hold at once. None = the elastic-supply model every closed-loop
    # sweep assumed (a cold start is always possible, so the queue never
    # builds). With a cap, a dispatch that finds no warm instance AND no
    # spare instance budget leaves the invocation queued until a release —
    # this is what makes open-loop queueing (and queue blow-up) real.
    max_instances: Optional[int] = None
    # Finite queue buffer: an arrival finding this many invocations already
    # queued is dropped at submit (counted, never served) — the M/G/c/K
    # loss model. None = unbounded queue (drops never happen; sustained
    # overload shows up as unbounded waits instead).
    queue_capacity: Optional[int] = None
    # Weighted-fair dequeue by QoS class weight (start-time fair queueing;
    # core/queue.py). False keeps the historical FIFO heap keys
    # bit-identical, so seeded golden digests are unaffected.
    fair_queue: bool = False

    def load_multiplier(self, load: float) -> float:
        """Body-duration multiplier at ``load`` in-flight requests."""
        if self.load_slowdown_alpha <= 0.0 or load <= 1.0:
            return 1.0
        return float(load) ** self.load_slowdown_alpha


class SubstrateEngine:
    """The unified invocation-processing loop.

    On a cold start the probe runs concurrently with the backend's
    prepare phase (paper Fig 2); the instance is judged at the
    controller's ``on_probe`` decision point and either proceeds (body
    starts once BOTH prepare and probe are done) or re-queues the
    invocation and crashes. Warm reuse consults ``on_reuse``: KEEP is the
    paper's §II-B no-re-benchmarking default, REPROBE re-certifies a
    drifted instance (probe hidden under the prepare phase; a failure
    retires the instance and requeues the request), RETIRE despawns it
    and cold-starts instead.

    All decisions flow through ``self.controller``
    (:class:`~repro_torch.core.control.Controller`); the legacy
    ``policy``/``online_controller`` arguments build the default
    :class:`~repro_torch.core.control.ClassicMinosController`.
    """

    def __init__(
        self,
        backend: Backend,
        policy=None,
        pricing: Pricing = None,
        *,
        knobs: SubstrateKnobs = SubstrateKnobs(),
        seed: int = 0,
        online_controller=None,
        clock: Optional[SimClock] = None,
        rng: Optional[np.random.RandomState] = None,
        controller=None,
        fault_plan=None,
        recovery=None,
    ) -> None:
        if controller is None:
            if policy is None:
                raise TypeError("need a policy (classic stack) or a controller")
            controller = ClassicMinosController(policy, online_controller)
        elif policy is not None or online_controller is not None:
            raise TypeError(
                "pass either a controller or a policy/online_controller "
                "stack, not both — wrap the policy in a "
                "ClassicMinosController if you need both surfaces")
        self.backend = backend
        self.knobs = knobs
        self.controller = controller
        self.gate = getattr(controller, "gate", None)  # classic-stack view
        self.pricing = pricing
        self.rng = rng if rng is not None else np.random.RandomState(seed)
        self.loop = clock if clock is not None else SimClock()
        self.queue = InvocationQueue(fair=knobs.fair_queue)
        self.pool = InstancePool(
            order=knobs.warm_pool_order,
            concurrency=knobs.per_instance_concurrency,
            recycle_lifetime_ms=knobs.recycle_lifetime_ms,
            rng=self.rng,
            max_size=knobs.max_pool,
        )
        self.cost = WorkflowCost(pricing)
        self.results: list[RequestResult] = []
        self.instances_started = 0
        self.instances_terminated = 0
        self.instances_retired = 0    # controller RETIREs + failed re-probes
        self.reprobes = 0             # warm re-benchmarks run
        self.termination_events: list[tuple[float, float]] = []  # (t_ms, billed_ms)
        # open-loop traffic accounting (conservation: requests_arrived ==
        # len(results) + requests_dropped + queued + in-flight at any time)
        self.requests_arrived = 0
        self.requests_dropped = 0
        self.drop_events: list[tuple[float, int]] = []  # (t_ms, queue depth)
        # Welford estimates exposed through Telemetry (control plane inputs)
        self.probe_stats = Welford()      # cold probe durations (ms)
        self.log_probe_stats = Welford()  # log of the same (lognormal fit)
        self.body_stats = Welford()       # observed body durations (ms)
        self.reuse_stats = Welford()      # 1.0 warm-served / 0.0 cold-served
        # -- platform faults + recovery (DESIGN.md §15) --------------------
        # fault_plan: a repro_torch.faults.FaultPlan (own seeded RNG stream; None
        # = the historical no-fault world, bit-identical — zero extra
        # draws). recovery: a repro_torch.faults.RecoveryPolicy (timeouts,
        # bounded attempts, backoff); None = infinite immediate retries,
        # the pre-faults at-least-once semantics.
        self.fault_plan = fault_plan
        self.recovery = recovery
        self._seed = seed
        self._recovery_rng: Optional[np.random.RandomState] = None  # lazy
        self.fault_counts: dict[str, int] = {}       # kind -> occurrences
        self.fault_events: list[tuple[float, str, float]] = []  # (t, kind, billed)
        self.requests_dead_lettered = 0
        self.dead_letter_events: list[tuple[float, Optional[int], str]] = []
        self.failure_stats = Welford()  # per-attempt failure indicator (0/1)
        # abandoned (timed-out) attempts whose execution still holds an
        # instance slot — the sanitizer's pool-vs-executing slack term
        self._zombie_executions = 0
        # per-attempt failure hook (kind, Invocation) — the fleet router's
        # circuit breakers subscribe here; gate terminations never fire it
        self.fault_listener: Optional[Callable[[str, Invocation], None]] = None
        self.telemetry = Telemetry(self)
        # REPRO_SANITIZE=1 arms conservation/heap/immutability cross-checks
        # on this engine and its pool (repro_torch.analysis.sanitizer). Attached
        # per instance here so benchmarks and examples get covered too,
        # not just pytest runs; a cold env check costs one dict lookup.
        from ..analysis import sanitizer as _sanitizer
        if _sanitizer.enabled():
            _sanitizer.attach_engine(self)

    def _decide(self, point: str):
        """Count the decision-point call on the controller (sweep summaries)."""
        d = getattr(self.controller, "decisions", None)
        if d is not None:
            d[point] = d.get(point, 0) + 1

    # -- compatibility views -------------------------------------------
    @property
    def policy(self):
        return getattr(self.controller, "policy", None)

    @property
    def online_controller(self):
        return getattr(self.controller, "online_controller", None)

    @property
    def benchmark_observations(self) -> list[float]:
        return getattr(self.controller, "observations", [])

    @property
    def warm_pool_speeds(self) -> tuple[float, ...]:
        return self.pool.speeds_view()

    # ------------------------------------------------------------------
    def submit(
        self,
        payload: Any,
        on_complete: Callable[[RequestResult], None] | None = None,
        *,
        submitted_at_ms: Optional[float] = None,
        qos: str = "default",
        qos_weight: float = 1.0,
        on_dead_letter: Callable[[Invocation], None] | None = None,
    ) -> bool:
        """Enqueue one invocation; returns False when the finite queue
        buffer (``SubstrateKnobs.queue_capacity``) rejects it — or when the
        :class:`~repro_torch.faults.FaultPlan` throttles the submit or has the
        platform inside an outage window (both count as drops).

        ``submitted_at_ms`` back-dates the request's submission time (and
        therefore its reported latency/queue wait) — the open-loop driver
        uses it for items that waited at admission before being submitted.
        ``qos``/``qos_weight`` ride on the invocation; they only order
        anything under ``SubstrateKnobs.fair_queue`` (weighted-fair
        dequeue, core/queue.py). ``on_dead_letter`` fires if the request
        later exhausts its recovery budget (terminal failure) — the fleet
        router closes its logical-request ledger through it.
        """
        self.requests_arrived += 1
        plan = self.fault_plan
        if plan is not None:
            # outage is schedule (no draw); throttle is rate-gated, so it
            # is only consulted — and only draws — outside an outage
            kind = ("outage" if plan.unavailable(self.loop.now)
                    else "throttle" if plan.throttled(self.loop.now) else None)
            if kind is not None:
                self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
                self.fault_events.append((self.loop.now, kind, 0.0))
                self.requests_dropped += 1
                self.drop_events.append((self.loop.now, len(self.queue)))
                return False
        cap = self.knobs.queue_capacity
        if cap is not None and len(self.queue) >= cap:
            self.requests_dropped += 1
            self.drop_events.append((self.loop.now, len(self.queue)))
            return False
        inv = Invocation(payload={"on_complete": on_complete, "user": payload,
                                  "on_dead_letter": on_dead_letter},
                         enqueued_at_ms=self.loop.now,
                         qos=qos, qos_weight=qos_weight)
        inv.first_enqueued_at_ms = (
            self.loop.now if submitted_at_ms is None else submitted_at_ms)
        self.queue.push(inv, self.loop.now)
        self.loop.after(0.0, self._dispatch)
        return True

    def _at_instance_cap(self) -> bool:
        """Supply exhausted: no spare instance budget for a cold start."""
        cap = self.knobs.max_instances
        return cap is not None and self.pool.n_instances >= cap

    def _dispatch(self) -> None:
        if len(self.queue) == 0:
            return
        warm = self.pool.take(self.loop.now)
        if warm is None and self._at_instance_cap():
            # no warm instance and the autoscaling cap is reached: the
            # invocation stays queued; every release/retire re-dispatches,
            # so the queue drains as capacity frees (open-loop queueing)
            return
        inv = self.queue.pop()
        if inv.first_dispatched_at_ms is None:
            inv.first_dispatched_at_ms = self.loop.now
        if warm is not None:
            self._run_on_warm(inv, warm)
        else:
            self._cold_start(inv)

    # ------------------------------------------------------------------
    def _run_on_warm(self, inv: Invocation, inst: FunctionInstance) -> None:
        t0 = self.loop.now
        self.backend.reuse_drift(inst, self.rng, t0)

        # Reuse decisions are only offered for a solo request (instance
        # load 1): REPROBE/RETIRE end the instance, which must never happen
        # under other live work (pool invariant). KEEP draws no RNG, so the
        # default controller's stream is bit-identical to the old engine.
        decision = ReuseDecision.KEEP
        if self.pool.load(inst) == 1:
            self._decide("on_reuse")
            decision = self.controller.on_reuse(ReuseContext(
                telemetry=self.telemetry,
                instance=inst,
                retry_count=inv.retry_count,
                age_ms=t0 - inst.created_at_ms,
                uses_since_probe=inst.serves_since_probe,
                ms_since_probe=(None if inst.last_probe_ms is None
                                else t0 - inst.last_probe_ms),
            ))

        if decision is ReuseDecision.RETIRE:
            # graceful despawn: nothing billed (idle-reclaim analog); the
            # request that wanted the instance cold-starts instead
            inst.state = InstanceState.EXPIRED
            self.pool.retire(inst)
            self.instances_retired += 1
            self._cold_start(inv)
            return

        bench: Optional[float] = None
        if decision is ReuseDecision.REPROBE:
            reprobe = getattr(self.backend, "reprobe", None)
            if reprobe is not None:
                bench = float(reprobe(inst, self.rng))
                self.reprobes += 1
                inst.last_probe_ms = t0
                inst.serves_since_probe = 0
                self._decide("on_probe")
                verdict = self.controller.on_probe(ProbeContext(
                    telemetry=self.telemetry, instance=inst,
                    observed_ms=bench, retry_count=inv.retry_count,
                    is_cold=False,
                ))
                if verdict is Verdict.TERMINATE:
                    # drifted below the bar: retire, requeue the request.
                    # Billed: the re-probe wall time (the instance was busy
                    # measuring itself instead of serving).
                    self.instances_retired += 1
                    inst.state = InstanceState.TERMINATED
                    self.pool.retire(inst)
                    billed = bench
                    delay = self.knobs.requeue_overhead_ms + \
                        self.backend.requeue_penalty_ms(inv.payload["user"])

                    def _retire_crash() -> None:
                        self.cost.record_terminated(billed)
                        self.termination_events.append((self.loop.now, billed))
                        self.queue.requeue(inv, self.loop.now)
                        self.loop.after(delay, self._dispatch)

                    self.loop.after(bench, _retire_crash)
                    return

        download = self.backend.prepare_ms(self.rng)
        load = self.pool.load(inst)  # in-flight count incl. this request
        analysis, output = self.backend.body(
            inv.payload["user"], inst, self.rng, load=load
        )
        mult = self.knobs.load_multiplier(load)
        if self.fault_plan is not None:
            mult *= self.fault_plan.speed_multiplier(t0)  # brownout window
        if mult != 1.0:
            analysis *= mult
        # a re-probe runs concurrently with the prepare phase (paper Fig 2
        # applied to warm reuse): body starts once both are done
        ready = download if bench is None else max(download, bench)
        duration = ready + analysis
        self._schedule_execution(
            inv, inst, pre_ms=0.0, duration=duration, download=download,
            analysis=analysis, served_by_cold=False,
            speed=None,  # warm: report speed as of completion (post-drift)
            bench=bench, output=output, billed_base=0.0)

    def _cold_start(self, inv: Invocation) -> None:
        knobs = self.knobs
        t0 = self.loop.now
        self.instances_started += 1
        speed = self.backend.sample_speed(self.rng, t0)
        inst = FunctionInstance(
            speed_factor=speed,
            created_at_ms=t0,
            idle_timeout_ms=knobs.idle_timeout_ms,
        )
        self.pool.admit_cold(inst, t0)
        cold = knobs.cold_start_ms * sample_jitter(self.rng, knobs.cold_start_jitter)
        download = self.backend.prepare_ms(self.rng)

        billed_cold = cold if knobs.bill_cold_start else 0.0
        plan = self.fault_plan

        if plan is not None and plan.cold_start_fails(t0):
            # the instance never comes up: startup time is billed (if the
            # platform bills cold starts), no user code runs, the request
            # goes through failure recovery. Not a gate termination — the
            # controller never saw this instance.
            inst.state = InstanceState.TERMINATED
            self.pool.drop(inst)
            billed = billed_cold

            def _cold_fail() -> None:
                self.cost.record_terminated(billed)
                self.fault_events.append((self.loop.now, "cold_start", billed))
                self._handle_failure(inv, "cold_start")

            self.loop.after(cold, _cold_fail)
            return

        load = self.pool.load(inst)  # 1 unless warm takes landed mid-start
        mult = self.knobs.load_multiplier(load)
        if plan is not None:
            mult *= plan.speed_multiplier(t0)  # brownout window

        self._decide("on_cold_start")
        probe_decision = self.controller.on_cold_start(ColdStartContext(
            telemetry=self.telemetry, retry_count=inv.retry_count))
        if probe_decision is ProbeDecision.SKIP:
            # baseline arm, or emergency exit: run the body directly
            inst.accept_without_benchmark()  # FORCED_PASS / baseline accept
            analysis, output = self.backend.body(
                inv.payload["user"], inst, self.rng, load=load
            )
            if mult != 1.0:
                analysis *= mult
            duration = download + analysis
            self._schedule_execution(
                inv, inst, pre_ms=cold, duration=duration, download=download,
                analysis=analysis, served_by_cold=True, speed=speed,
                bench=None, output=output, billed_base=billed_cold)
            return

        if plan is not None and plan.probe_times_out(t0):
            # the benchmark hangs: the platform kills the instance after
            # the watchdog window and bills the wait; the probe result
            # never materializes (no probe_stats update, no gate judgment
            # — the gate cannot misread an instance it never measured).
            inst.state = InstanceState.TERMINATED
            self.pool.drop(inst)
            billed = billed_cold + plan.probe_timeout_ms

            def _probe_hang() -> None:
                self.cost.record_terminated(billed)
                self.fault_events.append(
                    (self.loop.now, "probe_timeout", billed))
                self._handle_failure(inv, "probe_timeout")

            self.loop.after(cold + plan.probe_timeout_ms, _probe_hang)
            return

        # Minos path: probe runs in parallel with the prepare phase.
        bench = self.backend.probe(inst, self.rng)
        inst.last_probe_ms = t0
        inst.serves_since_probe = 0
        self.probe_stats.update(bench)
        self.log_probe_stats.update(math.log(bench))
        self._decide("on_probe")
        verdict = self.controller.on_probe(ProbeContext(
            telemetry=self.telemetry, instance=inst, observed_ms=bench,
            retry_count=inv.retry_count, is_cold=True))
        if inst.state is InstanceState.BENCHMARKING:
            # a pure-decision controller (no gate) left lifecycle to us
            inst.verdict = verdict
            inst.state = (InstanceState.TERMINATED if verdict is Verdict.TERMINATE
                          else InstanceState.WARM)
        if verdict is Verdict.TERMINATE:
            # judged as soon as the probe finishes; requeue + crash.
            # Billed: startup + probe wall time (prepare is torn down with
            # the instance; the platform bills active instance time).
            self.instances_terminated += 1
            self.pool.drop(inst)
            billed = billed_cold + bench
            delay = knobs.requeue_overhead_ms + self.backend.requeue_penalty_ms(
                inv.payload["user"]
            )

            def _crash() -> None:
                self.cost.record_terminated(billed)
                self.termination_events.append((self.loop.now, billed))
                self.queue.requeue(inv, self.loop.now)
                self.loop.after(delay, self._dispatch)

            self.loop.after(cold + bench, _crash)
            return

        # passed (or forced): body starts once BOTH prepare and probe done
        analysis, output = self.backend.body(
            inv.payload["user"], inst, self.rng, load=load
        )
        if mult != 1.0:
            analysis *= mult
        ready = max(download, bench)
        duration = ready + analysis
        self._schedule_execution(
            inv, inst, pre_ms=cold, duration=duration, download=download,
            analysis=analysis, served_by_cold=True, speed=speed,
            bench=bench, output=output, billed_base=billed_cold)

    # -- in-flight phase + failure recovery (DESIGN.md §15) -------------
    def _schedule_execution(
        self,
        inv: Invocation,
        inst: FunctionInstance,
        *,
        pre_ms: float,
        duration: float,
        download: float,
        analysis: float,
        served_by_cold: bool,
        speed: Optional[float],
        bench: Optional[float],
        output: Any,
        billed_base: float,
    ) -> None:
        """Schedule the in-flight phase of one dispatch attempt.

        Without a :class:`~repro_torch.faults.FaultPlan` this performs exactly
        the historical completion (serve → bill → release → finish →
        dispatch) at ``pre_ms + duration``, with zero extra RNG draws.
        With one, the attempt's fate is drawn up front from the plan's
        private stream: a mid-body crash bills the *partial* duration
        (Fig-3 ``d_term``) and loses the work; a lost completion bills the
        *full* duration but never delivers the result. Either way the
        request goes through :meth:`_handle_failure`.

        ``inv.dispatch_epoch`` is captured here; a
        :class:`~repro_torch.faults.RecoveryPolicy` timeout that fires first
        bumps it, turning this attempt into a zombie — its completion (or
        crash) still bills and frees the instance, but is dropped exactly
        once, never finished (idempotent re-dispatch: a retried request
        can never double-count). ``speed=None`` reports the instance's
        speed as of completion time (warm path: post-drift), matching the
        historical closure semantics bit-for-bit.
        """
        t0 = self.loop.now
        epoch = inv.dispatch_epoch
        plan = self.fault_plan
        crash_frac: Optional[float] = None
        lost = False
        if plan is not None:
            crash_frac = plan.crash_mid_body(t0)
            if crash_frac is None:
                lost = plan.completion_lost(t0)

        if crash_frac is not None:
            run_ms = pre_ms + crash_frac * duration
            billed = billed_base + crash_frac * duration

            def _crash_mid_body() -> None:
                now = self.loop.now
                self.cost.record_terminated(billed)
                self.fault_events.append((now, "crash", billed))
                if served_by_cold:
                    inst.state = InstanceState.TERMINATED
                    self.pool.drop(inst)
                elif self.pool.load(inst) <= 1:
                    inst.state = InstanceState.TERMINATED
                    self.pool.retire(inst)
                else:
                    # other requests live on this instance: take the fault
                    # at execution scope (never-kill-under-live-work)
                    self.pool.release(inst, now)
                if inv.dispatch_epoch != epoch:
                    self._zombie_executions -= 1  # abandoned before crashing
                    self._dispatch()
                    return
                self._handle_failure(inv, "crash")

            self.loop.after(run_ms, _crash_mid_body)
            self._maybe_schedule_abandon(inv, epoch, t0 + run_ms)
            return

        def _complete() -> None:
            now = self.loop.now
            inst.serve(now)
            if served_by_cold:
                self.cost.record_passed(billed_base + duration)
            else:
                self.cost.record_reused(duration)
            self.pool.release(inst, now)
            if inv.dispatch_epoch != epoch:
                # timed-out attempt: billed, instance freed, result
                # discarded — the retry owns the request now
                self._zombie_executions -= 1
                self.fault_events.append((now, "stale_completion", 0.0))
                self._dispatch()
                return
            if lost:
                # the body ran (and is billed) but the completion
                # notification vanished; detected when it would have been
                # delivered (stand-in for a client acknowledgment timer)
                self.fault_events.append((now, "lost", 0.0))
                self._handle_failure(inv, "lost")
                return
            self._finish(inv, t0, download, analysis,
                         served_by_cold=served_by_cold,
                         speed=inst.speed_factor if speed is None else speed,
                         bench=bench, output=output)
            self._dispatch()

        self.loop.after(pre_ms + duration, _complete)
        if not lost:
            self._maybe_schedule_abandon(inv, epoch, t0 + pre_ms + duration)

    def _maybe_schedule_abandon(
        self, inv: Invocation, epoch: int, t_end_abs: float,
    ) -> None:
        """Arm the per-request timeout: if this attempt would resolve past
        ``first_enqueued + RecoveryPolicy.timeout_ms``, abandon it at the
        deadline (the execution keeps running as a billed zombie)."""
        rec = self.recovery
        if rec is None or rec.timeout_ms is None:
            return
        base = inv.first_enqueued_at_ms
        deadline = (0.0 if base is None else base) + rec.timeout_ms
        if t_end_abs <= deadline:
            return

        def _abandon() -> None:
            if inv.dispatch_epoch != epoch:
                return  # attempt already resolved another way
            self._zombie_executions += 1
            self.fault_events.append((self.loop.now, "timeout", 0.0))
            self._handle_failure(inv, "timeout")

        self.loop.after(max(0.0, deadline - self.loop.now), _abandon)

    def _handle_failure(self, inv: Invocation, kind: str) -> None:
        """One dispatch attempt failed (``kind``: crash / cold_start /
        probe_timeout / lost / timeout): consult the controller's
        ``on_failure`` decision point, then retry with backoff or
        dead-letter. ``RecoveryPolicy.max_attempts`` bounds total attempts
        regardless of the controller's answer."""
        inv.dispatch_epoch += 1
        inv.failed_attempts += 1
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        self.failure_stats.update(1.0)
        if self.fault_listener is not None:
            self.fault_listener(kind, inv)
        decision = FailureDecision.RETRY
        on_failure = getattr(self.controller, "on_failure", None)
        if on_failure is not None:
            self._decide("on_failure")
            first = inv.first_enqueued_at_ms
            decision = on_failure(FailureContext(
                telemetry=self.telemetry,
                kind=kind,
                invocation_id=inv.invocation_id,
                attempts=inv.failed_attempts,
                elapsed_ms=(0.0 if first is None
                            else self.loop.now - first),
                qos=inv.qos,
            ))
        rec = self.recovery
        if rec is not None and inv.failed_attempts >= rec.max_attempts:
            decision = FailureDecision.DEAD_LETTER
        if decision is FailureDecision.DEAD_LETTER:
            self._dead_letter(inv, kind)
            return
        self.queue.requeue(inv, self.loop.now)
        delay = self.knobs.requeue_overhead_ms + \
            self.backend.requeue_penalty_ms(inv.payload["user"])
        if rec is not None:
            delay += self._backoff_ms(inv)
        self.loop.after(delay, self._dispatch)

    def _backoff_ms(self, inv: Invocation) -> float:
        """Capped decorrelated-jitter backoff, drawn from a private RNG
        stream (retry jitter must not shift the engine's own draws)."""
        rec = self.recovery
        if rec is None or rec.backoff_base_ms <= 0.0:
            return 0.0
        if self._recovery_rng is None:
            self._recovery_rng = np.random.RandomState(
                (self._seed ^ 0x9E3779B9) & 0xFFFFFFFF)
        delay = decorrelated_jitter_ms(
            self._recovery_rng, inv.backoff_ms,
            base_ms=rec.backoff_base_ms, cap_ms=rec.backoff_cap_ms)
        inv.backoff_ms = delay
        return delay

    def _dead_letter(self, inv: Invocation, kind: str) -> None:
        """Terminal failure: the request leaves the system unserved (and
        is conserved as ``requests_dead_lettered``, not as a drop)."""
        self.requests_dead_lettered += 1
        self.dead_letter_events.append(
            (self.loop.now, inv.invocation_id, kind))
        cb = inv.payload.get("on_dead_letter")
        if cb is not None:
            cb(inv)
        self._dispatch()

    # ------------------------------------------------------------------
    def _finish(
        self, inv: Invocation, t0: float, download: float, analysis: float,
        *, served_by_cold: bool, speed: float, bench: Optional[float],
        output: Any = None,
    ) -> None:
        res = RequestResult(
            invocation_id=inv.invocation_id,
            # NB: 0.0 is a valid submit time — only None falls back to t0
            t_submitted_ms=t0 if inv.first_enqueued_at_ms is None else inv.first_enqueued_at_ms,
            t_completed_ms=self.loop.now,
            download_ms=download,
            analysis_ms=analysis,
            retries=inv.terminations_experienced,
            served_by_cold=served_by_cold,
            instance_speed=speed,
            benchmark_ms=bench,
            output=output,
            queue_wait_ms=(
                0.0 if inv.first_dispatched_at_ms is None
                or inv.first_enqueued_at_ms is None
                else max(0.0, inv.first_dispatched_at_ms - inv.first_enqueued_at_ms)),
        )
        self.results.append(res)
        # control-plane estimator feed (Telemetry reads these Welfords)
        self.reuse_stats.update(0.0 if served_by_cold else 1.0)
        self.body_stats.update(analysis)
        self.failure_stats.update(0.0)  # a successfully finished attempt
        self._decide("on_release")
        self.controller.on_release(ReleaseContext(
            telemetry=self.telemetry, result=res))
        cb = inv.payload.get("on_complete")
        if cb is not None:
            cb(res)
