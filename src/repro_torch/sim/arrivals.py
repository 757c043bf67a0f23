"""Open-loop arrival traffic: processes, QoS classes, and the driver
(DESIGN.md §12; ROADMAP item 1).

Every sweep before this module was closed-loop — a fixed lane count where
the next request fires on completion — so the paper's economic claim was
never tested in the regime where it matters: sustained open-loop traffic
where requeue storms, autoscaling lag, and queue blow-up feed back into
latency and cost. Here arrivals enqueue *independently* of completions.

The configuration idiom follows faas-offloading-sim (SNIPPETS §2): a
function's workload is either a Poisson ``rate`` or a replayable
inter-arrival-time ``trace`` file, and requests carry per-class QoS
arrival weights. Burst and diurnal rate shapes follow the Night Shift
variability methodology (PAPERS.md).

Pieces:

* :class:`ArrivalProcess` — the protocol: draw ``n`` inter-arrival times
  (ms). Implementations: :class:`PoissonProcess` (exponential IATs),
  :class:`MMPPProcess` (2-phase Markov-modulated on/off bursts),
  :class:`DiurnalPoissonProcess` (sinusoidally modulated rate, matching
  :meth:`~repro_torch.sim.variation.VariationModel.diurnal`'s shape), and
  :class:`TraceProcess` (bit-exact, seed-independent file replay).
* :class:`QoSClass` — named arrival-weight classes; arrivals draw a class
  proportionally to weight (the faas-offloading-sim ``arrival-weight``).
* :func:`run_open_loop` — drive one
  :class:`~repro_torch.core.substrate.SubstrateEngine` with an arrival process:
  arrivals flow through the controller's ``on_admit`` decision point
  (deferral back-pressure — this is where
  :class:`~repro_torch.core.control.QueueAwareAdmissionController` finally sees
  real pressure), then ``engine.submit`` (which may drop at a finite
  ``queue_capacity``); the driver samples the system population on a
  fixed cadence so Little's law is measurable *independently* of the
  per-request latencies it is compared against.

Determinism: every random draw comes from the caller's RandomState;
:class:`TraceProcess` draws nothing at all.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.analysis import sanitizer as _sanitizer
from repro_torch.core.control import AdmitContext, AdmitDecision
from repro_torch.core.substrate import RequestResult, SubstrateEngine


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


@runtime_checkable
class ArrivalProcess(Protocol):
    """A stream of inter-arrival times (milliseconds)."""

    name: str

    def iats_ms(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        """Draw the first ``n`` inter-arrival times of one realization.

        Must be a *prefix-consistent* single pass: calling with larger
        ``n`` extends the same realization for a fresh ``rng`` in the
        same state (everything here draws sequentially, so cloning the
        RandomState reproduces the stream)."""
        ...

    def mean_rate_per_ms(self) -> float:
        """Long-run mean arrival rate (1/ms) — the λ of Little's law."""
        ...


@dataclasses.dataclass(frozen=True)
class PoissonProcess:
    """Homogeneous Poisson arrivals: IATs ~ Exponential(rate)."""

    rate_per_s: float
    name: str = "poisson"

    def __post_init__(self) -> None:
        if self.rate_per_s <= 0.0:
            raise ValueError("rate_per_s must be > 0")

    def iats_ms(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        return rng.exponential(1000.0 / self.rate_per_s, size=n)

    def mean_rate_per_ms(self) -> float:
        return self.rate_per_s / 1000.0


@dataclasses.dataclass(frozen=True)
class MMPPProcess:
    """2-phase Markov-modulated Poisson process (on/off bursts).

    The rate alternates between a ``base`` (off) and a ``burst`` (on)
    Poisson rate; phase residence times are exponential with the given
    means. This is the standard burstiness model whose index of
    dispersion exceeds 1 (Poisson's), so it stresses exactly what a
    mean-rate ladder hides: admission control and queue blow-up during
    the on-phase, drain behavior after it.
    """

    base_rate_per_s: float
    burst_rate_per_s: float
    mean_off_ms: float = 20_000.0
    mean_on_ms: float = 5_000.0
    start_on: bool = False
    name: str = "mmpp"

    def __post_init__(self) -> None:
        if self.base_rate_per_s <= 0.0 or self.burst_rate_per_s <= 0.0:
            raise ValueError("rates must be > 0")
        if self.mean_off_ms <= 0.0 or self.mean_on_ms <= 0.0:
            raise ValueError("phase means must be > 0")

    def iats_with_phase(
        self, rng: np.random.RandomState, n: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(iats_ms, on_phase) — ``on_phase[i]`` is True when arrival ``i``
        lands in the burst phase (what the admission-under-burst test
        conditions on)."""
        rates = (self.base_rate_per_s / 1000.0, self.burst_rate_per_s / 1000.0)
        means = (self.mean_off_ms, self.mean_on_ms)
        iats = np.empty(n)
        on = np.empty(n, bool)
        phase = 1 if self.start_on else 0
        phase_left = rng.exponential(means[phase])
        waited = 0.0  # time since the previous arrival
        i = 0
        while i < n:
            gap = rng.exponential(1.0 / rates[phase])
            if gap < phase_left:
                # arrival inside the current phase
                phase_left -= gap
                iats[i] = waited + gap
                on[i] = bool(phase)
                waited = 0.0
                i += 1
            else:
                # phase switch first: the exponential gap restarts in the
                # new phase (memorylessness makes this exact)
                waited += phase_left
                phase = 1 - phase
                phase_left = rng.exponential(means[phase])
        return iats, on

    def iats_ms(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        return self.iats_with_phase(rng, n)[0]

    def mean_rate_per_ms(self) -> float:
        # stationary phase occupancy is proportional to the residence means
        w_on = self.mean_on_ms / (self.mean_on_ms + self.mean_off_ms)
        rate_s = (w_on * self.burst_rate_per_s
                  + (1.0 - w_on) * self.base_rate_per_s)
        return rate_s / 1000.0


@dataclasses.dataclass(frozen=True)
class DiurnalPoissonProcess:
    """Poisson arrivals with a sinusoidal day curve (thinning).

    rate(t) = base · (1 + amplitude · cos(2π(hour − phase_h)/24)) — the
    same shape :meth:`~repro_torch.sim.variation.VariationModel.diurnal`
    applies to instance *speeds*, applied to demand: load peaks are when
    contention (and the paper's variability) peaks. Sampled exactly via
    Lewis-Shedler thinning at the peak rate."""

    base_rate_per_s: float
    amplitude: float = 0.3
    phase_h: float = 14.0
    period_ms: float = 24 * 3.6e6
    name: str = "diurnal"

    def __post_init__(self) -> None:
        if self.base_rate_per_s <= 0.0:
            raise ValueError("base_rate_per_s must be > 0")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0,1)")

    def _rate_per_ms(self, t_ms: np.ndarray) -> np.ndarray:
        frac = (t_ms / self.period_ms) % 1.0
        phase_frac = self.phase_h / 24.0
        mod = 1.0 + self.amplitude * np.cos(2.0 * np.pi * (frac - phase_frac))
        return (self.base_rate_per_s / 1000.0) * mod

    def iats_ms(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        peak = (self.base_rate_per_s / 1000.0) * (1.0 + self.amplitude)
        times: List[float] = []
        t = 0.0
        while len(times) < n:
            m = max(64, 2 * (n - len(times)))
            gaps = rng.exponential(1.0 / peak, size=m)
            cand = t + np.cumsum(gaps)
            keep = rng.uniform(size=m) < self._rate_per_ms(cand) / peak
            times.extend(cand[keep][: n - len(times)])
            t = float(cand[-1])
        arr = np.asarray(times[:n])
        return np.diff(arr, prepend=0.0)

    def mean_rate_per_ms(self) -> float:
        # the cosine integrates to zero over a full period
        return self.base_rate_per_s / 1000.0


@dataclasses.dataclass(frozen=True)
class TraceProcess:
    """Replay a recorded inter-arrival-time trace, cyclically.

    Draws nothing from the RandomState: replay is bit-exact and
    seed-independent (pinned in tests/test_arrivals.py). Trace files are
    the faas-offloading-sim format: one IAT in milliseconds per line,
    ``#`` comments and blank lines ignored."""

    iats: tuple[float, ...]
    name: str = "trace"

    def __post_init__(self) -> None:
        if not self.iats:
            raise ValueError("trace must contain at least one IAT")
        if any(x < 0.0 for x in self.iats):
            raise ValueError("trace IATs must be >= 0")
        if sum(self.iats) <= 0.0:
            raise ValueError("trace must span positive time")

    @staticmethod
    def from_file(path: str, name: Optional[str] = None) -> "TraceProcess":
        iats: List[float] = []
        with open(path) as fh:
            for line in fh:
                s = line.split("#", 1)[0].strip()
                if s:
                    iats.append(float(s))
        return TraceProcess(tuple(iats), name=name or "trace")

    @staticmethod
    def from_azure_csv(
        path: str,
        function: Optional[str] = None,
        name: Optional[str] = None,
        minute_ms: float = 60_000.0,
    ) -> "TraceProcess":
        """Load an Azure-Functions-invocation-trace-style CSV.

        Format (the 2019 Azure Functions dataset): a header row, then one
        row per function — ``HashOwner,HashApp,HashFunction,Trigger``
        followed by one integer invocation count per minute. Each
        minute's ``k`` invocations expand to ``k`` evenly spaced arrivals
        inside that minute (the dataset has no sub-minute timestamps, so
        uniform spacing is the deterministic, assumption-minimal choice);
        zero-count minutes contribute pure gap. ``function`` selects a
        row by HashFunction prefix; None takes the first data row. Like
        every TraceProcess the result draws nothing from the RandomState.
        """
        with open(path) as fh:
            rows = [line.strip() for line in fh if line.strip()
                    and not line.startswith("#")]
        if len(rows) < 2:
            raise ValueError(f"no data rows in {path!r}")
        chosen: Optional[list[str]] = None
        for row in rows[1:]:  # rows[0] is the header
            cells = [c.strip() for c in row.split(",")]
            if len(cells) < 5:
                raise ValueError(f"malformed Azure trace row: {row[:60]!r}")
            if function is None or cells[2].startswith(function):
                chosen = cells
                break
        if chosen is None:
            raise ValueError(
                f"no function matching {function!r} in {path!r}")
        counts = [int(c) for c in chosen[4:]]
        if not counts or not any(counts):
            raise ValueError(
                f"Azure trace row for function {chosen[2][:8]!r} in "
                f"{path!r} has no invocations: every per-minute count "
                "column is missing or zero — pick another function row")
        if sum(counts) < 2:
            raise ValueError("trace needs >= 2 invocations to form IATs")
        times: List[float] = []
        for minute, k in enumerate(counts):
            if k <= 0:
                continue
            start = minute * minute_ms
            step = minute_ms / k
            # center the k arrivals in their minute: minute boundaries are
            # bins, not event times
            times.extend(start + step * (j + 0.5) for j in range(k))
        iats = [times[0]] + [b - a for a, b in zip(times, times[1:])]
        return TraceProcess(
            tuple(iats), name=name or f"azure[{chosen[2][:8]}]")

    def iats_ms(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        reps = -(-n // len(self.iats))  # ceil
        return np.tile(np.asarray(self.iats, float), reps)[:n]

    def mean_rate_per_ms(self) -> float:
        return len(self.iats) / sum(self.iats)


def arrival_times_ms(
    process: ArrivalProcess,
    rng: np.random.RandomState,
    duration_ms: float,
    *,
    max_arrivals: int = 1_000_000,
) -> np.ndarray:
    """Materialize one realization's arrival times within ``[0, duration)``.

    Draws IATs in chunks sized from the process's mean rate until the
    horizon is covered (``max_arrivals`` bounds pathological rates)."""
    if duration_ms <= 0.0:
        return np.empty(0)
    expect = process.mean_rate_per_ms() * duration_ms
    n = min(max_arrivals, max(16, int(expect * 1.25) + 32))
    while True:
        times = np.cumsum(process.iats_ms(rng, n))
        if times[-1] >= duration_ms or n >= max_arrivals:
            return times[times < duration_ms]
        # undershoot: redraw the whole (longer) prefix — prefix consistency
        # is per-rng-state, and the caller's rng advanced, so clone-free
        # growth means drawing again with more headroom
        n = min(max_arrivals, n * 2)


# ---------------------------------------------------------------------------
# QoS classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """A named arrival-weight class (faas-offloading-sim idiom): arrivals
    are attributed to classes proportionally to ``weight``. ``priority``
    is carried on the payload for controllers that want it; the substrate
    itself stays class-blind. ``slo_ms`` is the class's end-to-end
    latency objective — None means "no SLO"; when set, the open-loop and
    fleet summaries report per-class SLO attainment against it."""

    name: str = "default"
    weight: float = 1.0
    priority: int = 0
    slo_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError("weight must be > 0")
        if self.slo_ms is not None and self.slo_ms <= 0.0:
            raise ValueError("slo_ms must be > 0 when set")


def draw_classes(
    rng: np.random.RandomState, n: int, classes: Sequence[QoSClass]
) -> np.ndarray:
    """Class index per arrival, drawn proportionally to arrival weight."""
    w = np.asarray([c.weight for c in classes], float)
    return rng.choice(len(classes), size=n, p=w / w.sum())


# ---------------------------------------------------------------------------
# The open-loop driver
# ---------------------------------------------------------------------------


class _Item:
    __slots__ = ("payload", "arrived_at", "qos", "qos_weight", "deferred")

    def __init__(self, payload: Any, arrived_at: float, qos: str,
                 qos_weight: float = 1.0) -> None:
        self.payload = payload
        self.arrived_at = arrived_at
        self.qos = qos
        self.qos_weight = qos_weight
        self.deferred = False


@dataclasses.dataclass
class OpenLoopRun:
    """One open-loop run: per-request results plus the loss/pressure
    accounting a closed-loop run never needed.

    Conservation (pinned in tests/test_arrivals.py)::

        n_arrived == n_completed + n_dropped + n_dead_lettered
                     + n_pending_at_end

    (``n_dead_lettered`` stays 0 unless the engine carries a FaultPlan
    whose recovery exhausts retries — DESIGN.md §15.)

    ``system_samples`` is the independently measured population process
    N(t) = stage queue + in-flight + admission-deferred, sampled on a
    fixed cadence — the L of Little's law, NOT derived from the request
    timestamps it is compared against."""

    results: List[RequestResult]
    result_classes: List[str]
    n_arrived: int
    n_dropped: int
    n_deferred_items: int          # unique items that waited at admission
    n_defer_decisions: int         # DEFER answers (an item may defer twice)
    n_pending_at_end: int          # queued/deferred/in-flight when run ended
    duration_ms: float
    arrival_times_ms: np.ndarray
    system_samples: List[tuple[float, int]]  # (t_ms, N(t)) on the cadence
    drop_events: List[tuple[float, int]]
    # queue waits of requests still waiting when the run ended (censored
    # at the final clock) — what keeps open-loop wait percentiles honest
    # under blow-up (metrics.OpenLoopSummary folds these into wait_p99)
    censored_waits_ms: List[float] = dataclasses.field(default_factory=list)
    process_name: str = "?"
    n_dead_lettered: int = 0       # retries exhausted (DESIGN.md §15)

    @property
    def n_completed(self) -> int:
        return len(self.results)

    @property
    def drop_rate(self) -> float:
        return self.n_dropped / max(self.n_arrived, 1)

    @property
    def defer_rate(self) -> float:
        return self.n_deferred_items / max(self.n_arrived, 1)

    @property
    def offered_rate_per_ms(self) -> float:
        return self.n_arrived / self.duration_ms if self.duration_ms else 0.0

    def mean_system_population(self) -> float:
        """Time-averaged N(t) from the cadence samples (Little's L)."""
        if not self.system_samples:
            return 0.0
        return float(np.mean([n for _, n in self.system_samples]))


def run_open_loop(
    engine: SubstrateEngine,
    process: ArrivalProcess,
    *,
    rng: np.random.RandomState,
    duration_ms: float,
    qos_classes: Optional[Sequence[QoSClass]] = None,
    payload_fn: Optional[Callable[[int, str], Any]] = None,
    sample_every_ms: float = 250.0,
    drain: bool = True,
    drain_limit_ms: Optional[float] = None,
) -> OpenLoopRun:
    """Drive ``engine`` with open-loop arrivals for ``duration_ms``.

    Each arrival flows through the engine controller's ``on_admit``
    decision point (bound=None — only dynamic admission applies here; a
    DEFER parks the item and every completion re-offers parked items
    FIFO, with latency back-dated to true arrival time via
    ``submit(submitted_at_ms=...)``), then ``engine.submit``, which may
    drop it at a finite ``SubstrateKnobs.queue_capacity``. With ``drain``
    the run continues past the arrival horizon until in-flight work
    finishes (``drain_limit_ms`` bounds a queue that cannot drain).
    """
    if duration_ms <= 0.0:
        raise ValueError("duration_ms must be > 0")
    times = arrival_times_ms(process, rng, duration_ms)
    if qos_classes:
        cls_idx = draw_classes(rng, len(times), qos_classes)
        cls_names = [qos_classes[i].name for i in cls_idx]
        cls_weights = [qos_classes[i].weight for i in cls_idx]
    else:
        cls_names = ["default"] * len(times)
        cls_weights = [1.0] * len(times)

    results: List[RequestResult] = []
    result_classes: List[str] = []
    pending: collections.deque[_Item] = collections.deque()
    samples: List[tuple[float, int]] = []
    counts = {"deferred_items": 0, "defer_decisions": 0, "in_flight": 0,
              "dead_lettered": 0}
    arrived_before = engine.requests_arrived
    dropped_before = engine.requests_dropped

    def admits(item: _Item) -> bool:
        engine._decide("on_admit")
        decision = engine.controller.on_admit(AdmitContext(
            telemetry=engine.telemetry,
            in_flight=counts["in_flight"],
            bound=None,
            admission_queue_depth=len(pending),
        ))
        return decision is AdmitDecision.ADMIT

    def submit_item(item: _Item) -> None:
        def done(res: RequestResult) -> None:
            counts["in_flight"] -= 1
            results.append(res)
            result_classes.append(item.qos)
            while pending and admits(pending[0]):
                submit_item(pending.popleft())

        def dead(_inv: Any) -> None:
            # retries exhausted (DESIGN.md §15): the slot frees without a
            # result, and freed capacity re-offers parked items like a
            # completion would
            counts["in_flight"] -= 1
            counts["dead_lettered"] += 1
            while pending and admits(pending[0]):
                submit_item(pending.popleft())

        ok = engine.submit(item.payload, done,
                           submitted_at_ms=item.arrived_at,
                           qos=item.qos, qos_weight=item.qos_weight,
                           on_dead_letter=dead)
        if ok:
            counts["in_flight"] += 1
        # a drop is already counted by the engine; nothing more to do

    def offer(item: _Item) -> None:
        if admits(item):
            submit_item(item)
        else:
            counts["defer_decisions"] += 1
            if not item.deferred:
                item.deferred = True
                counts["deferred_items"] += 1
            pending.append(item)

    for i, (t, qos, w) in enumerate(zip(times, cls_names, cls_weights)):
        payload = payload_fn(i, qos) if payload_fn is not None else {"qos": qos}
        item = _Item(payload, float(t), qos, w)
        engine.loop.at(float(t), lambda item=item: offer(item))

    def sample() -> None:
        n_sys = (len(engine.queue) + engine.pool.total_in_flight
                 + len(pending))
        samples.append((engine.loop.now, n_sys))
        nxt = engine.loop.now + sample_every_ms
        if nxt < duration_ms:
            engine.loop.at(nxt, sample)

    if sample_every_ms > 0.0:
        engine.loop.at(0.0, sample)

    engine.loop.run_until(duration_ms)
    if drain:
        limit = (duration_ms + 20 * 60 * 1000.0
                 if drain_limit_ms is None else duration_ms + drain_limit_ms)
        engine.loop.run_all(hard_limit_ms=limit)

    n_arrived = engine.requests_arrived - arrived_before + len(pending)
    # NB: admission-deferred items that never reached submit() still count
    # as arrived — they are real offered load the engine turned away at a
    # different layer than the queue-capacity drop
    n_dropped = engine.requests_dropped - dropped_before
    # in_flight counts admitted-but-not-completed (queued + executing), so
    # together with the admission-parked items it is everything arrived
    # that neither completed nor dropped
    pending_at_end = len(pending) + counts["in_flight"]
    end_clock = engine.loop.now
    if _sanitizer.enabled():
        _sanitizer.check_open_loop(
            n_arrived=n_arrived, n_completed=len(results),
            n_dropped=n_dropped, n_pending_at_end=pending_at_end,
            n_dead_lettered=counts["dead_lettered"])
        _sanitizer.check_fault_ledger(engine, where="run_open_loop")
    censored = [end_clock - it.arrived_at for it in pending]
    censored += [
        end_clock - inv.first_enqueued_at_ms
        for inv in engine.queue.waiting()
        if inv.first_enqueued_at_ms is not None
    ]
    return OpenLoopRun(
        results=results,
        result_classes=result_classes,
        n_arrived=n_arrived,
        n_dropped=n_dropped,
        n_deferred_items=counts["deferred_items"],
        n_defer_decisions=counts["defer_decisions"],
        n_pending_at_end=pending_at_end,
        duration_ms=duration_ms,
        arrival_times_ms=times,
        system_samples=samples,
        drop_events=list(engine.drop_events),
        censored_waits_ms=censored,
        process_name=process.name,
        n_dead_lettered=counts["dead_lettered"],
    )


__all__ = [
    "ArrivalProcess",
    "DiurnalPoissonProcess",
    "MMPPProcess",
    "OpenLoopRun",
    "PoissonProcess",
    "QoSClass",
    "TraceProcess",
    "arrival_times_ms",
    "draw_classes",
    "run_open_loop",
]
