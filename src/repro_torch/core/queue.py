"""Invocation queue with requeue + retry accounting (paper §II, §IV).

Minos requires an *asynchronous* workload: invocations enter a queue; a
terminating instance re-queues its invocation before crashing so no request
is lost (at-least-once). The retry counter travels with the invocation —
it is what the emergency exit reads.

Sequence numbers are **per queue** (engine-local). An earlier revision used
one module-global counter for both invocation ids and the heap tiebreaker,
so the ids an engine produced depended on what else had run in the process
first — two engines in one process could never reproduce the ids of either
engine run alone, breaking cross-run comparability of seeded results. Now
each queue owns both counters: ids are assigned on *first* push (stable
across requeues) and the tiebreaker advances on every push.

Ordering modes:

* default (``fair=False``) — FIFO by enqueue time, then per-queue sequence:
  exactly the historical behavior, bit-identical heap keys (the seeded
  golden digests in tests/test_unified_substrate.py run through it).
* ``fair=True`` — weighted-fair by :class:`~repro_torch.sim.arrivals.QoSClass`
  weight via start-time fair queueing (virtual finish times): each push
  of class ``c`` gets key ``max(V, F_c) + 1/weight_c`` where ``V`` is the
  virtual time of the last pop and ``F_c`` the class's previous finish.
  Under a shared backlog, class throughputs converge to the weight ratio,
  and every class drains at a bounded rate — no starvation (tested in
  tests/test_lifecycle_queue.py). Ties (equal virtual finish) break on the
  per-queue sequence, preserving FIFO order within a class and across
  equal-weight classes. A requeued invocation re-enters at its class's
  *current* virtual finish — a crash costs the request its place in line,
  same as the FIFO mode's requeue-at-now semantics.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Optional


@dataclasses.dataclass
class Invocation:
    payload: Any
    enqueued_at_ms: float = 0.0
    retry_count: int = 0
    first_enqueued_at_ms: Optional[float] = None
    # assigned by the owning InvocationQueue on first push (engine-local ids);
    # an explicit id survives — the queue never reassigns a non-None id
    invocation_id: Optional[int] = None
    # bookkeeping for metrics
    terminations_experienced: int = 0
    # when the engine first popped this invocation for dispatch — the end of
    # its queue wait (requeues after a crash do not reset it)
    first_dispatched_at_ms: Optional[float] = None
    # QoS class (sim/arrivals.QoSClass): name + scheduling weight. Only the
    # fair-queue mode reads these; the default FIFO mode carries them inert.
    qos: str = "default"
    qos_weight: float = 1.0
    # failure-recovery bookkeeping (DESIGN.md §15); inert without a
    # FaultPlan/RecoveryPolicy. dispatch_epoch is bumped on every abandon/
    # failure so stale in-flight executions of this invocation can detect
    # they lost the race (idempotent re-dispatch: a zombie completion or
    # crash must not double-count). backoff_ms carries the previous
    # decorrelated-jitter delay (the "prev" in min(cap, uniform(base, 3*prev))).
    dispatch_epoch: int = 0
    failed_attempts: int = 0
    backoff_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.first_enqueued_at_ms is None:
            self.first_enqueued_at_ms = self.enqueued_at_ms


class InvocationQueue:
    """FIFO (by enqueue time, then per-queue sequence) queue with requeue
    semantics; ``fair=True`` switches to weighted-fair dequeue by QoS
    weight (see module docstring)."""

    def __init__(self, *, fair: bool = False) -> None:
        self._heap: list[tuple[float, int, Invocation]] = []
        self._seq = itertools.count()  # heap tiebreaker: every push
        self._ids = itertools.count()  # invocation ids: first push only
        self.total_enqueued = 0
        self.total_requeued = 0
        self.fair = fair
        self._vtime = 0.0  # virtual time: the key of the last pop
        self._class_vfinish: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, inv: Invocation, now_ms: float) -> None:
        if inv.invocation_id is None:
            inv.invocation_id = next(self._ids)
        inv.enqueued_at_ms = now_ms
        if self.fair:
            w = inv.qos_weight if inv.qos_weight > 0.0 else 1.0
            start = max(self._vtime, self._class_vfinish.get(inv.qos, 0.0))
            key = start + 1.0 / w
            self._class_vfinish[inv.qos] = key
        else:
            key = now_ms
        heapq.heappush(self._heap, (key, next(self._seq), inv))
        self.total_enqueued += 1

    def requeue(self, inv: Invocation, now_ms: float) -> None:
        """Called by a terminating instance right before it crashes."""
        inv.retry_count += 1
        inv.terminations_experienced += 1
        self.push(inv, now_ms)
        self.total_requeued += 1

    def pop(self) -> Invocation:
        if not self._heap:
            raise IndexError("pop from empty InvocationQueue")
        key, _, inv = heapq.heappop(self._heap)
        if self.fair and key > self._vtime:
            self._vtime = key
        return inv

    def peek_time(self) -> Optional[float]:
        """Head-of-queue heap key: enqueue time (default) or virtual
        finish (``fair=True``)."""
        return self._heap[0][0] if self._heap else None

    def waiting(self) -> list[Invocation]:
        """The queued invocations, in heap (not pop) order — for end-of-run
        accounting of censored queue waits (open-loop metrics); callers
        must not mutate the invocations' queue fields."""
        return [inv for _, _, inv in self._heap]
