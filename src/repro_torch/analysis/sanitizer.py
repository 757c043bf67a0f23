"""Runtime substrate sanitizer (DESIGN.md §13, env-gated).

``REPRO_SANITIZE=1`` arms cross-checks of the invariants the static rules
cannot see — the ones that live in *state*, not syntax:

* **pool conservation** — ``InstancePool._in_flight`` (the O(1) counter
  the load-aware gate reads per judgment, PR 5) must equal
  ``sum(_active.values())``; ``_live_ids`` must equal
  ``_active.keys() | _avail_seq.keys()``; ``available`` and ``_avail_seq``
  must agree element-for-element.
* **spread-heap consistency** — the lazily-invalidated min-load heap's
  best *valid* entry (latest push id, current load, current seq) must
  name the same instance a full O(n) argmin over ``available`` would.
* **deadline bound** — ``_next_deadline`` is a lower bound: no idle
  pooled instance's reclaim deadline may lie below it (a stale-low bound
  costs a spurious sweep; a stale-high one silently skips reclaims).
* **engine conservation** — ``requests_arrived == len(results) +
  requests_dropped + len(queue) + executing`` at every submit/finish,
  with ``executing`` tracked independently by wrapping the queue's
  ``pop``/``requeue`` (the event-stream side of the ledger); and every
  executing request implies a pending completion event on the clock heap.
* **telemetry immutability** — the read-only view must actually reject
  attribute writes (probed once at attach).
* **fault ledger** (DESIGN.md §15) — with a FaultPlan armed, every
  injected fault must bill a finite non-negative amount, the dead-letter
  counter must match its event log, and no request may be both
  dead-lettered and completed (the idempotent-re-dispatch guarantee).
  The engine conservation equation gains a ``dead_lettered`` term, and
  the pool bound tolerates *zombie* executions — abandoned attempts
  whose instance slot is still legitimately held until their scheduled
  completion/crash event fires.
* **finite outputs** — vectorized-sim summaries must be NaN/inf-free
  (:func:`check_finite`), and the vectorized open-loop summary must
  conserve requests per arm (:func:`check_open_summary`).

Wrapping is per-instance (bound-method replacement on the engine/pool
being sanitized), never global monkeypatching — two engines in one
process sanitize independently, and an un-sanitized engine pays nothing.
Full structural pool checks are O(pool) so they run sampled (every
``_SAMPLE_EVERY`` mutations) plus always after ``retire`` — the lifecycle
edge PRs 4–6 kept re-breaking; per-operation checks stay O(1). Overhead
is measured in BENCH_substrate.sanitize.json (target <=2x).
"""
from __future__ import annotations

import math
import os
from typing import Any, Optional

ENV_VAR = "REPRO_SANITIZE"

#: full O(pool) structural checks run every N pool mutations (and always
#: after retire); O(1) counter checks run on every mutation.
_SAMPLE_EVERY = 32


def enabled() -> bool:
    """True when the sanitizer env gate is set (anything but ''/'0')."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


class SanitizerError(AssertionError):
    """An armed invariant failed. Subclasses AssertionError so existing
    ``pytest.raises(AssertionError)`` harnesses and -O semantics hold."""


def _fail(what: str, **context: Any) -> None:
    detail = ", ".join(f"{k}={v!r}" for k, v in context.items())
    raise SanitizerError(f"[{ENV_VAR}] {what} ({detail})")


# ---------------------------------------------------------------------------
# Pool checks
# ---------------------------------------------------------------------------


def check_pool(pool: Any, *, where: str = "") -> None:
    """Full structural verification of an :class:`InstancePool` — the
    O(n) recomputations the incremental aggregates (PR 5) replaced."""
    active = pool._active
    recomputed = sum(active.values())
    if pool._in_flight != recomputed:
        _fail("pool._in_flight diverged from sum(_active.values())",
              where=where, counter=pool._in_flight, recomputed=recomputed)
    if pool._in_flight < 0:
        _fail("pool._in_flight negative", where=where, value=pool._in_flight)
    for iid, n in active.items():
        if n <= 0:
            _fail("zero/negative in-flight entry kept in _active",
                  where=where, instance=iid, in_flight=n)
    avail_ids = [i.instance_id for i in pool.available]
    if len(set(avail_ids)) != len(avail_ids):
        _fail("duplicate instance in available list", where=where,
              ids=avail_ids)
    if set(avail_ids) != set(pool._avail_seq):
        _fail("available list and _avail_seq disagree", where=where,
              available=sorted(set(avail_ids)),
              avail_seq=sorted(pool._avail_seq))
    expected_live = set(active) | set(pool._avail_seq)
    if pool._live_ids != expected_live:
        _fail("_live_ids diverged from _active | _avail_seq", where=where,
              live=sorted(pool._live_ids), expected=sorted(expected_live))
    for inst in pool.available:
        if active.get(inst.instance_id, 0) > pool.concurrency:
            _fail("available instance above concurrency cap", where=where,
                  instance=inst.instance_id,
                  load=active[inst.instance_id], cap=pool.concurrency)
    _check_deadline_bound(pool, where=where)
    if pool.order == "spread":
        _check_spread_heap(pool, where=where)


def _check_deadline_bound(pool: Any, *, where: str) -> None:
    bound = pool._next_deadline
    if bound == math.inf:
        return
    for inst in pool.available:
        iid = inst.instance_id
        if pool._active.get(iid, 0) > 0:
            continue  # busy instances are reclaim-protected
        d = inst.last_used_ms + inst.idle_timeout_ms
        rd = pool._recycle_deadline.get(iid)
        if rd is not None and rd < d:
            d = rd
        if d < bound:
            _fail("_next_deadline above an idle instance's deadline "
                  "(sweep would fire late)", where=where, instance=iid,
                  deadline=d, bound=bound)


def _check_spread_heap(pool: Any, *, where: str) -> None:
    """The heap's best *valid* entry must match the O(n) argmin the heap
    replaced (load, then position seq — FIFO among ties)."""
    if not pool.available:
        return
    expected = min(
        ((pool._active.get(i.instance_id, 0), pool._avail_seq[i.instance_id])
         for i in pool.available))
    best: Optional[tuple] = None
    for load, seq, pid, inst in pool._spread_heap:
        iid = inst.instance_id
        if pool._spread_latest.get(iid) != pid:
            continue  # superseded push
        if iid not in pool._avail_seq or pool._avail_seq[iid] != seq:
            continue  # left the pool / moved since this push
        if pool._active.get(iid, 0) != load:
            continue  # load changed since this push
        if best is None or (load, seq) < best:
            best = (load, seq)
    if best is None:
        _fail("spread heap has no valid entry while pool is non-empty",
              where=where, heap_size=len(pool._spread_heap),
              available=len(pool.available))
    if best != expected:
        _fail("spread heap min diverged from O(n) argmin", where=where,
              heap_min=best, argmin=expected)


def attach_pool(pool: Any) -> None:
    """Arm a pool: O(1) counter checks on every mutator call, a full
    :func:`check_pool` every ``_SAMPLE_EVERY`` mutations and after every
    ``retire`` (the edge where counter/heap drift historically entered)."""
    if getattr(pool, "_sanitizer_armed", False):
        return
    pool._sanitizer_armed = True
    state = {"ops": 0}

    def _wrap(name: str, always_full: bool = False):
        inner = getattr(pool, name)

        def wrapped(*args: Any, **kwargs: Any):
            out = inner(*args, **kwargs)
            state["ops"] += 1
            if pool._in_flight < 0:
                _fail("pool._in_flight negative", where=name,
                      value=pool._in_flight)
            if always_full or state["ops"] % _SAMPLE_EVERY == 0:
                check_pool(pool, where=name)
            return out

        wrapped.__name__ = f"sanitized_{name}"
        setattr(pool, name, wrapped)

    for mutator in ("take", "release", "drop", "add_warm", "admit_cold"):
        _wrap(mutator)
    _wrap("retire", always_full=True)


# ---------------------------------------------------------------------------
# Engine checks
# ---------------------------------------------------------------------------


def check_telemetry_readonly(telemetry: Any) -> None:
    """The Telemetry view handed to controllers must reject writes."""
    try:
        telemetry._sanitizer_probe = 1
    except (AttributeError, TypeError):
        return
    try:  # undo the mutation we just proved possible
        del telemetry._sanitizer_probe
    except Exception:
        pass
    _fail("Telemetry accepted an attribute write — the read-only "
          "controller contract is void", type=type(telemetry).__name__)


def check_engine_conservation(engine: Any, *, where: str = "") -> None:
    executing = engine._sanitizer_executing
    dead = getattr(engine, "requests_dead_lettered", 0)
    zombies = getattr(engine, "_zombie_executions", 0)
    lhs = engine.requests_arrived
    rhs = (len(engine.results) + engine.requests_dropped
           + len(engine.queue) + executing + dead)
    if lhs != rhs:
        _fail("engine conservation violated: arrived != results + dropped "
              "+ queued + executing + dead_lettered", where=where,
              arrived=lhs, results=len(engine.results),
              dropped=engine.requests_dropped, queued=len(engine.queue),
              executing=executing, dead_lettered=dead)
    if executing < 0:
        _fail("executing count negative", where=where, executing=executing)
    if zombies < 0:
        _fail("zombie execution count negative", where=where, zombies=zombies)
    # event-stream cross-check: each executing request has a pending
    # completion/crash event; the clock heap may hold extra dispatch
    # timers but never fewer events than executing requests
    if executing > len(engine.loop._heap):
        _fail("executing requests exceed pending clock events", where=where,
              executing=executing, pending_events=len(engine.loop._heap))
    # zombie slack: a timed-out-and-requeued request leaves its original
    # attempt holding a pool slot until that attempt's event fires
    if engine.pool.total_in_flight > executing + zombies:
        _fail("pool in-flight exceeds dispatched-but-unfinished requests",
              where=where, pool_in_flight=engine.pool.total_in_flight,
              executing=executing, zombies=zombies)


def check_fault_ledger(engine: Any, *, where: str = "") -> None:
    """Fault-injection bookkeeping invariants (DESIGN.md §15). Cheap
    unless dead letters exist; no-op on engines without a FaultPlan."""
    events = getattr(engine, "fault_events", None)
    if events is None:
        return
    for t_ms, kind, billed in events:
        if not (math.isfinite(billed) and billed >= 0.0):
            _fail("fault event billed a non-finite or negative amount",
                  where=where, t_ms=t_ms, kind=kind, billed=billed)
    dead_events = getattr(engine, "dead_letter_events", ())
    n_dead = getattr(engine, "requests_dead_lettered", 0)
    if n_dead != len(dead_events):
        _fail("dead-letter counter diverged from its event log",
              where=where, counter=n_dead, events=len(dead_events))
    if dead_events:
        completed_ids = {
            r.invocation_id for r in engine.results
            if getattr(r, "invocation_id", None) is not None}
        both = {iid for _, iid, _ in dead_events
                if iid is not None} & completed_ids
        if both:
            _fail("request both dead-lettered and completed (idempotent "
                  "re-dispatch broken)", where=where,
                  invocation_ids=sorted(both)[:5])


def attach_engine(engine: Any) -> None:
    """Arm a :class:`SubstrateEngine`: pool checks plus conservation /
    event-stream ledger around submit, dispatch (queue.pop), requeue and
    finish. Idempotent; per-instance (no global monkeypatching)."""
    if getattr(engine, "_sanitizer_armed", False):
        return
    engine._sanitizer_armed = True
    engine._sanitizer_executing = 0
    check_telemetry_readonly(engine.telemetry)
    attach_pool(engine.pool)

    queue_pop = engine.queue.pop
    queue_requeue = engine.queue.requeue
    engine_finish = engine._finish
    engine_submit = engine.submit
    engine_dead_letter = getattr(engine, "_dead_letter", None)

    def pop_wrapped(*args: Any, **kwargs: Any):
        inv = queue_pop(*args, **kwargs)
        engine._sanitizer_executing += 1
        return inv

    def requeue_wrapped(*args: Any, **kwargs: Any):
        out = queue_requeue(*args, **kwargs)
        engine._sanitizer_executing -= 1
        check_engine_conservation(engine, where="requeue")
        return out

    def finish_wrapped(*args: Any, **kwargs: Any):
        engine._sanitizer_executing -= 1
        out = engine_finish(*args, **kwargs)
        check_engine_conservation(engine, where="_finish")
        return out

    def submit_wrapped(*args: Any, **kwargs: Any):
        out = engine_submit(*args, **kwargs)
        check_engine_conservation(engine, where="submit")
        return out

    engine.queue.pop = pop_wrapped
    engine.queue.requeue = requeue_wrapped
    engine._finish = finish_wrapped
    engine.submit = submit_wrapped

    if engine_dead_letter is not None:
        def dead_letter_wrapped(*args: Any, **kwargs: Any):
            engine._sanitizer_executing -= 1
            out = engine_dead_letter(*args, **kwargs)
            check_engine_conservation(engine, where="_dead_letter")
            check_fault_ledger(engine, where="_dead_letter")
            return out

        engine._dead_letter = dead_letter_wrapped


# ---------------------------------------------------------------------------
# Open-loop + vectorized-output checks
# ---------------------------------------------------------------------------


def check_open_loop(*, n_arrived: int, n_completed: int, n_dropped: int,
                    n_pending_at_end: int, n_dead_lettered: int = 0) -> None:
    """run_open_loop conservation: everything offered either completed,
    dropped, dead-lettered, or is still parked/queued/in flight at the
    horizon. ``n_dead_lettered`` defaults to 0 (fault-free runs)."""
    if n_arrived != (n_completed + n_dropped + n_pending_at_end
                     + n_dead_lettered):
        _fail("open-loop conservation violated: arrived != completed + "
              "dropped + dead_lettered + pending_at_end", arrived=n_arrived,
              completed=n_completed, dropped=n_dropped,
              dead_lettered=n_dead_lettered,
              pending_at_end=n_pending_at_end)


def check_fleet_conservation(
    *,
    n_arrived: int,
    n_completed: int,
    n_dropped: int,
    n_pending: int,
    n_hedges: int,
    n_hedge_dropped: int,
    n_hedge_cancelled: int,
    per_fleet_arrived: tuple,
    per_fleet_completed: tuple,
    per_fleet_dropped: tuple,
    per_fleet_parked: tuple,
    n_rejected: int = 0,
    n_dead_lettered: int = 0,
    n_hedge_dead_lettered: int = 0,
    per_fleet_dead_lettered: Optional[tuple] = None,
) -> None:
    """Fleet-router conservation ledger (DESIGN.md §14, §15).

    Two levels cross-check each other. The *logical* ledger counts each
    request once regardless of hedging; the *copies* ledger sums the
    per-engine counters, where a hedged request appears twice. The copies
    identity ``Σ arrived_f == (n_arrived − n_rejected) + n_hedges`` is
    the double-dispatch detector: a router that submits a request to two
    fleets without recording a hedge inflates the left side only.
    ``n_pending`` and ``per_fleet_parked`` are tracked/measured
    independently (not residuals), so every equation is a real check.
    The resilience terms (DESIGN.md §15) default to zero, keeping the
    fault-free ledger identical to the §14 form: rejected requests (shed
    or breaker-refused) never reach an engine, and a dead-lettered
    logical request is one whose *last* live copy exhausted retries.
    """
    if n_arrived != (n_completed + n_dropped + n_rejected
                     + n_dead_lettered + n_pending):
        _fail("fleet logical conservation violated: arrived != completed "
              "+ dropped + rejected + dead_lettered + pending",
              arrived=n_arrived, completed=n_completed, dropped=n_dropped,
              rejected=n_rejected, dead_lettered=n_dead_lettered,
              pending=n_pending)
    if sum(per_fleet_arrived) != (n_arrived - n_rejected) + n_hedges:
        _fail("fleet copies conservation violated: sum(per-fleet arrived) "
              "!= submitted logical arrivals + hedges (double dispatch?)",
              per_fleet_arrived=per_fleet_arrived, arrived=n_arrived,
              rejected=n_rejected, hedges=n_hedges)
    if sum(per_fleet_completed) != n_completed + n_hedge_cancelled:
        _fail("fleet completion ledger violated: sum(per-fleet completed) "
              "!= logical completed + hedge losers",
              per_fleet_completed=per_fleet_completed,
              completed=n_completed, hedge_cancelled=n_hedge_cancelled)
    if sum(per_fleet_dropped) != n_dropped + n_hedge_dropped:
        _fail("fleet drop ledger violated: sum(per-fleet dropped) != "
              "logical dropped + hedge-copy drops",
              per_fleet_dropped=per_fleet_dropped, dropped=n_dropped,
              hedge_dropped=n_hedge_dropped)
    if per_fleet_dead_lettered is None:
        per_fleet_dead_lettered = (0,) * len(per_fleet_arrived)
    if sum(per_fleet_dead_lettered) != n_dead_lettered + n_hedge_dead_lettered:
        _fail("fleet dead-letter ledger violated: sum(per-fleet "
              "dead-lettered) != logical dead-lettered + hedge-copy "
              "dead letters",
              per_fleet_dead_lettered=per_fleet_dead_lettered,
              dead_lettered=n_dead_lettered,
              hedge_dead_lettered=n_hedge_dead_lettered)
    for i, (a, c, d, dl, p) in enumerate(zip(
            per_fleet_arrived, per_fleet_completed, per_fleet_dropped,
            per_fleet_dead_lettered, per_fleet_parked)):
        if a != c + d + dl + p:
            _fail("per-fleet conservation violated: arrived != completed "
                  "+ dropped + dead_lettered + parked", fleet=i, arrived=a,
                  completed=c, dropped=d, dead_lettered=dl, parked=p)


def check_finite(summary: dict, *, where: str = "") -> None:
    """NaN/inf guard on a vectorized-sim summary dict of arrays."""
    import numpy as np  # deferred: keep this module stdlib-importable

    for key, value in summary.items():
        arr = np.asarray(value)
        if arr.dtype.kind != "f":
            continue
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            _fail("non-finite values in vectorized summary", where=where,
                  key=key, n_bad=n_bad, shape=arr.shape)


def check_open_summary(summary: dict, n_steps: int, *,
                       where: str = "") -> None:
    """Vectorized open-loop conservation per (arm, stream): every offered
    request completed, dropped, or sits parked at the horizon."""
    import numpy as np

    check_finite(summary, where=where)
    need = ("n_completed", "n_dropped", "n_parked_end")
    if not all(k in summary for k in need):
        return
    total = (np.asarray(summary["n_completed"])
             + np.asarray(summary["n_dropped"])
             + np.asarray(summary["n_parked_end"]))
    if not np.allclose(total, float(n_steps)):
        bad = np.argwhere(~np.isclose(total, float(n_steps)))
        _fail("vectorized open-loop conservation violated: completed + "
              "dropped + parked != n per stream", where=where,
              n_steps=n_steps, first_bad_index=bad[:1].tolist(),
              value=float(np.asarray(total).flat[0]))


__all__ = [
    "ENV_VAR",
    "SanitizerError",
    "attach_engine",
    "attach_pool",
    "check_engine_conservation",
    "check_fault_ledger",
    "check_finite",
    "check_fleet_conservation",
    "check_open_loop",
    "check_open_summary",
    "check_pool",
    "check_telemetry_readonly",
    "enabled",
]
