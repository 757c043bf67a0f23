"""Vectorized Monte-Carlo fast path for the single-stage Minos model
(DESIGN.md §11), as batched torch tensors over arms × seeds.

The port of ``repro.sim.vectorized``. The paper's *single-stage* loop —
cold start → probe → elysium gate → requeue-with-penalty → warm reuse with
AR(1) contention drift and diurnal speed, Fig-3 billing — runs as one loop
over invocation steps in which every tensor carries one flat lane axis,
``L = n_arms × n_seeds``, arm-major, so results reshape to
``(n_arms, n_seeds, …)``. The reference ``vmap``s a scalar chain over the
lanes; here every per-lane scalar of the carry is an ``(L,)`` tensor, arm
parameters are repeated per seed, and the slot pool is ``(L, K)`` tensors
in the single- and the multi-stream step alike. Model scope, step
semantics and the estimator pipeline are the reference's: see that
module's docstring and the step docstrings below.

Draws are an input of the chain. A public call makes each lane's draws
(the reference's layout: ``3 + 5·ma`` normals and one exponential a step
closed-loop, ``8·(D+1)`` normals and ``D+1`` exponentials a step open-loop)
with a ``torch.Generator`` on the lane's device, seeded from a 64-bit mix
of (seed, arm index) (:func:`_lane_key`): a lane's draws, and so its
result, depend only on (seed, arm), never on the batch it runs in, as
``fold_in(PRNGKey(seed), arm)`` makes the reference's. A per-lane
generator is torch's own vetted stream (Philox on the card, mt19937 on the
CPU) at the price of one small launch a lane, well under the step loop's
time; a counter-based hash in torch ops would need a hand-written RNG.
The CPU generator keeps the key's low 32 bits only. The two devices'
generators differ, so the card and the CPU agree only on shared draws
(``draw_device`` of :func:`_simulate_arms`). The private
run-on-given-draws seam (``draws=``) lets the tests hand in the
reference's exact draws.

On the card the step loop is the compiled surface, the counterpart of
``jax.jit``: a CUDA graph of ``_CHUNK`` steps (and one of the remainder)
is captured once per ``(config, batch shape)`` and replayed
``n_steps // _CHUNK`` times, the step index held in a device tensor that
selects the step's draws and the row the step writes. The graph's
parameters, carry, draws and request rows live in static buffers that each
call fills before the replay. A failed capture raises; nothing falls back
to eager execution on the card. On the CPU the same steps run eagerly.

Everything is float32 (counters int32 where the reference's are);
latencies are accumulated as durations, never as differences of large
absolute times. No step syncs the host: branches on the configuration are
Python flags, branches on data are ``torch.where`` selects.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..analysis import sanitizer as _sanitizer
from ..core.cost import Pricing
from ..core.estimators import (
    WelfordState,
    p2_init,
    p2_update,
    p2_value,
    welford_init,
    welford_merge,
    welford_std,
    welford_update,
    welford_update_masked,
)

F32 = torch.float32
I32 = torch.int32

GATE_OFF = 0        # baseline arm: every instance accepted unjudged
GATE_FIXED = 1      # pre-tested elysium threshold (paper §III-A)
GATE_ADAPTIVE = 2   # §IV online threshold: P² quantile + EMA republish

ORDER_CODES = {"lifo": 0, "fifo": 1, "spread": 2}

#: steps per captured graph on the card: a whole-scan graph takes about ten
#: times as long to capture and replays no faster (PERF.md §6)
_CHUNK = 50


class ArmParams(NamedTuple):
    """One parameter arm — every leaf a scalar (stack arms along axis 0 with
    :func:`stack_arms` for a grid)."""

    # variation model
    sigma: Any
    day_factor: Any
    diurnal_amplitude: Any
    diurnal_phase_h: Any
    # function spec (unit-speed durations + noise scales)
    prepare_ms: Any
    prepare_jitter: Any
    body_ms: Any
    body_jitter: Any
    benchmark_ms: Any
    benchmark_noise: Any
    contention_rho: Any
    # hosting knobs
    cold_start_ms: Any
    cold_start_jitter: Any
    idle_timeout_ms: Any
    recycle_lifetime_ms: Any   # inf = never recycled
    bill_cold_start: Any       # 0.0 / 1.0
    requeue_overhead_ms: Any
    requeue_penalty_ms: Any    # backend migration penalty (sim backend: 0)
    order: Any                 # 0 lifo / 1 fifo / 2 spread (int32)
    # gate
    gate_mode: Any             # GATE_OFF / GATE_FIXED / GATE_ADAPTIVE (int32)
    threshold: Any             # fixed elysium threshold (GATE_FIXED)
    pass_fraction: Any         # adaptive quantile (GATE_ADAPTIVE)
    max_retries: Any           # emergency-exit bound (int32)
    warmup_reports: Any        # adaptive warm-up (int32)
    republish_every: Any       # adaptive EMA republish cadence (int32)
    smoothing_alpha: Any       # adaptive EMA smoothing
    # workload + pricing
    think_time_ms: Any
    cost_per_invocation: Any
    cost_per_ms: Any
    # load-aware slots (defaults reproduce the single-stream model)
    concurrency: Any = 1           # per-slot request capacity (int32)
    load_slowdown_alpha: Any = 0.0  # body pays load**alpha when load > 1
    gate_load_aware: Any = 0.0     # 1.0: judge probes at live mean load
    # open-loop loss/admission (inf = knob disabled)
    queue_capacity: Any = math.inf  # arrivals finding >= this many waiting drop
    admit_bound: Any = math.inf    # defer while in_service + waiting >= bound


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static shape of one vectorized run (what a captured graph depends on)."""

    n_steps: int
    # One slot is exact for the single-stream model: a cold start only
    # happens when NO pooled instance is valid (so every slot is dead and
    # placement reuses slot 0), and a warm serve rewrites its own slot.
    # Multi-stream runs need pool_size >= n_streams (enforced by
    # simulate_arms): a load-0 slot, necessarily dead, always exists for a
    # cold placement.
    pool_size: int = 1
    max_attempts: int = 6      # must exceed every arm's max_retries
    collect_requests: bool = False
    adaptive: bool = True      # False: no arm uses GATE_ADAPTIVE — skip P²
    diurnal: bool = True       # False: every arm has amplitude 0 — skip cos
    # Closed-loop virtual users sharing the slot pool (event engine's
    # n_vus). 1 keeps the single-stream step; >1 switches to the
    # slot-occupancy step.
    n_streams: int = 1


class _ColdResult(NamedTuple):
    """Outcome of the cold retry chain for one step, ``(L,)`` per field."""

    elapsed: Any      # ms burned by failed attempts (cold+probe+requeue)
    retries: Any      # failed attempts (i32)
    log_speed: Any    # accepted instance's hidden speed (log)
    cold_ms: Any      # accepted attempt's cold-start duration
    ready_ms: Any     # max(prepare, probe) — body start offset
    analysis_ms: Any  # accepted attempt's body duration
    place_rel: Any    # accepted instance's placement time (rel. to step start)
    n_term: Any
    d_term: Any
    probe_w: WelfordState      # probe durations
    log_probe_w: WelfordState  # log probe durations (lognormal fit)
    p2: Any                    # P2State | None
    ema: Any
    ema_init: Any
    since_publish: Any
    n_probes: Any


class _Pool(NamedTuple):
    """Fixed-capacity warm pool: ``(L, K)`` tensors. Slot selection is an
    ``argmax``/``argmin`` over K (first index on ties, the reference's
    strict-``>`` tournament and its ``argmin`` alike) and updates are
    one-hot selects."""

    log_speed: Any     # log-space: AR(1) drift needs no log/exp
    last_used: Any
    recycle: Any       # absolute deadline (inf = never)
    alive: Any
    # Multi-stream only (None prunes it): the time a cold-placed slot
    # finishes its first serve — until then it is mid-cold-start and not
    # reusable (the event pool's admit_cold instance).
    avail_from: Any = None
    # Multi-stream only: the time the slot last ENTERED the event pool's
    # available list, the heap key's ``_avail_seq`` as a timestamp. It is
    # frozen while the slot hovers below capacity, so load ties break by a
    # near-static priority order; that staleness is what lets the pool
    # shrink at the event engine's rate (see the reference's note).
    avail_seq: Any = None
    # Multi-stream only: the take time that filled the slot to capacity
    # (inf = in the available list); the first completion after it
    # re-enters the slot with a fresh avail_seq.
    filled_at: Any = None


class _Streams(NamedTuple):
    """Closed-loop virtual users (n_streams > 1): ``(L, S)`` tensors.
    Per-slot occupancy is derived each step from these completion horizons,
    never carried as a counter (see the reference's note)."""

    next_ready: Any  # when the stream next dispatches (submit or retry)
    ended: Any       # the stream's in-flight horizon on its slot
    slot: Any        # pool slot that served it (int32; -1 = none yet)
    req_start: Any   # current request's first dispatch time (latency anchor)
    retries: Any     # failed attempts of the current request (i32)
    pend_bill: Any   # billed ms of those failed attempts (request row total)


class VecState(NamedTuple):
    t: Any                       # absolute sim time (ms)
    pool: _Pool
    probe_w: WelfordState        # cold probe durations
    log_probe_w: WelfordState    # log of the same (lognormal fit)
    body_w: WelfordState         # observed body durations
    latency_w: WelfordState      # request latencies
    reuse_w: WelfordState        # 1.0 warm-served / 0.0 cold-served
    p2: Any                      # P2State | None (pruned when not adaptive)
    ema: Any
    ema_init: Any
    since_publish: Any
    n_probes: Any
    n_started: Any
    n_terminated: Any
    nb_term: Any                 # Fig-3 billing terms, six per lane
    nb_pass: Any
    nb_reuse: Any
    db_term: Any
    db_pass: Any
    db_reuse: Any
    streams: Any = None          # _Streams when n_streams > 1, else pruned


# ---------------------------------------------------------------------------
# Tensor-tree helpers (NamedTuples, tuples, dicts, None and tensors)
# ---------------------------------------------------------------------------


def _tree_map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"not a tensor tree: {type(tree)}")


def _tree_copy(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` (skipping a
    leaf that already is the destination)."""
    def cp(d, s):
        if s is not d:
            d.copy_(s)
        return d
    _tree_map(cp, dst, src)


def _wsel(mask, new, old):
    """Per-lane select of two trees: ``mask`` is ``(L,)``, leaves may carry
    trailing axes (P²'s five markers)."""
    def sel(a, b):
        m = mask.view(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return _tree_map(sel, new, old)


def _col(x):
    return x.unsqueeze(-1)


def _take(a, idx):
    """``a[lane, idx[lane]]`` for ``a`` of shape ``(L, K)``."""
    return torch.gather(a, 1, idx.long().unsqueeze(1)).squeeze(1)


def _take_rows(a, idx):
    """``a[lane, idx[lane, j]]`` for ``a`` (L, K) and ``idx`` (L, S)."""
    return torch.gather(a, 1, idx.long())


def _first_true(mask):
    """Index of the first true entry along the last axis (0 when none);
    ``argmax`` refuses bool inputs, so cast first."""
    return mask.to(I32).argmax(dim=-1)


def _onehot(idx, n):
    return torch.arange(n, device=idx.device) == idx.unsqueeze(-1)


def _count(mask, dim=-1):
    """int32 count of a bool mask (``jnp.sum`` of int32 is int32)."""
    return mask.to(I32).sum(dim, dtype=I32)


# ---------------------------------------------------------------------------
# Closed-loop steps
# ---------------------------------------------------------------------------


def _diurnal(t_ms, amplitude, phase_h):
    hour = torch.remainder(t_ms / 3.6e6, 24.0)
    return 1.0 + amplitude * torch.cos(2.0 * math.pi * (hour - phase_h) / 24.0)


def _day(params, cfg, consts, t):
    """(day_mean, log_day) at absolute time ``t``."""
    if cfg.diurnal:
        dv = _diurnal(t, params.diurnal_amplitude, params.diurnal_phase_h)
        return params.day_factor * dv, consts["log_df"] + torch.log(dv)
    return params.day_factor, consts["log_df"]


def _attempt_values(params: ArmParams, consts, su, J, day_mean, log_day, i):
    """Attempt ``i``'s sampled quantities from the pre-scaled draw row.

    Draw layout per attempt (base b=3+5i): z0 instance speed, z1 cold
    start, z2 prepare, z3 probe observation noise, z4 body. ``J=exp(su)``
    was computed in one vectorized exp, so everything here is
    multiply/add."""
    b = 3 + 5 * i
    cold = params.cold_start_ms * J[:, b + 1]
    download = params.prepare_ms * J[:, b + 2]
    inv_speed_rel = J[:, b + 3] / J[:, b]
    bench = (params.benchmark_ms / day_mean) * inv_speed_rel
    log_bench = consts["log_bench_ms"] + su[:, b + 3] - su[:, b] - log_day
    analysis = (params.body_ms / day_mean) * (J[:, b + 4] / J[:, b])
    log_speed = su[:, b] + log_day
    return cold, download, bench, log_bench, analysis, log_speed


def _cold_chain_fixed(params, cfg, consts, su, J, day_mean, log_day,
                      served_cold, state) -> _ColdResult:
    """The retry chain for attempt-invariant gates (off / fixed
    threshold): an unrolled chain of per-lane selects — no P², no
    sequential estimator feedback — the grid sweep's hot path. (The
    reference's ``judge_mult`` argument is left out: only the multi-stream
    step judges at load, and it judges through :func:`_judge_one`.)"""
    z = torch.zeros_like(state.t)
    pending = served_cold
    thr = torch.where(params.gate_mode == GATE_FIXED, params.threshold, torch.inf)
    elapsed = z
    retries = torch.zeros_like(state.n_probes)
    n_term = d_term = cb = s_b = s_b2 = s_lb = s_lb2 = z
    acc_cold = acc_ready = acc_body = acc_logsp = acc_place = z
    for i in range(cfg.max_attempts):
        cold, download, bench, log_bench, analysis, log_speed = \
            _attempt_values(params, consts, su, J, day_mean, log_day, i)
        probed = (params.gate_mode > 0) & (i < params.max_retries)
        passes = (~probed) | (bench <= thr)
        feed = (pending & probed).to(F32)
        accept = pending & passes
        fail_b = pending & ~passes
        fail = fail_b.to(F32)
        # batched Welford moments of this step's probe stream (merged
        # below via Chan — exact up to FP association order)
        cb = cb + feed
        s_b = s_b + feed * bench
        s_b2 = s_b2 + feed * bench * bench
        s_lb = s_lb + feed * log_bench
        s_lb2 = s_lb2 + feed * log_bench * log_bench
        ready = torch.where(probed, torch.maximum(download, bench), download)
        acc_cold = torch.where(accept, cold, acc_cold)
        acc_ready = torch.where(accept, ready, acc_ready)
        acc_body = torch.where(accept, analysis, acc_body)
        acc_logsp = torch.where(accept, log_speed, acc_logsp)
        acc_place = torch.where(accept, elapsed, acc_place)
        n_term = n_term + fail
        d_term = d_term + fail * (params.bill_cold_start * cold + bench)
        elapsed = elapsed + fail * (cold + bench + params.requeue_overhead_ms
                                    + params.requeue_penalty_ms)
        retries = retries + fail_b.to(I32)
        pending = fail_b

    def merged(w: WelfordState, s, s2) -> WelfordState:
        mean_b = s / torch.clamp(cb, min=1.0)
        m2_b = torch.clamp(s2 - cb * mean_b * mean_b, min=0.0)
        return welford_merge(w, WelfordState(count=cb, mean=mean_b, m2=m2_b))

    return _ColdResult(
        elapsed=elapsed, retries=retries, log_speed=acc_logsp,
        cold_ms=acc_cold, ready_ms=acc_ready, analysis_ms=acc_body,
        place_rel=acc_place, n_term=n_term, d_term=d_term,
        probe_w=merged(state.probe_w, s_b, s_b2),
        log_probe_w=merged(state.log_probe_w, s_lb, s_lb2),
        p2=state.p2, ema=state.ema, ema_init=state.ema_init,
        since_publish=state.since_publish,
        n_probes=state.n_probes + cb.to(I32),
    )


def _adaptive(params, p2, ema, ema_init, since, n_probes, bench, probed):
    """The §IV threshold's P² + EMA republish pipeline after one probe
    (lanes where ``probed`` is false keep their state). ``n_probes`` already
    counts this probe. Returns the new (p2, ema, ema_init, since) and the
    threshold that judges it, by gate mode."""
    p2 = _wsel(probed, p2_update(p2, bench), p2)
    since = since + probed.to(I32)
    publish = probed & (since >= params.republish_every)
    p2v = p2_value(p2)
    ema = torch.where(
        publish,
        torch.where(ema_init,
                    params.smoothing_alpha * p2v
                    + (1.0 - params.smoothing_alpha) * ema,
                    p2v),
        ema)
    ema_init = ema_init | publish
    since = torch.where(publish, 0, since)
    thr_adaptive = torch.where(
        n_probes >= params.warmup_reports,
        torch.where(ema_init, ema, p2v), torch.inf)
    thr = torch.where(params.gate_mode == GATE_FIXED, params.threshold,
                      torch.where(params.gate_mode == GATE_ADAPTIVE,
                                  thr_adaptive, torch.inf))
    return (p2, ema, ema_init, since), thr


def _cold_chain_adaptive(params, cfg, consts, su, J, day_mean, log_day,
                         served_cold, state) -> _ColdResult:
    """The retry chain when the §IV adaptive threshold is live: every
    probed attempt reports to the P² quantile + EMA republish BEFORE being
    judged, so attempts are sequential within the step."""
    z = torch.zeros_like(state.t)
    c = _ColdResult(
        elapsed=z, retries=torch.zeros_like(state.n_probes), log_speed=z,
        cold_ms=z, ready_ms=z, analysis_ms=z, place_rel=z,
        n_term=z, d_term=z,
        probe_w=state.probe_w, log_probe_w=state.log_probe_w,
        p2=state.p2, ema=state.ema, ema_init=state.ema_init,
        since_publish=state.since_publish, n_probes=state.n_probes,
    )
    pending = served_cold
    for i in range(cfg.max_attempts):
        cold, download, bench, log_bench, analysis, log_speed = \
            _attempt_values(params, consts, su, J, day_mean, log_day, i)
        probed = (params.gate_mode > 0) & (i < params.max_retries)
        feed = pending & probed
        probe_w = welford_update_masked(c.probe_w, bench, feed)
        log_probe_w = welford_update_masked(c.log_probe_w, log_bench, feed)
        n_probes = c.n_probes + feed.to(I32)
        (p2, ema, ema_init, since), thr = _adaptive(
            params, c.p2, c.ema, c.ema_init, c.since_publish, n_probes, bench, feed)
        passes = (~probed) | (bench <= thr)
        accept = pending & passes
        fail = pending & ~passes
        failf = fail.to(F32)
        ready = torch.where(probed, torch.maximum(download, bench), download)
        c = _ColdResult(
            elapsed=c.elapsed + failf * (cold + bench
                                         + params.requeue_overhead_ms
                                         + params.requeue_penalty_ms),
            retries=c.retries + fail.to(I32),
            log_speed=torch.where(accept, log_speed, c.log_speed),
            cold_ms=torch.where(accept, cold, c.cold_ms),
            ready_ms=torch.where(accept, ready, c.ready_ms),
            analysis_ms=torch.where(accept, analysis, c.analysis_ms),
            place_rel=torch.where(accept, c.elapsed, c.place_rel),
            n_term=c.n_term + failf,
            d_term=c.d_term + failf * (params.bill_cold_start * cold + bench),
            probe_w=probe_w, log_probe_w=log_probe_w,
            p2=p2, ema=ema, ema_init=ema_init, since_publish=since,
            n_probes=n_probes,
        )
        pending = fail
    return c


def _warm_drift(params, log_i, log_day, su):
    """AR(1) drift of a warm instance's log speed (pure log-space)."""
    rho = params.contention_rho
    return torch.where(
        rho >= 1.0, log_i,
        log_day + rho * (log_i - log_day)
        + torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * su[:, 0])


def _recycle_at(params, t, ex):
    """Recycle deadline of an instance placed at ``t``. An inf lifetime
    stays inf even when the exponential draw is exactly 0.0 (0·inf = NaN
    would kill the slot)."""
    lt = params.recycle_lifetime_ms
    return t + torch.where(torch.isinf(lt), torch.inf, ex * lt)


def _step(params: ArmParams, cfg: SimConfig, consts: dict,
          state: VecState, draws):
    """One invocation step of the single-stream closed loop."""
    u, ex = draws
    # one vectorized exp covers every lognormal factor of the step
    # (scale<=0 gives exactly exp(0)=1, preserving sample_jitter's
    # disabled-noise contract)
    su = u * consts["scale_vec"]
    J = torch.exp(su)
    t0 = state.t
    day_mean, log_day = _day(params, cfg, consts, t0)

    # ---- warm take: validity + reuse-order tournament -------------------
    pool = state.pool
    valid = pool.alive & ((_col(t0) - pool.last_used) <= _col(params.idle_timeout_ms)) \
        & (_col(t0) < pool.recycle)
    any_warm = valid.any(dim=1)
    served_cold = ~any_warm
    # lifo takes the most recently used valid slot, fifo/spread the
    # oldest — maximize a signed score; argmax keeps the first index on
    # ties (the reference's strict '>' tournament), and slot 0 when no slot
    # is valid (a cold start then places into slot 0)
    sign = torch.where(params.order == 0, 1.0, -1.0)
    score = torch.where(valid, _col(sign) * pool.last_used, -torch.inf)
    k_sel = score.argmax(dim=1)
    log_i = _take(pool.log_speed, k_sel)
    rc_i = _take(pool.recycle, k_sel)

    # ---- warm path: AR(1) drift ----------------------------------------
    log_drifted = _warm_drift(params, log_i, log_day, su)
    download_w = params.prepare_ms * J[:, 1]
    analysis_w = params.body_ms * J[:, 2] * torch.exp(-log_drifted)
    dur_w = download_w + analysis_w

    # ---- cold path -----------------------------------------------------
    chain = _cold_chain_adaptive if cfg.adaptive else _cold_chain_fixed
    c = chain(params, cfg, consts, su, J, day_mean, log_day, served_cold, state)

    # ---- merge warm/cold outcomes --------------------------------------
    analysis = torch.where(served_cold, c.analysis_ms, analysis_w)
    latency = torch.where(
        served_cold, c.elapsed + c.cold_ms + c.ready_ms + c.analysis_ms, dur_w)
    billed_final = torch.where(
        served_cold,
        params.bill_cold_start * c.cold_ms + c.ready_ms + c.analysis_ms,
        dur_w)
    t_end = t0 + latency
    log_speed_served = torch.where(served_cold, c.log_speed, log_drifted)

    # ---- pool update: the served slot (slot 0 on a cold start) ----------
    recycle_upd = torch.where(served_cold,
                              _recycle_at(params, t0 + c.place_rel, ex), rc_i)
    upd = _onehot(k_sel, cfg.pool_size)
    new_pool = _Pool(
        log_speed=torch.where(upd, _col(log_speed_served), pool.log_speed),
        last_used=torch.where(upd, _col(t_end), pool.last_used),
        recycle=torch.where(upd, _col(recycle_upd), pool.recycle),
        alive=valid | upd,
    )

    # ---- Fig-3 billing + telemetry estimators --------------------------
    coldf = served_cold.to(F32)
    warmf = any_warm.to(F32)
    new_state = VecState(
        t=t_end + params.think_time_ms,
        pool=new_pool,
        probe_w=c.probe_w, log_probe_w=c.log_probe_w,
        body_w=welford_update(state.body_w, analysis),
        latency_w=welford_update(state.latency_w, latency),
        reuse_w=welford_update(state.reuse_w, warmf),
        p2=c.p2, ema=c.ema, ema_init=c.ema_init,
        since_publish=c.since_publish, n_probes=c.n_probes,
        n_started=state.n_started + coldf * (c.retries.to(F32) + 1.0),
        n_terminated=state.n_terminated + c.n_term,
        nb_term=state.nb_term + c.n_term,
        nb_pass=state.nb_pass + coldf,
        nb_reuse=state.nb_reuse + warmf,
        db_term=state.db_term + c.d_term,
        db_pass=state.db_pass + coldf * billed_final,
        db_reuse=state.db_reuse + warmf * billed_final,
    )
    if not cfg.collect_requests:
        return new_state, None
    return new_state, {
        "latency_ms": latency,
        "analysis_ms": analysis,
        "billed_ms": coldf * c.d_term + billed_final,
        "served_by_cold": served_cold,
        "retries": torch.where(served_cold, c.retries, 0),
        "instance_speed": torch.exp(log_speed_served),
    }


def _judge_one(params, cfg, est, bench, log_bench, probed):
    """One gate judgment in the retry-as-step models: feed the raw probe
    observation to the estimator stack (Welford moments, plus the P²/EMA
    republish pipeline when ``cfg.adaptive``), then return the active
    threshold. ``est`` is the 7-tuple ``(probe_w, log_probe_w, n_probes,
    p2, ema, ema_init, since_publish)``; the updated tuple is returned
    alongside ``thr``."""
    probe_w, log_probe_w, n_probes, p2, ema, ema_init, since = est
    probe_w = welford_update_masked(probe_w, bench, probed)
    log_probe_w = welford_update_masked(log_probe_w, log_bench, probed)
    n_probes = n_probes + probed.to(I32)
    if cfg.adaptive:
        (p2, ema, ema_init, since), thr = _adaptive(
            params, p2, ema, ema_init, since, n_probes, bench, probed)
    else:
        thr = torch.where(params.gate_mode == GATE_FIXED, params.threshold,
                          torch.inf)
    return (probe_w, log_probe_w, n_probes, p2, ema, ema_init, since), thr


def _step_multi(params: ArmParams, cfg: SimConfig, consts: dict,
                state: VecState, draws):
    """One dispatch attempt of the ``n_streams > 1`` closed-loop model.

    The step fires the stream with the earliest ``next_ready`` (ties →
    lowest index, the event loop's FIFO order), so step times never run
    backwards. Pool slots carry live in-flight occupancy derived from the
    streams' horizons: warm selection masks full slots, ``spread`` picks
    the least loaded, warm bodies pay ``(load+1)**alpha``, and
    ``gate_load_aware`` arms judge each cold attempt at the pool's live
    mean occupancy. A cold TERMINATE re-fires the stream at the requeue
    time (retry-as-step): one step is one ATTEMPT, and a step whose probe
    fails completes no request. Occupancy and re-entry folds are one-hot
    reductions over ``(L, S, K)``, so no scatter (and no atomic) runs."""
    K = cfg.pool_size
    S = cfg.n_streams
    u, ex = draws
    su = u * consts["scale_vec"]
    J = torch.exp(su)

    st = state.streams
    # ---- which stream fires (argmin keeps the lowest index on ties) ----
    s_star = st.next_ready.argmin(dim=1)
    t0 = _take(st.next_ready, s_star)
    day_mean, log_day = _day(params, cfg, consts, t0)

    # ---- per-slot live occupancy, exact at t0 --------------------------
    pool = state.pool
    t0c = _col(t0)
    on_slot = st.slot.unsqueeze(2) == torch.arange(K, device=t0.device)  # (L, S, K)
    in_flight = (st.slot >= 0) & (st.ended > t0c)
    load = _count(on_slot & in_flight.unsqueeze(2), dim=1)
    # fold available-list re-entries (see the reference): a slot taken to
    # capacity left the list; the first completion after that re-admits
    # it with a fresh position seq
    vis = (st.slot >= 0) & (st.ended <= t0c)
    rejoin_ok = vis & (st.ended > _take_rows(pool.filled_at, torch.clamp(st.slot, min=0)))
    rejoin = torch.where(on_slot & rejoin_ok.unsqueeze(2), st.ended.unsqueeze(2),
                         torch.inf).amin(dim=1)
    rejoined = torch.isfinite(pool.filled_at) & torch.isfinite(rejoin)
    avail_seq = torch.where(rejoined, rejoin, pool.avail_seq)
    filled_at = torch.where(rejoined, torch.inf, pool.filled_at)

    # ---- warm validity -------------------------------------------------
    idle_ok = ((t0c - pool.last_used) <= _col(params.idle_timeout_ms)) \
        & (t0c < pool.recycle)
    valid = pool.alive & (pool.avail_from <= t0c) \
        & (load < _col(params.concurrency)) & ((load > 0) | idle_ok)
    any_warm = valid.any(dim=1)
    served_cold = ~any_warm

    # ---- reuse-order tournament (lifo / fifo / spread) -----------------
    order = _col(params.order)
    time_key = torch.where(order == 0, -avail_seq, avail_seq)
    min_load = torch.where(valid, load, 2**31 - 1).amin(dim=1)
    spread_cand = valid & (load == _col(min_load))
    key = torch.where(order == 2,
                      torch.where(spread_cand, avail_seq, torch.inf),
                      torch.where(valid, time_key, torch.inf))
    k_warm = key.argmin(dim=1)
    log_i = _take(pool.log_speed, k_warm)
    rc_i = _take(pool.recycle, k_warm)
    load_sel = _take(load, k_warm)

    # ---- cold placement: first dead slot -------------------------------
    dead = ~pool.alive | ((load == 0) & ~idle_ok)
    k_cold = _first_true(dead)
    k_upd = torch.where(served_cold, k_cold, k_warm)
    upd = _onehot(k_upd, K)

    # ---- warm path: AR(1) drift + load**alpha self-contention ----------
    log_drifted = _warm_drift(params, log_i, log_day, su)
    alpha = params.load_slowdown_alpha
    eff_load = (load_sel + 1).to(F32)  # incl. this request
    lmult = torch.where((alpha > 0.0) & (eff_load > 1.0),
                        torch.pow(eff_load, alpha), 1.0)
    download_w = params.prepare_ms * J[:, 1]
    analysis_w = params.body_ms * J[:, 2] * torch.exp(-log_drifted) * lmult
    dur_w = download_w + analysis_w

    # ---- load-aware gate factor (pool mean occupancy at dispatch) ------
    live = pool.alive & ((load > 0) | idle_ok)
    total_if = load.sum(dim=1, dtype=I32)
    n_live = _count(live)
    mean_load = torch.clamp((total_if + 1).to(F32) / (n_live + 1).to(F32), min=1.0)
    judge_mult = torch.where((params.gate_load_aware > 0.5) & (alpha > 0.0),
                             torch.pow(mean_load, alpha), 1.0)

    # ---- cold path: ONE probe attempt per step (retry-as-step) ---------
    cold_ms, download_c, bench, log_bench, analysis_c, log_speed_c = \
        _attempt_values(params, consts, su, J, day_mean, log_day, 0)
    r_cur = _take(st.retries, s_star)
    req_start = torch.where(r_cur > 0, _take(st.req_start, s_star), t0)
    probed = served_cold & (params.gate_mode > 0) & (r_cur < params.max_retries)
    est = (state.probe_w, state.log_probe_w, state.n_probes, state.p2,
           state.ema, state.ema_init, state.since_publish)
    est, thr = _judge_one(params, cfg, est, bench, log_bench, probed)
    probe_w, log_probe_w, n_probes, p2, ema, ema_init, since = est
    # estimators see the raw observation; only the verdict inflates
    passes = (~probed) | (bench * judge_mult <= thr)
    completed = any_warm | passes
    cold_pass = served_cold & passes
    cold_passf = cold_pass.to(F32)
    failf = (served_cold & ~passes).to(F32)

    # ---- merge warm/cold outcomes --------------------------------------
    ready_c = torch.where(probed, torch.maximum(download_c, bench), download_c)
    analysis = torch.where(served_cold, analysis_c, analysis_w)
    t_end = t0 + torch.where(served_cold, cold_ms + ready_c + analysis_c, dur_w)
    probe_end = t0 + cold_ms + bench
    latency = t_end - req_start
    billed_final = torch.where(
        served_cold, params.bill_cold_start * cold_ms + ready_c + analysis_c,
        dur_w)
    bill_fail = params.bill_cold_start * cold_ms + bench
    log_speed_served = torch.where(served_cold, log_speed_c, log_drifted)

    # ---- pool update ---------------------------------------------------
    recycle_upd = torch.where(
        served_cold, torch.where(passes, _recycle_at(params, t0, ex), -torch.inf), rc_i)
    # lazy reclaim like the event pool's sweep: an idle slot past its
    # deadline dies, busy slots survive; a failed probe never enters the
    # pool (alive only rises on a completion)
    keep = pool.alive & ((load > 0) | idle_ok)
    upd_cold = upd & _col(served_cold)
    new_pool = _Pool(
        log_speed=torch.where(upd, _col(log_speed_served), pool.log_speed),
        last_used=torch.where(upd, _col(torch.where(completed, t_end, -torch.inf)),
                              pool.last_used),
        recycle=torch.where(upd, _col(recycle_upd), pool.recycle),
        alive=keep | (upd & _col(completed)),
        avail_from=torch.where(
            upd_cold, _col(torch.where(passes, t_end, torch.inf)), pool.avail_from),
        # a cold-placed slot enters the available list at its first
        # release; a warm take that fills the slot to capacity leaves it
        avail_seq=torch.where(upd_cold, _col(t_end), avail_seq),
        filled_at=torch.where(
            upd,
            _col(torch.where(~served_cold & (load_sel + 1 >= params.concurrency),
                             t0, torch.inf)),
            filled_at),
    )

    # a stream whose probe failed holds no slot while it waits to requeue
    chosen_idx = torch.where(completed, k_upd.to(I32), -1)
    s_oh = _onehot(s_star, S)
    pend_bill = _take(st.pend_bill, s_star)
    requeue_at = probe_end + params.requeue_overhead_ms + params.requeue_penalty_ms
    new_streams = _Streams(
        next_ready=torch.where(
            s_oh, _col(torch.where(completed, t_end + params.think_time_ms, requeue_at)),
            st.next_ready),
        ended=torch.where(s_oh, _col(torch.where(completed, t_end, probe_end)), st.ended),
        slot=torch.where(s_oh, _col(chosen_idx), st.slot),
        req_start=torch.where(s_oh, _col(req_start), st.req_start),
        retries=torch.where(s_oh, _col(torch.where(completed, 0, r_cur + 1)), st.retries),
        pend_bill=torch.where(
            s_oh, _col(torch.where(completed, 0.0, pend_bill + bill_fail)), st.pend_bill),
    )

    # ---- Fig-3 billing + telemetry estimators --------------------------
    coldf = served_cold.to(F32)
    warmf = any_warm.to(F32)
    new_state = VecState(
        t=torch.maximum(state.t, torch.where(completed, t_end, probe_end)),
        pool=new_pool,
        probe_w=probe_w, log_probe_w=log_probe_w,
        body_w=welford_update_masked(state.body_w, analysis, completed),
        latency_w=welford_update_masked(state.latency_w, latency, completed),
        reuse_w=welford_update_masked(state.reuse_w, warmf, completed),
        p2=p2, ema=ema, ema_init=ema_init,
        since_publish=since, n_probes=n_probes,
        n_started=state.n_started + coldf,
        n_terminated=state.n_terminated + failf,
        nb_term=state.nb_term + failf,
        nb_pass=state.nb_pass + cold_passf,
        nb_reuse=state.nb_reuse + warmf,
        db_term=state.db_term + failf * bill_fail,
        db_pass=state.db_pass + cold_passf * billed_final,
        db_reuse=state.db_reuse + warmf * billed_final,
        streams=new_streams,
    )
    if not cfg.collect_requests:
        return new_state, None
    return new_state, {
        "latency_ms": latency,
        "analysis_ms": analysis,
        "billed_ms": pend_bill + billed_final,
        "served_by_cold": served_cold,
        "retries": r_cur,
        "instance_speed": torch.exp(log_speed_served),
        # retry-as-step: rows with completed=False are attempt records
        "completed": completed,
        # slot-accounting stream for the O(n) replay property test
        "slot": chosen_idx,
        "stream": s_star.to(I32),
        "t_start_ms": t0,
        "t_end_ms": torch.where(completed, t_end, probe_end),
        # occupancy of the serving slot excluding this request
        "load_at_start": torch.where(served_cold, 0, load_sel),
    }


def _closed_consts(params: ArmParams, cfg: SimConfig) -> dict:
    # multi-stream steps run ONE cold attempt each (retry-as-step), so
    # they only consume attempt-0 draws
    ma = 1 if cfg.n_streams > 1 else cfg.max_attempts
    # Draw layout: u[0] warm drift, u[1] warm prepare, u[2] warm body;
    # attempt i at base 3+5i: z0 speed, z1 cold, z2 prepare, z3 probe
    # noise, z4 body — scale_vec turns the whole row into log-factors.
    pj, bj = params.prepare_jitter, params.body_jitter
    cj, bn, sg = params.cold_start_jitter, params.benchmark_noise, params.sigma
    return {
        "scale_vec": torch.stack([sg, pj, bj] + [sg, cj, pj, bn, bj] * ma, dim=1),
        "log_df": torch.log(params.day_factor),
        "log_bench_ms": torch.log(params.benchmark_ms),
    }


def _closed_init(params: ArmParams, cfg: SimConfig) -> VecState:
    L = params.sigma.shape[0]
    dev = params.sigma.device
    K, S = cfg.pool_size, cfg.n_streams
    multi = S > 1

    def full(shape, v, dtype=F32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    z = full((L,), 0.0)
    return VecState(
        t=z,
        pool=_Pool(
            log_speed=full((L, K), 0.0), last_used=full((L, K), 0.0),
            recycle=full((L, K), math.inf), alive=full((L, K), False, torch.bool),
            avail_from=full((L, K), 0.0) if multi else None,
            avail_seq=full((L, K), 0.0) if multi else None,
            filled_at=full((L, K), math.inf) if multi else None,
        ),
        # every stream submits at t=0; ties resolve in index order
        streams=_Streams(
            next_ready=full((L, S), 0.0), ended=full((L, S), 0.0),
            slot=full((L, S), -1, I32), req_start=full((L, S), 0.0),
            retries=full((L, S), 0, I32), pend_bill=full((L, S), 0.0),
        ) if multi else None,
        probe_w=welford_init((L,), device=dev), log_probe_w=welford_init((L,), device=dev),
        body_w=welford_init((L,), device=dev), latency_w=welford_init((L,), device=dev),
        reuse_w=welford_init((L,), device=dev),
        # None prunes the adaptive estimator from the carry when no arm
        # needs it
        p2=p2_init(params.pass_fraction) if cfg.adaptive else None,
        ema=z if cfg.adaptive else None,
        ema_init=full((L,), False, torch.bool) if cfg.adaptive else None,
        since_publish=full((L,), 0, I32) if cfg.adaptive else None,
        n_probes=full((L,), 0, I32),
        n_started=z, n_terminated=z,
        nb_term=z, nb_pass=z, nb_reuse=z,
        db_term=z, db_pass=z, db_reuse=z,
    )


def _cost(params, final):
    return params.cost_per_ms * (final.db_term + final.db_pass + final.db_reuse) \
        + params.cost_per_invocation * (final.nb_term + final.nb_pass + final.nb_reuse)


def _closed_summary(params: ArmParams, cfg: SimConfig, final: VecState) -> dict:
    n = torch.full_like(final.t, float(cfg.n_steps))
    n_probes = final.n_probes.to(F32)
    return {
        "n_requests": n,
        # retry-as-step (n_streams > 1): a step whose cold probe fails
        # completes no request, so completions = steps - terminations
        "n_completed": n - final.n_terminated if cfg.n_streams > 1 else n,
        "n_started": final.n_started,
        "n_terminated": final.n_terminated,
        "n_probes": n_probes,
        "reuse_rate": final.reuse_w.mean,
        "mean_analysis_ms": final.body_w.mean,
        "std_analysis_ms": welford_std(final.body_w),
        "mean_latency_ms": final.latency_w.mean,
        "probe_mean_ms": final.probe_w.mean,
        "probe_log_mean": final.log_probe_w.mean,
        "probe_log_std": welford_std(final.log_probe_w),
        "pass_rate": 1.0 - final.n_terminated / torch.clamp(n_probes, min=1.0),
        "bill_n": torch.stack([final.nb_term, final.nb_pass, final.nb_reuse], dim=-1),
        "bill_d": torch.stack([final.db_term, final.db_pass, final.db_reuse], dim=-1),
        "cost": _cost(params, final),
        "horizon_ms": final.t,
    }


# ---------------------------------------------------------------------------
# The step loop: eager, or captured as CUDA graphs
# ---------------------------------------------------------------------------


def _advance(step, fixed, state, xs, step_t, rows, n_steps):
    """Run one step: read the step's slice of every lane-major input at the
    device index ``step_t``, write the step's request rows there, and
    advance the index. Returns (state, rows); ``rows`` is allocated at the
    first step that emits one."""
    x = tuple(a.index_select(1, step_t).squeeze(1) for a in xs)
    state, out = step(fixed, state, x)
    if out is not None:
        if rows is None:
            rows = {k: v.new_empty((n_steps,) + tuple(v.shape)) for k, v in out.items()}
        for k, v in out.items():
            rows[k].index_copy_(0, step_t, v.unsqueeze(0))
    step_t.add_(1)
    return state, rows


class _EagerScan:
    """The step loop run op by op: the CPU path, and on the card the
    private eager path that the captured one is held against."""

    def __init__(self, step, n_steps: int):
        self.step, self.n_steps = step, n_steps

    def run(self, fixed, state, xs):
        step_t = torch.zeros(1, dtype=torch.long, device=xs[0].device)
        rows = None
        for _ in range(self.n_steps):
            state, rows = _advance(self.step, fixed, state, xs, step_t, rows, self.n_steps)
        return state, rows


class _GraphScan:
    """The step loop as CUDA graphs: one of ``chunk`` steps, replayed
    ``n_steps // chunk`` times, and one of the remainder. The parameters,
    carry, inputs and rows are static buffers that :meth:`run` fills before
    the replays; each graph reads its carry from the static buffers and
    writes the carry back after its last step, and the step index lives in
    a device tensor. Captured at construction; ``capture_ms`` is the wall
    time of the captures, ``graphs`` their number, ``plan`` the replays of
    a call."""

    def __init__(self, step, n_steps: int, fixed, state, xs):
        chunk = _CHUNK
        device = xs[0].device
        self.step, self.n_steps = step, n_steps
        self.fixed = _tree_map(torch.empty_like, fixed)
        self.state = _tree_map(torch.empty_like, state)
        self.xs = tuple(torch.empty_like(a) for a in xs)
        self.step_t = torch.zeros(1, dtype=torch.long, device=device)
        _tree_copy(self.fixed, fixed)
        _tree_copy(self.state, state)
        _tree_copy(self.xs, xs)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # one eager step on the capture stream learns the rows' shapes and
        # runs every op once before the capture; its result is dropped
        with torch.cuda.stream(stream):
            _, rows = _advance(step, self.fixed, self.state, self.xs,
                               self.step_t, None, n_steps)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.rows = rows
        self.pool = torch.cuda.graph_pool_handle()
        q, r = divmod(n_steps, chunk)
        sizes = ([chunk] if q else []) + ([r] if r else [])
        graphs = {}
        t0 = time.perf_counter()
        for k in sizes:
            graphs[k] = self._capture(k, stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.plan = [graphs[chunk]] * q + ([graphs[r]] if r else [])
        self.graphs = len(graphs)

    def _body(self, k: int) -> None:
        state = self.state
        for _ in range(k):
            state, _ = _advance(self.step, self.fixed, state, self.xs,
                                self.step_t, self.rows, self.n_steps)
        _tree_copy(self.state, state)

    def _capture(self, k: int, stream) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        # collect before the capture and hold the cycle collector off during
        # it, so that it cannot free earlier CUDA objects inside the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self._body(k)
        finally:
            if collecting:
                gc.enable()
        return graph

    def run(self, fixed, state, xs):
        _tree_copy(self.fixed, fixed)
        _tree_copy(self.state, state)
        _tree_copy(self.xs, xs)
        self.step_t.zero_()
        for g in self.plan:
            g.replay()
        return self.state, self.rows


# ---------------------------------------------------------------------------
# Open-loop (arrival-driven) steps — DESIGN.md §12
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpenSimConfig:
    """Static shape of one open-loop vectorized run.

    ``n_servers`` is the autoscaling supply cap (K server slots, each
    serving one request at a time). Each step runs the event dispatcher's
    admission pipeline: a static admission bound (``ArmParams.admit_bound``)
    defers arrivals, a finite ``ArmParams.queue_capacity`` drops them, and a
    failed cold probe releases its slot and parks the request until its
    requeue time (retry-as-park). ``queue_ring`` bounds how many requests
    can be parked at once; parking past the ring counts as a drop."""

    n_steps: int
    n_servers: int = 4
    queue_ring: int = 32
    drains_per_step: int = 3
    collect_requests: bool = False
    adaptive: bool = True
    diurnal: bool = True


class OpenState(NamedTuple):
    """Carry of the open-loop steps. Slot state is ``(L, K)``; the park
    ring and the dispatch-start log are ``(L, W)``, ``W = cfg.queue_ring``
    (see the reference for their meaning). The estimator tail matches the
    7-tuple :func:`_judge_one` threads."""

    t_arr: Any                   # previous arrival's absolute time
    busy: Any                    # (L, K) per-slot busy-until horizon
    log_speed: Any               # (L, K)
    last_used: Any               # (L, K) per-slot last completion time
    recycle: Any                 # (L, K) absolute recycle deadline
    alive: Any                   # (L, K)
    starts: Any                  # (L, W) dispatch-start log (queue depth)
    starts_idx: Any              # i32 circular cursor into ``starts``
    park_ready: Any              # (L, W) re-dispatch time, inf = empty
    park_start: Any              # (L, W) original arrival (latency anchor)
    park_retries: Any            # (L, W) i32 failed probes so far
    park_bill: Any               # (L, W) billed ms of those failed probes
    park_wait: Any               # (L, W) queue wait at FIRST dispatch
    probe_w: WelfordState
    log_probe_w: WelfordState
    body_w: WelfordState
    latency_w: WelfordState
    wait_w: WelfordState         # queue waits (the open-loop metric)
    reuse_w: WelfordState
    p2: Any
    ema: Any
    ema_init: Any
    since_publish: Any
    n_probes: Any
    n_started: Any
    n_terminated: Any
    n_completed: Any
    n_dropped: Any
    n_deferred: Any
    nb_term: Any
    nb_pass: Any
    nb_reuse: Any
    db_term: Any
    db_pass: Any
    db_reuse: Any


def _open_dispatch(params: ArmParams, cfg: OpenSimConfig, consts: dict,
                   slots, est, su, ex, t_req, rc_cur, active):
    """Place and serve ONE open-loop request dispatching at ``t_req``.

    ``slots`` is the ``(busy, log_speed, last_used, recycle, alive)`` tuple
    of ``(L, K)`` tensors; ``su`` one pre-scaled 8-draw block a lane;
    ``rc_cur`` how many probes this request already failed. Where
    ``active`` is false the lane's state threads through untouched and its
    outputs are don't-cares the caller masks. A failed probe occupies its
    slot for zero wall time and the caller parks the request until
    ``requeue_at`` (retry-as-park)."""
    busy, log_speed, last_used, recycle, alive = slots
    J = torch.exp(su)
    t_c = _col(t_req)

    free = busy <= t_c
    idle_ok = ((t_c - last_used) <= _col(params.idle_timeout_ms)) & (t_c < recycle)
    valid = alive & free & idle_ok
    any_valid = valid.any(dim=1)
    any_free = free.any(dim=1)

    # case A — warm now: reuse-order tournament (argmax keeps the lowest
    # index on exact ties, the event pool's stable list order)
    sign = torch.where(params.order == 0, 1.0, -1.0)
    k_a = torch.where(valid, _col(sign) * last_used, -torch.inf).argmax(dim=1)
    # case B — no valid warm slot but a free one: cold start into the
    # first free slot
    k_b = _first_true(free)
    # case C — every slot busy: wait for the earliest completion
    k_c = busy.argmin(dim=1)
    case_c = ~any_free
    k = torch.where(any_valid, k_a, torch.where(any_free, k_b, k_c))
    t_start = torch.where(case_c, torch.maximum(_take(busy, k_c), t_req), t_req)
    recycled_c = case_c & (t_start >= _take(recycle, k_c))
    served_cold = (~any_valid & any_free) | recycled_c
    any_warm = ~served_cold
    log_i = _take(log_speed, k)
    day_mean, log_day = _day(params, cfg, consts, t_start)

    # warm path: AR(1) drift, prepare + body (one request per slot: no
    # self-contention, judge load factor 1)
    log_drifted = _warm_drift(params, log_i, log_day, su)
    download_w = params.prepare_ms * J[:, 1]
    analysis_w = params.body_ms * J[:, 2] * torch.exp(-log_drifted)
    dur_w = download_w + analysis_w

    # cold path: ONE probe attempt (retries re-enter via the park ring)
    cold_ms, download_c, bench, log_bench, analysis_c, log_speed_c = \
        _attempt_values(params, consts, su, J, day_mean, log_day, 0)
    probed = active & served_cold & (params.gate_mode > 0) \
        & (rc_cur < params.max_retries)
    est, thr = _judge_one(params, cfg, est, bench, log_bench, probed)
    passes = (~probed) | (bench <= thr)
    completed = active & (any_warm | passes)
    fail = active & served_cold & ~passes

    ready_c = torch.where(probed, torch.maximum(download_c, bench), download_c)
    analysis = torch.where(served_cold, analysis_c, analysis_w)
    service = torch.where(served_cold, cold_ms + ready_c + analysis_c, dur_w)
    t_end = t_start + service
    probe_end = t_start + cold_ms + bench
    billed = torch.where(
        served_cold, params.bill_cold_start * cold_ms + ready_c + analysis_c, dur_w)
    bill_fail = params.bill_cold_start * cold_ms + bench
    requeue_at = probe_end + params.requeue_overhead_ms + params.requeue_penalty_ms
    log_speed_served = torch.where(served_cold, log_speed_c, log_drifted)
    recycle_new = _recycle_at(params, t_start, ex)

    # a failed probe leaves no trace in the slot arrays
    upd = _col(completed) & _onehot(k, busy.shape[1])
    slots = (
        torch.where(upd, _col(t_end), busy),
        torch.where(upd, _col(log_speed_served), log_speed),
        torch.where(upd, _col(t_end), last_used),
        torch.where(upd, _col(torch.where(served_cold, recycle_new, _take(recycle, k))),
                    recycle),
        alive | upd,
    )
    o = {
        "t_start": t_start, "t_end": t_end,
        "served_cold": active & served_cold, "completed": completed,
        "fail": fail, "analysis": analysis, "billed": billed,
        "bill_fail": bill_fail, "requeue_at": requeue_at,
    }
    return slots, est, o


def _open_step(params: ArmParams, cfg: OpenSimConfig, consts: dict,
               state: OpenState, draws):
    """One arrival of the open loop, in event-dispatcher order: phase 1
    drains up to ``cfg.drains_per_step`` matured park-ring entries in
    FIFO-by-ready order, each dispatched at its own ``park_ready``; phase 2
    runs the admission pipeline (defer, then drop) on the step's own
    arrival and dispatches it when admitted. Each step emits
    ``drains_per_step + 1`` rows (drains first, arrival last) with
    ``completed`` / ``dropped`` / ``deferred`` masks. The reference's
    docstring lists the approximations against the event loop."""
    W = cfg.queue_ring
    D = cfg.drains_per_step
    u, ex, iat = draws
    su = u * consts["scale_blocks"]
    t_arr = state.t_arr + iat
    ring = torch.arange(W, device=t_arr.device)

    slots = (state.busy, state.log_speed, state.last_used, state.recycle,
             state.alive)
    est = (state.probe_w, state.log_probe_w, state.n_probes, state.p2,
           state.ema, state.ema_init, state.since_publish)
    park_ready, park_start = state.park_ready, state.park_start
    park_retries, park_bill = state.park_retries, state.park_bill
    park_wait = state.park_wait
    starts, sidx = state.starts, state.starts_idx

    wf = {"body_w": state.body_w, "latency_w": state.latency_w,
          "wait_w": state.wait_w, "reuse_w": state.reuse_w}
    acc = {k: getattr(state, k) for k in (
        "n_started", "n_terminated", "n_completed", "n_dropped",
        "n_deferred", "nb_term", "nb_pass", "nb_reuse",
        "db_term", "db_pass", "db_reuse")}
    rows: list = []

    def add(name, x):
        acc[name] = acc[name] + x

    def account(o, lat, wait, wait_mask, bill_prev, rc, dropped, deferred):
        cdone = o["completed"]
        warm = cdone & ~o["served_cold"]
        cp = cdone & o["served_cold"]
        failf = o["fail"].to(F32)
        wf["body_w"] = welford_update_masked(wf["body_w"], o["analysis"], cdone)
        wf["latency_w"] = welford_update_masked(wf["latency_w"], lat, cdone)
        wf["wait_w"] = welford_update_masked(wf["wait_w"], wait, wait_mask)
        wf["reuse_w"] = welford_update_masked(wf["reuse_w"], warm.to(F32), cdone)
        add("n_started", o["served_cold"].to(F32))
        add("n_terminated", failf)
        add("n_completed", cdone.to(F32))
        add("n_dropped", dropped.to(F32))
        add("n_deferred", deferred.to(F32))
        add("nb_term", failf)
        add("nb_pass", cp.to(F32))
        add("nb_reuse", warm.to(F32))
        add("db_term", failf * o["bill_fail"])
        add("db_pass", cp.to(F32) * o["billed"])
        add("db_reuse", warm.to(F32) * o["billed"])
        if cfg.collect_requests:
            rows.append({
                "latency_ms": lat, "wait_ms": wait,
                "analysis_ms": o["analysis"],
                # a retry completion's bill includes its failed attempts
                "billed_ms": bill_prev + o["billed"],
                "served_by_cold": o["served_cold"],
                "retries": rc, "t_completed_ms": o["t_end"],
                # rows with completed=False are attempt/defer/drop records
                "completed": cdone, "dropped": dropped,
                "deferred": deferred})

    def log_start(starts, sidx, mask, t_start):
        at = mask.unsqueeze(1) & (ring == torch.remainder(sidx, W).unsqueeze(1))
        return torch.where(at, _col(t_start), starts), sidx + mask.to(I32)

    fz = torch.zeros_like(state.alive[:, 0])
    # ---- phase 1: drain matured parked requests, FIFO by ready time ----
    for di in range(D):
        j = park_ready.argmin(dim=1)
        ready_j = _take(park_ready, j)
        drain = torch.isfinite(ready_j) & (ready_j <= t_arr)
        rc_d = _take(park_retries, j)
        start_d = _take(park_start, j)
        bill_prev = _take(park_bill, j)
        slots, est, d = _open_dispatch(
            params, cfg, consts, slots, est, su[:, 8 * di:8 * di + 8], ex[:, di],
            torch.where(drain, ready_j, t_arr), rc_d, drain)
        oh = _onehot(j, W) & _col(drain)
        fail_d = _col(d["fail"])
        park_ready = torch.where(
            oh, torch.where(fail_d, _col(d["requeue_at"]), torch.inf), park_ready)
        park_retries = torch.where(oh & fail_d, _col(rc_d + 1), park_retries)
        park_bill = torch.where(
            oh, torch.where(fail_d, _col(bill_prev + d["bill_fail"]), 0.0), park_bill)
        # queue wait = until FIRST dispatch, back-dated to arrival for
        # deferred items; requeues carry theirs through the ring
        wait_d = torch.where(rc_d > 0, _take(park_wait, j), d["t_start"] - start_d)
        park_wait = torch.where(oh & fail_d, _col(wait_d), park_wait)
        # log the drained dispatch's start so queue-depth counts see it
        starts, sidx = log_start(starts, sidx, drain, d["t_start"])
        account(d, d["t_end"] - start_d, wait_d,
                drain & (rc_d == 0), bill_prev, rc_d, fz, fz)

    # ---- phase 2: admission pipeline on the step's own arrival ---------
    busy1 = slots[0]
    t_c = _col(t_arr)
    parked = torch.isfinite(park_ready)
    # in-flight work the admission bound sees: in service, slot promised
    # but not yet started, or mid retry-chain (admission-deferred parks are
    # the event loop's pending deque, not in flight)
    in_service = _count(busy1 > t_c)
    q_wait = _count(starts > t_c)
    n_retry = _count(parked & (park_retries > 0))
    in_flight = in_service + q_wait + n_retry
    defer = in_flight.to(F32) >= params.admit_bound
    # the engine's submit drops when the wait queue is at capacity —
    # checked after admission
    drop = ~defer & (q_wait.to(F32) >= params.queue_capacity)
    admitted = ~defer & ~drop

    slots, est, a = _open_dispatch(
        params, cfg, consts, slots, est, su[:, 8 * D:], ex[:, D], t_arr,
        torch.zeros_like(state.starts_idx), admitted)
    starts, sidx = log_start(starts, sidx, admitted, a["t_start"])

    # park the arrival when deferred, or when its probe failed (retry);
    # a full ring drops the request (counted, never silent)
    want_park = defer | a["fail"]
    empty = ~torch.isfinite(park_ready)
    j2 = _first_true(empty)
    overflow = want_park & ~empty.any(dim=1)
    oh2 = _onehot(j2, W) & _col(want_park & ~overflow)
    defer_c = _col(defer)
    # a deferred item re-offers at the next completion (earliest busy
    # horizon), the event loop's done → re-offer hook
    reoffer_at = torch.maximum(busy1.amin(dim=1), t_arr)
    park_ready = torch.where(
        oh2, torch.where(defer_c, _col(reoffer_at), _col(a["requeue_at"])), park_ready)
    park_start = torch.where(oh2, t_c, park_start)
    park_retries = torch.where(oh2, (~defer_c).to(I32), park_retries)
    park_bill = torch.where(oh2, torch.where(defer_c, 0.0, _col(a["bill_fail"])),
                            park_bill)
    park_wait = torch.where(oh2, torch.where(defer_c, 0.0, _col(a["t_start"] - t_arr)),
                            park_wait)
    account(a, a["t_end"] - t_arr, a["t_start"] - t_arr, admitted,
            torch.zeros_like(t_arr), torch.zeros_like(state.starts_idx),
            drop | overflow, defer & ~overflow)

    new_state = OpenState(
        t_arr=t_arr,
        busy=slots[0], log_speed=slots[1], last_used=slots[2],
        recycle=slots[3], alive=slots[4],
        starts=starts, starts_idx=sidx,
        park_ready=park_ready, park_start=park_start,
        park_retries=park_retries, park_bill=park_bill,
        park_wait=park_wait,
        probe_w=est[0], log_probe_w=est[1],
        body_w=wf["body_w"], latency_w=wf["latency_w"],
        wait_w=wf["wait_w"], reuse_w=wf["reuse_w"],
        p2=est[3], ema=est[4], ema_init=est[5], since_publish=est[6],
        n_probes=est[2],
        **acc,
    )
    if not cfg.collect_requests:
        return new_state, None
    return new_state, {k: torch.stack([r[k] for r in rows], dim=1) for k in rows[0]}


def _open_consts(params: ArmParams, cfg: OpenSimConfig) -> dict:
    pj, bj = params.prepare_jitter, params.body_jitter
    cj, bn, sg = params.cold_start_jitter, params.benchmark_noise, params.sigma
    block = [sg, pj, bj, sg, cj, pj, bn, bj]
    return {
        "scale_blocks": torch.stack(block * (cfg.drains_per_step + 1), dim=1),
        "log_df": torch.log(params.day_factor),
        "log_bench_ms": torch.log(params.benchmark_ms),
    }


def _open_init(params: ArmParams, cfg: OpenSimConfig) -> OpenState:
    L = params.sigma.shape[0]
    dev = params.sigma.device
    K, W = cfg.n_servers, cfg.queue_ring

    def full(shape, v, dtype=F32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    z = full((L,), 0.0)
    return OpenState(
        t_arr=z,
        busy=full((L, K), 0.0), log_speed=full((L, K), 0.0),
        last_used=full((L, K), 0.0), recycle=full((L, K), math.inf),
        alive=full((L, K), False, torch.bool),
        # -inf: an unused log entry is never counted as a future start
        starts=full((L, W), -math.inf), starts_idx=full((L,), 0, I32),
        park_ready=full((L, W), math.inf), park_start=full((L, W), 0.0),
        park_retries=full((L, W), 0, I32), park_bill=full((L, W), 0.0),
        park_wait=full((L, W), 0.0),
        probe_w=welford_init((L,), device=dev), log_probe_w=welford_init((L,), device=dev),
        body_w=welford_init((L,), device=dev), latency_w=welford_init((L,), device=dev),
        wait_w=welford_init((L,), device=dev), reuse_w=welford_init((L,), device=dev),
        p2=p2_init(params.pass_fraction) if cfg.adaptive else None,
        ema=z if cfg.adaptive else None,
        ema_init=full((L,), False, torch.bool) if cfg.adaptive else None,
        since_publish=full((L,), 0, I32) if cfg.adaptive else None,
        n_probes=full((L,), 0, I32),
        n_started=z, n_terminated=z,
        n_completed=z, n_dropped=z, n_deferred=z,
        nb_term=z, nb_pass=z, nb_reuse=z,
        db_term=z, db_pass=z, db_reuse=z,
    )


def _open_summary(params: ArmParams, cfg: OpenSimConfig, final: OpenState) -> dict:
    n = torch.full_like(final.t_arr, float(cfg.n_steps))
    n_probes = final.n_probes.to(F32)
    return {
        "n_requests": n,
        # conservation (tested): every arrival completes, drops, or is
        # still parked (deferred / awaiting retry) at the horizon
        "n_completed": final.n_completed,
        "n_dropped": final.n_dropped,
        "n_deferred": final.n_deferred,
        "n_parked_end": torch.isfinite(final.park_ready).to(F32).sum(dim=1),
        "drop_rate": final.n_dropped / n,
        "defer_rate": final.n_deferred / n,
        "n_started": final.n_started,
        "n_terminated": final.n_terminated,
        "n_probes": n_probes,
        "reuse_rate": final.reuse_w.mean,
        "mean_analysis_ms": final.body_w.mean,
        "mean_latency_ms": final.latency_w.mean,
        "mean_wait_ms": final.wait_w.mean,
        "std_wait_ms": welford_std(final.wait_w),
        "probe_mean_ms": final.probe_w.mean,
        "probe_log_std": welford_std(final.log_probe_w),
        "pass_rate": 1.0 - final.n_terminated / torch.clamp(n_probes, min=1.0),
        "bill_n": torch.stack([final.nb_term, final.nb_pass, final.nb_reuse], dim=-1),
        "bill_d": torch.stack([final.db_term, final.db_pass, final.db_reuse], dim=-1),
        "cost": _cost(params, final),
        "horizon_ms": final.t_arr,
    }


# ---------------------------------------------------------------------------
# Host entry points
# ---------------------------------------------------------------------------

#: runner/call accounting, so sweeps and tests can assert that the cache
#: hits on a second arm batch of the same shape. On the card "compiles"
#: counts captures (one per (config, batch shape)); on the CPU the runners
#: the cache builds.
jit_stats = {"compiles": 0, "calls": 0}

_JIT_CACHE: dict = {}

_M64 = (1 << 64) - 1


def _lane_key(seed: int, arm: int) -> int:
    """64-bit generator seed of lane (seed, arm): splitmix64 of the pair."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(arm) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _make_draws(seeds, n_arms: int, normal_shape: tuple, exp_shape: tuple, device):
    """Each lane's standard normals ``(L, *normal_shape)`` and standard
    exponentials ``(L, *exp_shape)`` from a generator on ``device`` seeded
    by :func:`_lane_key`, so a lane's draws depend only on (seed, arm)."""
    seeds = [int(s) for s in seeds]
    L = n_arms * len(seeds)
    u = torch.empty((L,) + tuple(normal_shape), dtype=F32, device=device)
    ex = torch.empty((L,) + tuple(exp_shape), dtype=F32, device=device)
    gen = torch.Generator(device=device)
    lane = 0
    for arm in range(n_arms):
        for seed in seeds:
            gen.manual_seed(_lane_key(seed, arm))
            u[lane].normal_(generator=gen)
            ex[lane].exponential_(generator=gen)
            lane += 1
    return u, ex


def _lanes(arms: ArmParams, n_seeds: int, device) -> tuple[ArmParams, int]:
    """Arm leaves as ``(L,)`` tensors on ``device``, each arm repeated for
    its seeds (arm-major); int leaves int32, the rest float32."""
    leaves = [np.atleast_1d(np.asarray(x)) for x in arms]
    n_arms = max(leaf.shape[0] for leaf in leaves)
    out = []
    for leaf in leaves:
        dtype = np.int32 if leaf.dtype.kind in "iu" else np.float32
        arr = np.ascontiguousarray(np.broadcast_to(leaf, (n_arms,)).astype(dtype))
        out.append(torch.from_numpy(arr).to(device).repeat_interleave(n_seeds))
    return ArmParams(*out), n_arms


def _lane_draws(seeds, n_arms: int, normal_shape: tuple, exp_shape: tuple, device,
                draws, draw_device):
    """The lanes' (normals, exponentials) on ``device``: the port's own,
    made on ``draw_device`` (default ``device``), or the given ``draws``
    arrays of shapes ``(n_arms, n_seeds, *normal_shape)`` and ``(n_arms,
    n_seeds, *exp_shape)``."""
    if draws is None:
        u, ex = _make_draws(seeds, n_arms, normal_shape, exp_shape,
                            resolve_device(draw_device) if draw_device else device)
        return u.to(device), ex.to(device)
    lead = (n_arms, len(seeds))
    want = (lead + tuple(normal_shape), lead + tuple(exp_shape))
    u, ex = (x if torch.is_tensor(x) else torch.from_numpy(np.array(x, dtype=np.float32))
             for x in draws)
    if (tuple(u.shape), tuple(ex.shape)) != want:
        raise ValueError(f"draws {tuple(u.shape)}, {tuple(ex.shape)}; need {want[0]} and {want[1]}")
    return tuple(x.to(device=device, dtype=F32).flatten(0, 1) for x in (u, ex))


def _run_lanes(cfg, batch_shape, step_fn, params, consts, state, xs, eager: bool):
    """Run ``step_fn`` over ``cfg.n_steps`` steps from ``state`` on the lane
    inputs ``xs``; returns (final state, rows or None). The step loop is
    cached per (config, batch shape, device): on the card a captured
    :class:`_GraphScan` unless ``eager``, which runs a fresh uncached
    :class:`_EagerScan`; on the CPU an :class:`_EagerScan`."""
    def step(fixed, st, x):
        return step_fn(fixed[0], cfg, fixed[1], st, x)

    fixed = (params, consts)
    device = xs[0].device
    key = (cfg, batch_shape, str(device))
    if eager and device.type == "cuda":
        run = _EagerScan(step, cfg.n_steps)
    elif key in _JIT_CACHE:
        run = _JIT_CACHE[key]
    else:
        jit_stats["compiles"] += 1
        run = _JIT_CACHE[key] = (_GraphScan(step, cfg.n_steps, fixed, state, xs)
                                 if device.type == "cuda" else _EagerScan(step, cfg.n_steps))
    jit_stats["calls"] += 1
    return run.run(fixed, state, xs)


def _numpy_result(summary: dict, rows, n_arms: int, n_seeds: int):
    """Summaries to ``(n_arms, n_seeds, ...)`` numpy; rows, stored
    ``(n_steps, L, ...)``, to ``(n_arms, n_seeds, n_steps, ...)``."""
    def arr(t):
        return t.cpu().numpy().reshape((n_arms, n_seeds) + tuple(t.shape[1:]))
    summary = {k: arr(v) for k, v in summary.items()}
    if rows is not None:
        rows = {k: arr(v.movedim(0, 1)) for k, v in rows.items()}
    return summary, rows


@dataclasses.dataclass
class VecResult:
    """Grid results as numpy arrays: summary leaves have shape
    (n_arms, n_seeds); per-request leaves (n_arms, n_seeds, n_steps)."""

    summary: dict
    requests: Optional[dict]
    n_arms: int
    n_seeds: int
    n_steps: int

    def mean_over_seeds(self, name: str) -> np.ndarray:
        return np.asarray(self.summary[name]).mean(axis=1)


def _closed_config(arms, n_steps, pool_size, n_streams, max_attempts,
                   collect_requests) -> SimConfig:
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1, got {n_streams}")
    if pool_size is None:
        pool_size = max(1, n_streams)
    if pool_size < n_streams:
        raise ValueError(
            f"pool_size={pool_size} < n_streams={n_streams}: a cold start "
            "could find no free slot (need pool_size >= n_streams)")
    max_r = int(np.max(np.asarray(arms.max_retries)))
    if max_attempts is None:
        max_attempts = max_r + 1
    if max_attempts < max_r + 1:
        raise ValueError(
            f"max_attempts={max_attempts} cannot cover max_retries={max_r}")
    return SimConfig(n_steps=int(n_steps), pool_size=int(pool_size),
                     max_attempts=int(max_attempts),
                     collect_requests=bool(collect_requests),
                     adaptive=bool(np.any(np.asarray(arms.gate_mode) == GATE_ADAPTIVE)),
                     diurnal=bool(np.any(np.asarray(arms.diurnal_amplitude) != 0.0)),
                     n_streams=int(n_streams))


def _simulate_arms(arms: ArmParams, *, seeds, n_steps: int,
                   pool_size: Optional[int] = None, n_streams: int = 1,
                   max_attempts: Optional[int] = None,
                   collect_requests: bool = False, device=None,
                   draws=None, draw_device=None, eager: bool = False) -> VecResult:
    """:func:`simulate_arms` with the private seams: ``draws`` hands in
    each lane's draws, ``(u_all, ex_all)`` of shapes ``(n_arms, n_seeds,
    n_steps, 3+5·ma)`` and ``(n_arms, n_seeds, n_steps)`` (``ma`` = 1 when
    ``n_streams > 1``, else ``max_attempts``); ``draw_device`` makes the
    port's own draws on another device than the run's; ``eager`` runs the
    steps op by op on the card instead of replaying the captured graphs."""
    cfg = _closed_config(arms, n_steps, pool_size, n_streams, max_attempts,
                         collect_requests)
    dev = resolve_device(device)
    seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
    n_seeds = len(seeds)
    params, n_arms = _lanes(arms, n_seeds, dev)
    nu = 3 + 5 * (1 if cfg.n_streams > 1 else cfg.max_attempts)
    u_all, ex_all = _lane_draws(seeds, n_arms, (cfg.n_steps, nu), (cfg.n_steps,), dev,
                                draws, draw_device)
    final, rows = _run_lanes(cfg, (n_arms, n_seeds), _step_multi if cfg.n_streams > 1 else _step,
                             params, _closed_consts(params, cfg), _closed_init(params, cfg),
                             (u_all, ex_all), eager)
    summary, requests = _numpy_result(_closed_summary(params, cfg, final), rows,
                                      n_arms, n_seeds)
    if _sanitizer.enabled():
        _sanitizer.check_finite(summary, where="simulate_arms")
    return VecResult(summary=summary, requests=requests, n_arms=n_arms,
                     n_seeds=n_seeds, n_steps=cfg.n_steps)


def simulate_arms(
    arms: ArmParams,
    *,
    seeds,
    n_steps: int,
    pool_size: Optional[int] = None,
    n_streams: int = 1,
    max_attempts: Optional[int] = None,
    collect_requests: bool = False,
    device=None,
) -> VecResult:
    """Run every arm × seed lane through the step loop; returns numpy.

    ``n_streams`` is the number of closed-loop virtual users sharing the
    slot pool (the event engine's ``n_vus``; ``n_steps`` stays the TOTAL
    request count across streams). ``pool_size`` defaults to
    ``max(1, n_streams)`` and must be at least ``n_streams`` when given.
    ``device`` is where the lanes run: the card unless ``"cpu"`` is asked
    for."""
    return _simulate_arms(arms, seeds=seeds, n_steps=n_steps, pool_size=pool_size,
                          n_streams=n_streams, max_attempts=max_attempts,
                          collect_requests=collect_requests, device=device)


#: one-shot latch for the think-time contract warning below (tests reset
#: it to re-assert the warning fires).
_OPEN_THINK_WARNED = False


def _simulate_open_arms(arms: ArmParams, *, seeds, iats_ms: np.ndarray,
                        n_servers: int = 4, max_attempts: Optional[int] = None,
                        queue_ring: int = 32, drains_per_step: int = 3,
                        collect_requests: bool = False, device=None,
                        draws=None, draw_device=None, eager: bool = False) -> VecResult:
    """:func:`simulate_open_arms` with the private seams of
    :func:`_simulate_arms`; ``draws`` is ``(u_all, ex_all)`` of shapes
    ``(n_arms, n_seeds, n_steps, 8·(D+1))`` and ``(n_arms, n_seeds,
    n_steps, D+1)``, ``D = drains_per_step``."""
    global _OPEN_THINK_WARNED
    if not _OPEN_THINK_WARNED and np.any(np.asarray(arms.think_time_ms) != 0.0):
        warnings.warn(
            "simulate_open_arms ignores ArmParams.think_time_ms: arrivals "
            "come from iats_ms, not a think-time loop (arm_from_spec "
            "defaults think_time_ms=1000, so this is expected for arms "
            "shared with the closed-loop scan). Warned once per process.",
            stacklevel=3)
        _OPEN_THINK_WARNED = True
    seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
    n_seeds = len(seeds)
    iats = np.asarray(iats_ms, np.float32)
    if iats.ndim == 1:
        iats = np.broadcast_to(iats, (n_seeds, iats.shape[0]))
    if iats.ndim != 2 or iats.shape[0] != n_seeds:
        raise ValueError(
            f"iats_ms must be (n_steps,) or (n_seeds, n_steps); got "
            f"{np.asarray(iats_ms).shape} for {n_seeds} seeds")
    n_steps = int(iats.shape[1])
    max_r = int(np.max(np.asarray(arms.max_retries)))
    if max_attempts is not None and max_attempts < max_r + 1:
        raise ValueError(
            f"max_attempts={max_attempts} cannot cover max_retries={max_r}")
    caps = np.asarray(arms.queue_capacity, float)
    finite_cap = caps[np.isfinite(caps)]
    if finite_cap.size and float(np.max(finite_cap)) > queue_ring:
        raise ValueError(
            f"queue_capacity={float(np.max(finite_cap)):g} exceeds "
            f"queue_ring={queue_ring}; the in-scan wait-queue counter "
            f"saturates at the ring size, so the drop gate would never "
            f"fire — raise queue_ring")
    cfg = OpenSimConfig(n_steps=n_steps, n_servers=int(n_servers),
                        queue_ring=int(queue_ring),
                        drains_per_step=int(drains_per_step),
                        collect_requests=bool(collect_requests),
                        adaptive=bool(np.any(np.asarray(arms.gate_mode) == GATE_ADAPTIVE)),
                        diurnal=bool(np.any(np.asarray(arms.diurnal_amplitude) != 0.0)))
    dev = resolve_device(device)
    params, n_arms = _lanes(arms, n_seeds, dev)
    D1 = cfg.drains_per_step + 1
    u_all, ex_all = _lane_draws(seeds, n_arms, (n_steps, 8 * D1), (n_steps, D1), dev,
                                draws, draw_device)
    # the arrival stream varies per SEED lane (one realization per seed)
    # and is shared across arms: every arm answers the same offered traffic
    iats_l = torch.from_numpy(np.ascontiguousarray(iats)).to(dev).repeat(n_arms, 1)

    final, rows = _run_lanes(cfg, (n_arms, n_seeds), _open_step, params,
                             _open_consts(params, cfg), _open_init(params, cfg),
                             (u_all, ex_all, iats_l), eager)
    summary, requests = _numpy_result(_open_summary(params, cfg, final), rows,
                                      n_arms, n_seeds)
    if _sanitizer.enabled():
        _sanitizer.check_open_summary(summary, n_steps, where="simulate_open_arms")
    return VecResult(summary=summary, requests=requests, n_arms=n_arms,
                     n_seeds=n_seeds, n_steps=n_steps)


def simulate_open_arms(
    arms: ArmParams,
    *,
    seeds,
    iats_ms: np.ndarray,
    n_servers: int = 4,
    max_attempts: Optional[int] = None,
    queue_ring: int = 32,
    drains_per_step: int = 3,
    collect_requests: bool = False,
    device=None,
) -> VecResult:
    """Open-loop variant of :func:`simulate_arms`: the steps consume
    ``iats_ms`` — host-generated inter-arrival times, shape ``(n_steps,)``
    (shared by every seed lane) or ``(n_seeds, n_steps)`` (one realization
    per seed). Each arrival runs the admission pipeline (defer at
    ``ArmParams.admit_bound``, drop at ``ArmParams.queue_capacity``) and
    then waits for the earliest of ``n_servers`` slots; a failed cold probe
    parks and requeues without holding its slot (``queue_ring`` bounds the
    park ring, see :class:`OpenSimConfig`).

    Contract: ``ArmParams.think_time_ms`` is IGNORED here (warned once per
    process when non-zero). ``max_attempts`` is only validated: retries
    cross steps via the park ring. ``device``: as :func:`simulate_arms`."""
    return _simulate_open_arms(arms, seeds=seeds, iats_ms=iats_ms, n_servers=n_servers,
                               max_attempts=max_attempts, queue_ring=queue_ring,
                               drains_per_step=drains_per_step,
                               collect_requests=collect_requests, device=device)


# ---------------------------------------------------------------------------
# Arm builders (mirror FaaSPlatform's spec/profile knob resolution)
# ---------------------------------------------------------------------------


def arm_from_spec(
    spec,
    variation,
    *,
    profile=None,
    pricing: Optional[Pricing] = None,
    gate: str = "fixed",
    threshold: float = math.inf,
    pass_fraction: float = 0.4,
    max_retries: int = 5,
    warmup_reports: int = 5,
    republish_every: int = 4,
    smoothing_alpha: float = 0.7,
    think_time_ms: float = 1000.0,
    admit_bound: Optional[float] = None,
) -> ArmParams:
    """Build one arm from the event engine's own config objects
    (:class:`~repro_torch.sim.platform.FunctionSpec`,
    :class:`~repro_torch.sim.platform.PlatformProfile`,
    :class:`~repro_torch.sim.variation.VariationModel`) so a parity test or grid
    sweep describes *one* scenario for both engines. ``gate`` is "off"
    (baseline arm), "fixed" (pre-tested ``threshold``) or "adaptive"
    (:class:`~repro_torch.core.policy.AdaptiveMinosPolicy` defaults).

    Per-instance concurrency, the load-slowdown alpha, load-aware gating
    and the finite queue buffer come from the resolved knobs (profile or
    spec); ``admit_bound`` is the static admission cap the open-loop scan
    defers at (:func:`repro_torch.core.control.static_admission_bound` computes
    the event engine's equivalent), ``None`` = admission disabled."""
    gate_mode = {"off": GATE_OFF, "fixed": GATE_FIXED,
                 "adaptive": GATE_ADAPTIVE}[gate]
    if gate_mode == GATE_FIXED and not math.isfinite(threshold):
        raise ValueError("gate='fixed' needs a finite threshold")
    if profile is not None:
        knobs = profile.knobs()
        if pricing is None:
            pricing = profile.pricing
    else:
        from repro_torch.core.substrate import SubstrateKnobs
        knobs = SubstrateKnobs(
            cold_start_ms=spec.cold_start_ms,
            cold_start_jitter=spec.cold_start_jitter,
            idle_timeout_ms=spec.idle_timeout_ms,
            recycle_lifetime_ms=spec.recycle_lifetime_ms,
            bill_cold_start=spec.bill_cold_start,
            requeue_overhead_ms=spec.requeue_overhead_ms,
        )
    if pricing is None:
        raise ValueError("pricing is required when no profile is given")
    return ArmParams(
        sigma=float(variation.sigma),
        day_factor=float(variation.day_factor),
        diurnal_amplitude=float(variation.diurnal_amplitude),
        diurnal_phase_h=float(variation.diurnal_phase_h),
        prepare_ms=float(spec.prepare_ms),
        prepare_jitter=float(spec.prepare_jitter),
        body_ms=float(spec.body_ms),
        body_jitter=float(spec.body_jitter),
        benchmark_ms=float(spec.benchmark_ms),
        benchmark_noise=float(spec.benchmark_noise),
        contention_rho=float(spec.contention_rho),
        cold_start_ms=float(knobs.cold_start_ms),
        cold_start_jitter=float(knobs.cold_start_jitter),
        idle_timeout_ms=float(knobs.idle_timeout_ms),
        recycle_lifetime_ms=(
            math.inf if knobs.recycle_lifetime_ms is None
            else float(knobs.recycle_lifetime_ms)),
        bill_cold_start=1.0 if knobs.bill_cold_start else 0.0,
        requeue_overhead_ms=float(knobs.requeue_overhead_ms),
        requeue_penalty_ms=0.0,
        order=int(ORDER_CODES[knobs.warm_pool_order]),
        gate_mode=int(gate_mode),
        threshold=float(threshold),
        pass_fraction=float(pass_fraction),
        max_retries=int(max_retries),
        warmup_reports=int(warmup_reports),
        republish_every=int(republish_every),
        smoothing_alpha=float(smoothing_alpha),
        think_time_ms=float(think_time_ms),
        cost_per_invocation=float(pricing.cost_per_invocation),
        cost_per_ms=float(pricing.cost_per_ms),
        concurrency=int(knobs.per_instance_concurrency),
        load_slowdown_alpha=float(knobs.load_slowdown_alpha),
        gate_load_aware=1.0 if knobs.gate_load_aware else 0.0,
        queue_capacity=(
            math.inf if knobs.queue_capacity is None
            else float(knobs.queue_capacity)),
        admit_bound=math.inf if admit_bound is None else float(admit_bound),
    )


def stack_arms(arms: list) -> ArmParams:
    """Stack a list of scalar :class:`ArmParams` into one batched pytree."""
    if not arms:
        raise ValueError("need at least one arm")
    return ArmParams(*[
        np.asarray([getattr(a, f) for a in arms]) for f in ArmParams._fields])


# ---------------------------------------------------------------------------
# Event-engine reference chain (the exact scenario the fast path models)
# ---------------------------------------------------------------------------


def run_event_chain(platform, n_requests: int,
                    think_time_ms: float = 1000.0, n_vus: int = 1) -> list:
    """Drive a :class:`~repro_torch.sim.platform.FaaSPlatform` with ``n_vus``
    closed-loop virtual users for exactly ``n_requests`` total
    completions — the event-engine scenario :func:`simulate_arms`
    vectorizes (``n_vus`` maps to its ``n_streams``). All users submit at
    t=0 (like :func:`repro_torch.sim.workload.run_closed_loop`), each resubmits
    ``think_time_ms`` after its completion while the budget lasts. Used
    by the parity tests and as the sweeps' per-arm timing reference."""
    results: list = []
    # budget is reserved at SCHEDULING time, so concurrent completions
    # (n_vus > 1) can never over-submit past n_requests
    budget = n_requests

    def on_complete(res) -> None:
        nonlocal budget
        results.append(res)
        if budget > 0:
            budget -= 1
            platform.loop.after(
                think_time_ms, lambda: platform.submit(None, on_complete))

    for _ in range(min(n_vus, n_requests)):
        budget -= 1
        platform.submit(None, on_complete)
    platform.loop.run_all()
    assert len(results) == n_requests
    return results


__all__ = [
    "ArmParams",
    "GATE_ADAPTIVE",
    "GATE_FIXED",
    "GATE_OFF",
    "ORDER_CODES",
    "OpenSimConfig",
    "SimConfig",
    "VecResult",
    "arm_from_spec",
    "jit_stats",
    "run_event_chain",
    "simulate_arms",
    "simulate_open_arms",
    "stack_arms",
]
