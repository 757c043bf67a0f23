"""The port's vectorized Monte-Carlo path (``repro_torch.sim.vectorized``)
against the reference (``repro.sim.vectorized``), on the CPU.

* **Numeric parity on the reference's draws.** Each lane's draws are made
  here with ``jax.random`` exactly as the reference's chain makes them
  (``fold_in(PRNGKey(seed), arm)``, ``split``, ``normal``, ``exponential``)
  and handed through numpy to the port's run-on-given-draws seam. Integer
  summaries and rows must be equal in every lane; float summaries and rows
  within rtol 1e-4 (XLA's and torch's ``exp``/``log``/``cos`` differ by an
  ulp, and horizons reach about 1e6 ms in f32), a float row also within 4
  f32 ulps of its lane's horizon (a wait is the difference of two absolute
  times there).
* **Statistical parity on the port's own draws** against the copied event
  engine, at the reference's bounds (``tests/test_vectorized_parity.py``,
  ``tests/test_multistream_vectorized.py``), on cells where the reference
  passes them itself.
* **Structure**, as the reference's tests hold it: the runner cache, bitwise
  determinism, lane independence, open-loop conservation, the slot-load
  replay, the think-time warning, the argument checks and the sanitizer.
"""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats
from scipy.stats import ks_2samp

import repro.sim.vectorized as RV
import repro_torch.sim.vectorized as TV
from repro_torch.analysis import sanitizer as t_sanitizer
from repro_torch.core.policy import AdaptiveMinosPolicy, MinosPolicy
from repro_torch.sim import FaaSPlatform, FunctionSpec, PlatformProfile, VariationModel
from repro_torch.sim.arrivals import PoissonProcess, run_open_loop
from test_multistream_vectorized import _replay_slot_loads

RTOL = 1e-4
# a float row may also differ by up to ULPS f32 ulps of its lane's horizon:
# waits and open-loop latencies are differences of two absolute times near
# it, so one ulp of those times is as close as they can agree
ULPS = 4
INT_SUMMARIES = ("n_requests", "n_completed", "n_started", "n_terminated", "n_probes",
                 "n_dropped", "n_deferred", "n_parked_end", "bill_n")

# the reference parity tests' scenario (churny recycle keeps probes flowing)
SPEC = FunctionSpec(
    name="parity", prepare_ms=600.0, body_ms=1500.0, benchmark_ms=300.0,
    cold_start_ms=250.0, recycle_lifetime_ms=8_000.0, contention_rho=0.95,
    benchmark_noise=0.08,
)
VM = VariationModel(sigma=0.15)
THINK_MS = 500.0
THRESHOLD = SPEC.benchmark_ms * math.exp(
    stats.norm.ppf(0.4) * math.sqrt(VM.sigma ** 2 + SPEC.benchmark_noise ** 2))
PROFILES = ("gcf-gen1", "gcf-gen2", "lambda")
GATES = ("off", "fixed", "adaptive")


def _profile(name: str) -> PlatformProfile:
    prof = {"gcf-gen1": PlatformProfile.gcf_gen1, "gcf-gen2": PlatformProfile.gcf_gen2,
            "lambda": PlatformProfile.aws_lambda}[name]()
    return dataclasses.replace(prof, recycle_lifetime_ms=8_000.0)


def _loaded(**kw) -> PlatformProfile:
    return dataclasses.replace(PlatformProfile.gcf_gen2_loaded(**kw), recycle_lifetime_ms=8_000.0)


def _arm(profile, gate, **kw):
    kw.setdefault("think_time_ms", THINK_MS)
    return TV.arm_from_spec(SPEC, VM, profile=profile, gate=gate, threshold=THRESHOLD,
                            pass_fraction=0.4, **kw)


def _policy(gate: str):
    if gate == "off":
        return MinosPolicy(elysium_threshold=float("inf"), enabled=False)
    if gate == "fixed":
        return MinosPolicy(elysium_threshold=THRESHOLD, max_retries=5)
    return AdaptiveMinosPolicy(0.4, max_retries=5)


# ---------------------------------------------------------------------------
# Numeric parity on the reference's draws
# ---------------------------------------------------------------------------

N_STEPS = 200
SEEDS = np.arange(4, dtype=np.uint32)


def _jax_draws(n_arms, normal_shape, exp_shape):
    """Every lane's (u_all, ex_all), (n_arms, n_seeds, ...), made as the
    reference's chains make theirs (vectorized.py:913-915, 1389-1393)."""
    def lane(seed, arm):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), arm)
        k_normal, k_exp = jax.random.split(key)
        return (jax.random.normal(k_normal, normal_shape, jnp.float32),
                jax.random.exponential(k_exp, exp_shape, jnp.float32))

    per_arm = jax.vmap(lane, in_axes=(0, None))
    u, ex = jax.jit(jax.vmap(per_arm, in_axes=(None, 0)))(
        jnp.asarray(SEEDS), jnp.arange(n_arms, dtype=jnp.uint32))
    return np.asarray(u), np.asarray(ex)


def _single_arms():
    return TV.stack_arms([_arm(_profile(p), g) for p in PROFILES for g in GATES])


def _multi_arms():
    # tests/test_multistream_vectorized.py::_slot_arm over its grid
    return TV.stack_arms([
        _arm(_loaded(concurrency=c, alpha=0.6), g)._replace(order=TV.ORDER_CODES[o])
        for o in ("lifo", "fifo", "spread") for c in (1, 4) for g in ("off", "fixed")])


def _open_profile_arms():
    return TV.stack_arms([_arm(_profile(p), g, think_time_ms=0.0)
                          for p in ("gcf-gen1", "lambda") for g in ("off", "fixed")])


def _open_admission_arms():
    # test_open_defer_conserves_and_counts / test_open_drop_conserves_and_counts
    return TV.stack_arms([_arm(_profile("gcf-gen1"), "fixed", think_time_ms=0.0, admit_bound=4.0),
                          _arm(_profile("gcf-gen1"), "fixed", think_time_ms=0.0)
                          ._replace(queue_capacity=3.0)])


def _iats(n_steps, seeds, rate=0.9, base=5000):
    proc = PoissonProcess(rate)
    return np.stack([proc.iats_ms(np.random.RandomState(base + int(i)), n_steps) for i in seeds])


def _closed_pair(arms, n_streams):
    ref = RV.simulate_arms(arms, seeds=SEEDS, n_steps=N_STEPS, n_streams=n_streams,
                           collect_requests=True)
    nu = 3 + 5 * (1 if n_streams > 1 else int(np.max(arms.max_retries)) + 1)
    draws = _jax_draws(len(arms.sigma), (N_STEPS, nu), (N_STEPS,))
    port = TV._simulate_arms(arms, seeds=SEEDS, n_steps=N_STEPS, n_streams=n_streams,
                             collect_requests=True, device="cpu", draws=draws)
    return ref, port


def _open_pair(arms, n_servers):
    iats = _iats(N_STEPS, SEEDS)
    kw = dict(seeds=SEEDS, iats_ms=iats, n_servers=n_servers, collect_requests=True)
    ref = RV.simulate_open_arms(arms, **kw)
    draws = _jax_draws(len(arms.sigma), (N_STEPS, 32), (N_STEPS, 4))
    port = TV._simulate_open_arms(arms, device="cpu", draws=draws, **kw)
    return ref, port


PARITY_SETS = {
    # 3 profiles x 3 gates, single stream, adaptive arms included
    "single": lambda: _closed_pair(_single_arms(), 1),
    # n_streams=4, concurrency 1 and 4, lifo/fifo/spread, gate off/fixed
    "multi4": lambda: _closed_pair(_multi_arms(), 4),
    # the gcf-gen2-loaded load-aware arms at the reference's 8 streams
    "multi_loaded": lambda: _closed_pair(
        TV.stack_arms([_arm(_loaded(), g) for g in ("off", "fixed")]), 8),
    # open loop: 2 profiles x 2 gates at 4 servers
    "open": lambda: _open_pair(_open_profile_arms(), 4),
    # open loop: finite admit_bound and queue_capacity at 2 servers
    "open_admission": lambda: _open_pair(_open_admission_arms(), 2),
}
_PAIRS: dict = {}


def _pair_of(name):
    """(reference result, port result) of one set, computed once."""
    if name not in _PAIRS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # think-time latch
            _PAIRS[name] = PARITY_SETS[name]()
    return _PAIRS[name]


@pytest.fixture
def pair(request):
    return _pair_of(request.param)


@pytest.mark.parametrize("pair", sorted(PARITY_SETS), indirect=True)
def test_numeric_parity_summaries(pair):
    ref, port = pair
    assert (port.n_arms, port.n_seeds, port.n_steps) == (ref.n_arms, ref.n_seeds, ref.n_steps)
    assert sorted(port.summary) == sorted(ref.summary)
    for k, want in ref.summary.items():
        got = port.summary[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k in INT_SUMMARIES:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=k)


def _assert_rows_close(got, want, horizon, what):
    """Within RTOL, or ULPS f32 ulps of the lane's horizon; non-finite
    entries equal."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    ulp = np.spacing(np.abs(horizon.astype(np.float32)))
    atol = np.broadcast_to((ULPS * ulp).reshape(ulp.shape + (1,) * (want.ndim - 2)), want.shape)
    bad = fin & ~(np.abs(got - want) <= RTOL * np.abs(want) + atol)
    assert not bad.any(), (what, np.argwhere(bad)[:3], got[bad][:3], want[bad][:3])


@pytest.mark.parametrize("pair", sorted(PARITY_SETS), indirect=True)
def test_numeric_parity_rows(pair):
    ref, port = pair
    assert sorted(port.requests) == sorted(ref.requests)
    for k, want in ref.requests.items():
        got = port.requests[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            _assert_rows_close(got, want, ref.summary["horizon_ms"], k)


def test_parity_sets_exercise_their_paths():
    """The numeric sets reach what they are meant to: retries, adaptive
    thresholds, defers and drops."""
    _, single = _pair_of("single")
    assert single.requests["retries"].max() > 0
    _, adm = _pair_of("open_admission")
    assert adm.summary["n_deferred"][0].sum() > 0 and adm.summary["n_dropped"][1].sum() > 0


# ---------------------------------------------------------------------------
# Statistical parity on the port's own draws (CPU generator)
# ---------------------------------------------------------------------------

N_REQUESTS = 600
EVENT_SEEDS = range(10)
VEC_SEEDS = range(20)
# cells where the reference meets its own bounds; its adaptive-gcf-gen1 pass
# rate misses 2pp, so the adaptive cell is lambda's
CLOSED_CELLS = (("gcf-gen1", "off"), ("gcf-gen1", "fixed"), ("lambda", "off"),
                ("lambda", "adaptive"))


def _event_closed(pname, gate, seeds=EVENT_SEEDS, n_vus=1, profile=None):
    an, lat, nterm, nprobe = [], [], 0, 0
    for seed in seeds:
        plat = FaaSPlatform(SPEC, VM, _policy(gate), seed=seed,
                            profile=profile or _profile(pname))
        rs = TV.run_event_chain(plat, N_REQUESTS, THINK_MS, n_vus=n_vus)
        an += [r.analysis_ms for r in rs]
        lat += [r.latency_ms for r in rs]
        nterm += plat.instances_terminated
        nprobe += len(plat.benchmark_observations)
    return {"analysis": np.asarray(an), "latency": np.asarray(lat),
            "pass_rate": 1.0 - nterm / max(nprobe, 1)}


@pytest.fixture(scope="module")
def closed_runs():
    event = {cell: _event_closed(*cell) for cell in CLOSED_CELLS}
    vec = {}
    for cells in (CLOSED_CELLS[:3], CLOSED_CELLS[3:]):  # the adaptive arm alone
        res = TV.simulate_arms(TV.stack_arms([_arm(_profile(p), g) for p, g in cells]),
                               seeds=VEC_SEEDS, n_steps=N_REQUESTS, collect_requests=True,
                               device="cpu")
        for i, cell in enumerate(cells):
            vec[cell] = {"analysis": res.requests["analysis_ms"][i].ravel(),
                         "latency": res.requests["latency_ms"][i].ravel(),
                         "pass_rate": float(res.summary["pass_rate"][i].mean())}
    return event, vec


@pytest.mark.parametrize("cell", CLOSED_CELLS, ids=lambda c: "-".join(c))
def test_closed_ks_duration_distributions(closed_runs, cell):
    event, vec = closed_runs
    for field in ("analysis", "latency"):
        ks = ks_2samp(event[cell][field], vec[cell][field])
        assert ks.statistic < 0.05, (cell, field, ks)


@pytest.mark.parametrize("cell", [c for c in CLOSED_CELLS if c[1] != "off"],
                         ids=lambda c: "-".join(c))
def test_closed_pass_rate_within_2pp(closed_runs, cell):
    event, vec = closed_runs
    d = abs(event[cell]["pass_rate"] - vec[cell]["pass_rate"])
    assert d < 0.02, (cell, event[cell]["pass_rate"], vec[cell]["pass_rate"])


@pytest.mark.parametrize("cell", [c for c in CLOSED_CELLS if c[1] != "off"],
                         ids=lambda c: "-".join(c))
def test_closed_speedup_within_1pp(closed_runs, cell):
    event, vec = closed_runs
    base = (cell[0], "off")
    imp_ev = 1.0 - event[cell]["analysis"].mean() / event[base]["analysis"].mean()
    imp_vec = 1.0 - vec[cell]["analysis"].mean() / vec[base]["analysis"].mean()
    assert abs(imp_ev - imp_vec) < 0.01, (cell, imp_ev, imp_vec)


LA_N_VUS = 8
LA_EVENT_SEEDS = range(60)
LA_VEC_SEEDS = range(64)


@pytest.fixture(scope="module")
def loaded_runs():
    """gcf-gen2-loaded (concurrency 4, alpha 0.6, load-aware gate) at 8
    streams, both engines, gate off vs fixed. The reference misses its own
    2pp pass-rate bound here, so only KS and speedup are held."""
    prof = _loaded()
    event = {g: _event_closed(None, g, LA_EVENT_SEEDS, LA_N_VUS, prof) for g in ("off", "fixed")}
    res = TV.simulate_arms(TV.stack_arms([_arm(prof, g) for g in ("off", "fixed")]),
                           seeds=LA_VEC_SEEDS, n_steps=N_REQUESTS, n_streams=LA_N_VUS,
                           collect_requests=True, device="cpu")
    vec = {}
    for i, g in enumerate(("off", "fixed")):
        comp = res.requests["completed"][i]
        vec[g] = {"analysis": res.requests["analysis_ms"][i][comp],
                  "latency": res.requests["latency_ms"][i][comp]}
    return event, vec


@pytest.mark.parametrize("gate", ("off", "fixed"))
def test_loaded_ks_distributions(loaded_runs, gate):
    event, vec = loaded_runs
    for field in ("analysis", "latency"):
        ks = ks_2samp(event[gate][field], vec[gate][field])
        assert ks.statistic < 0.06, (gate, field, ks)


def test_loaded_speedup_within_1pp(loaded_runs):
    event, vec = loaded_runs
    imp_ev = 1.0 - event["fixed"]["analysis"].mean() / event["off"]["analysis"].mean()
    imp_vec = 1.0 - vec["fixed"]["analysis"].mean() / vec["off"]["analysis"].mean()
    assert abs(imp_ev - imp_vec) < 0.01, (imp_ev, imp_vec)


OPEN_RATE_PER_S = 0.9
OPEN_SERVERS = 4
OPEN_DURATION_MS = 400_000.0
OPEN_STEPS = 360
OPEN_EVENT_SEEDS = range(8)
OPEN_VEC_SEEDS = range(16)
OPEN_GATES = ("off", "fixed")


@pytest.fixture(scope="module")
def open_runs():
    event = {}
    for gate in OPEN_GATES:
        lat = []
        for seed in OPEN_EVENT_SEEDS:
            prof = _profile("gcf-gen1")
            knobs = dataclasses.replace(prof.knobs(), max_instances=OPEN_SERVERS)
            plat = FaaSPlatform(SPEC, VM, _policy(gate), seed=seed, profile=prof, knobs=knobs)
            run = run_open_loop(plat, PoissonProcess(OPEN_RATE_PER_S),
                                rng=np.random.RandomState(1000 + seed),
                                duration_ms=OPEN_DURATION_MS)
            lat += [r.latency_ms for r in run.results]
        event[gate] = np.asarray(lat)
    res = TV.simulate_open_arms(
        TV.stack_arms([_arm(_profile("gcf-gen1"), g, think_time_ms=0.0) for g in OPEN_GATES]),
        seeds=OPEN_VEC_SEEDS, iats_ms=_iats(OPEN_STEPS, OPEN_VEC_SEEDS),
        n_servers=OPEN_SERVERS, collect_requests=True, device="cpu")
    vec = {g: res.requests["latency_ms"][i][res.requests["completed"][i]]
           for i, g in enumerate(OPEN_GATES)}
    return event, vec


@pytest.mark.parametrize("gate", OPEN_GATES)
def test_open_loop_ks_latency(open_runs, gate):
    event, vec = open_runs
    ks = ks_2samp(event[gate], vec[gate])
    assert ks.statistic < 0.06, (gate, ks)


@pytest.mark.parametrize("gate", OPEN_GATES)
def test_open_loop_p99(open_runs, gate):
    event, vec = open_runs
    p99_ev = float(np.percentile(event[gate], 99))
    p99_v = float(np.percentile(vec[gate], 99))
    assert abs(p99_v - p99_ev) / p99_ev < 0.05, (gate, p99_ev, p99_v)


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


def _gen1(gate="fixed", **kw):
    return TV.stack_arms([_arm(_profile("gcf-gen1"), gate, **kw)])


def test_runner_cache_hits_on_same_shape():
    arms = TV.stack_arms([_arm(_profile("gcf-gen1"), g) for g in GATES])
    TV.simulate_arms(arms, seeds=range(2), n_steps=50, device="cpu")
    before = dict(TV.jit_stats)
    TV.simulate_arms(arms, seeds=range(2), n_steps=50, device="cpu")
    assert TV.jit_stats["compiles"] == before["compiles"]
    assert TV.jit_stats["calls"] == before["calls"] + 1
    # another shape builds another runner
    TV.simulate_arms(arms, seeds=range(3), n_steps=50, device="cpu")
    assert TV.jit_stats["compiles"] == before["compiles"] + 1


@pytest.mark.parametrize("kind", ["closed", "multi", "open"])
def test_seeded_determinism(kind):
    """Identical (arms, seeds) give bitwise identical summaries and rows."""
    if kind == "open":
        def run():
            return TV.simulate_open_arms(_gen1(think_time_ms=0.0), seeds=[5],
                                         iats_ms=_iats(40, [5], rate=2.0), n_servers=2,
                                         collect_requests=True, device="cpu")
    else:
        def run():
            return TV.simulate_arms(_gen1(), seeds=[7], n_steps=80,
                                    n_streams=4 if kind == "multi" else 1,
                                    collect_requests=True, device="cpu")
    a, b = run(), run()
    for k in a.summary:
        np.testing.assert_array_equal(a.summary[k], b.summary[k])
    for k in a.requests:
        np.testing.assert_array_equal(a.requests[k], b.requests[k])


@pytest.mark.parametrize("kind", ["closed", "open"])
def test_lane_alone_equals_lane_in_batch(kind):
    """A lane's draws depend only on (seed, arm index), so its result does
    not change with the batch it runs in (the lone arm keeps index 0; its
    seed sits second in the batch)."""
    arms = TV.stack_arms([_arm(_profile(p), "fixed", think_time_ms=0.0 if kind == "open" else THINK_MS)
                          for p in PROFILES])
    alone = TV.stack_arms([TV.ArmParams(*[np.asarray(x)[0] for x in arms])])
    if kind == "open":
        seeds = [11, 3, 12]
        iats = _iats(60, seeds)

        def run(a, s, it):
            return TV.simulate_open_arms(a, seeds=s, iats_ms=it, n_servers=2, device="cpu")
        batch, one = run(arms, seeds, iats), run(alone, [3], iats[1:2])
    else:
        batch = TV.simulate_arms(arms, seeds=[11, 3, 12], n_steps=60, device="cpu")
        one = TV.simulate_arms(alone, seeds=[3], n_steps=60, device="cpu")
    for k in one.summary:
        np.testing.assert_array_equal(one.summary[k][0, 0], batch.summary[k][0, 1], err_msg=k)
    # and another seed or arm gives another lane
    lat = batch.summary["mean_latency_ms"]
    assert lat[0, 1] != lat[0, 0] and lat[0, 1] != lat[1, 1]


@pytest.mark.parametrize("variant", ["defer", "drop", "unbounded"])
def test_open_loop_conserves_per_seed(variant):
    """completed + dropped + parked-at-end == arrivals, per seed, exactly;
    the admission knobs defer and drop as the reference's tests expect."""
    kw = {"defer": dict(admit_bound=4.0), "drop": {}, "unbounded": {}}[variant]
    arm = _arm(_profile("gcf-gen1"), "fixed", think_time_ms=0.0, **kw)
    if variant == "drop":
        arm = arm._replace(queue_capacity=3.0)
    seeds = range(6)
    res = TV.simulate_open_arms(TV.stack_arms([arm]), seeds=seeds, iats_ms=_iats(240, seeds),
                                n_servers=4 if variant == "unbounded" else 2,
                                collect_requests=True, device="cpu")
    s = {k: v[0] for k, v in res.summary.items()}
    np.testing.assert_array_equal(s["n_requests"], s["n_completed"] + s["n_dropped"]
                                  + s["n_parked_end"])
    comp = res.requests["completed"][0]
    dropped, deferred = res.requests["dropped"][0], res.requests["deferred"][0]
    assert not np.any(comp & (deferred | dropped))
    assert dropped.sum() == s["n_dropped"].sum() and deferred.sum() == s["n_deferred"].sum()
    if variant == "defer":
        assert s["n_deferred"].sum() > 0 and s["n_dropped"].sum() == 0
    elif variant == "drop":
        assert s["n_dropped"].sum() > 0
    else:
        assert s["n_deferred"].sum() == 0 and s["n_dropped"].sum() == 0


@pytest.mark.parametrize("order", ["lifo", "fifo", "spread"])
@pytest.mark.parametrize("concurrency", [1, 4])
def test_slot_loads_equal_replay(order, concurrency):
    """The reference's O(n) replay of the take/release stream
    (``_replay_slot_loads``) holds on the port's multi-stream rows."""
    arms = TV.stack_arms([_arm(_loaded(concurrency=concurrency, alpha=0.6), g)
                          ._replace(order=TV.ORDER_CODES[order]) for g in ("off", "fixed")])
    res = TV.simulate_arms(arms, seeds=range(3), n_steps=400, n_streams=4,
                           collect_requests=True, device="cpu")
    total = 0
    for a in range(res.n_arms):
        for s in range(res.n_seeds):
            total += _replay_slot_loads({k: v[a][s] for k, v in res.requests.items()},
                                        concurrency)
    assert total > 0


def test_open_think_time_warns_once_per_process(monkeypatch):
    monkeypatch.setattr(TV, "_OPEN_THINK_WARNED", False)
    arm = _gen1(think_time_ms=750.0)
    iats = _iats(20, [0])

    def run(a):
        TV.simulate_open_arms(a, seeds=[0], iats_ms=iats, n_servers=2, device="cpu")

    with pytest.warns(UserWarning, match="think_time_ms"):
        run(arm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # second call must stay silent
        run(arm)
    monkeypatch.setattr(TV, "_OPEN_THINK_WARNED", False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # zero think time never warns
        run(_gen1(think_time_ms=0.0))


def test_argument_checks_raise():
    arms = _gen1()
    with pytest.raises(ValueError, match="pool_size"):
        TV.simulate_arms(arms, seeds=[0], n_steps=10, n_streams=4, pool_size=2, device="cpu")
    with pytest.raises(ValueError, match="n_streams"):
        TV.simulate_arms(arms, seeds=[0], n_steps=10, n_streams=0, device="cpu")
    with pytest.raises(ValueError, match="max_attempts"):
        TV.simulate_arms(arms, seeds=[0], n_steps=10, max_attempts=3, device="cpu")
    with pytest.raises(ValueError, match="max_attempts"):
        TV.simulate_open_arms(_gen1(think_time_ms=0.0), seeds=[0], iats_ms=_iats(10, [0]),
                              max_attempts=2, device="cpu")
    with pytest.raises(ValueError, match="queue_ring"):
        TV.simulate_open_arms(TV.stack_arms([_arm(_profile("gcf-gen1"), "fixed",
                                                  think_time_ms=0.0)._replace(queue_capacity=99.0)]),
                              seeds=[0], iats_ms=_iats(10, [0]), device="cpu")
    with pytest.raises(ValueError, match="iats_ms"):
        TV.simulate_open_arms(_gen1(think_time_ms=0.0), seeds=[0, 1], iats_ms=_iats(10, [0]),
                              device="cpu")
    with pytest.raises(ValueError, match="draws"):
        TV._simulate_arms(arms, seeds=[0], n_steps=10, device="cpu",
                          draws=(np.zeros((1, 1, 10, 8), np.float32), np.zeros((1, 1, 10), np.float32)))


def test_sanitizer_guards_summaries(monkeypatch):
    monkeypatch.setenv(t_sanitizer.ENV_VAR, "1")
    res = TV.simulate_arms(_gen1("off"), seeds=[0], n_steps=64, pool_size=4, device="cpu")
    assert np.isfinite(res.summary["mean_latency_ms"]).all()
    TV.simulate_open_arms(_gen1(think_time_ms=0.0), seeds=[0, 1], iats_ms=_iats(64, [0, 1]),
                          n_servers=2, device="cpu")
    # a zero benchmark makes log-probe moments -inf: the guard must fire
    broken = TV.stack_arms([_arm(_profile("gcf-gen1"), "fixed")._replace(benchmark_ms=0.0)])
    with pytest.raises(t_sanitizer.SanitizerError, match="non-finite"):
        TV.simulate_arms(broken, seeds=[0], n_steps=32, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """With no device the lanes run on the card; where there is none that
    raises instead of running quietly on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.simulate_arms(_gen1(), seeds=[0], n_steps=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.simulate_open_arms(_gen1(think_time_ms=0.0), seeds=[0], iats_ms=_iats(10, [0]))
