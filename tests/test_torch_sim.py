"""The port's event-driven simulator against ``repro``'s on the same seeds.

``repro_torch.sim``'s platform, workload, metrics, experiment, arrivals and
workflow modules are copies of ``repro.sim``'s (``test_torch_isolation.py``
checks the bytes) and draw only numpy randomness, so every run here must
come out EXACTLY equal in both packages: the golden digests of
``test_unified_substrate.py``, closed-loop, open-loop and workflow runs
request by request, and the paper's day experiment.
"""
import _torch_cpu  # noqa: F401
import dataclasses

import numpy as np
import pytest

import repro.core.control as jctl
import repro.core.cost as jcost
import repro.core.policy as jpol
import repro.sim as jsim
import repro_torch.core.control as tctl
import repro_torch.core.cost as tcost
import repro_torch.core.policy as tpol
import repro_torch.sim as tsim
from test_unified_substrate import _GOLDEN

# (sim, policy, control, cost) modules of one package
JAX_PKG = (jsim, jpol, jctl, jcost)
PORT_PKG = (tsim, tpol, tctl, tcost)


def _golden_case(pkg, case):
    """The spec, profile, policy and seed of one golden case of
    test_unified_substrate.py, built from one package's classes."""
    sim, pol, _, _ = pkg
    if case == "gen1-fixed":
        return sim.PlatformProfile.gcf_gen1(), pol.MinosPolicy(elysium_threshold=200.0, max_retries=4), 7
    if case == "gen2-fixed":
        return sim.PlatformProfile.gcf_gen2(), pol.MinosPolicy(elysium_threshold=210.0, max_retries=4), 11
    if case == "lambda-adaptive":
        return sim.PlatformProfile.aws_lambda(), pol.AdaptiveMinosPolicy(0.4, max_retries=5), 13
    if case == "gen1-disabled":
        return sim.PlatformProfile.gcf_gen1(), pol.MinosPolicy(elysium_threshold=0.0, enabled=False), 7
    raise ValueError(case)


def _canon(x):
    """A value with its classes reduced to their names, for comparing runs of
    the two packages: dataclasses become (name, fields), arrays lists, dicts
    sorted items. ``repr`` of the result is exact for floats (NaN included)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple(_canon(getattr(x, f.name)) for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return tuple((k, _canon(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return _canon(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _assert_same(port, ref):
    assert repr(_canon(port)) == repr(_canon(ref))


def _golden_run(pkg, case):
    sim = pkg[0]
    spec = sim.FunctionSpec(
        name="golden", prepare_ms=400.0, body_ms=900.0, benchmark_ms=200.0,
        cold_start_ms=120.0, recycle_lifetime_ms=30_000.0, contention_rho=0.97,
        benchmark_noise=0.06,
    )
    vm = sim.VariationModel(sigma=0.18, diurnal_amplitude=0.05)
    profile, policy, seed = _golden_case(pkg, case)
    plat = sim.FaaSPlatform(spec, vm, policy, seed=seed, profile=profile)
    res = sim.run_closed_loop(plat, n_vus=6, think_time_ms=800.0, duration_ms=90_000.0)
    digest = (len(res),
              round(sum(r.latency_ms for r in res), 4),
              round(sum(r.analysis_ms for r in res), 4),
              round(sum(r.download_ms for r in res), 4),
              sum(r.retries for r in res),
              sum(1 for r in res if r.served_by_cold),
              round(sum(r.instance_speed for r in res), 6),
              plat.instances_started, plat.instances_terminated,
              round(plat.cost.total * 1e6, 6),
              round(sum(plat.benchmark_observations), 4),
              len(plat.warm_pool_speeds),
              round(sum(plat.warm_pool_speeds), 6))
    return (digest, [round(r.latency_ms, 6) for r in res[:5]]), res


@pytest.mark.parametrize("case", sorted(_GOLDEN))
def test_faas_platform_golden_digest_equals_reference(case):
    ref_digest, ref_res = _golden_run(JAX_PKG, case)
    port_digest, port_res = _golden_run(PORT_PKG, case)
    assert port_digest == _GOLDEN[case]
    assert port_digest == ref_digest
    _assert_same(port_res, ref_res)


def _workflow_closed_loop(pkg):
    sim = pkg[0]
    vm = sim.VariationModel(sigma=0.15)
    prof = sim.PlatformProfile.gcf_gen1()
    eng = sim.WorkflowEngine(sim.etl_chain(3), vm,
                             sim.workflow_arm_factory("fixed", vm, pricing=prof.pricing),
                             profile=prof, seed=21)
    run = sim.run_workflow_closed_loop(eng, n_vus=5, duration_ms=120_000.0)
    digest = (run.n_items, run.n_items_costed,
              round(run.mean_item_latency_ms, 6),
              round(run.mean_item_analysis_ms, 6),
              eng.instances_started, eng.instances_terminated,
              round(eng.cost.total * 1e6, 6))
    return digest, run.items


def test_workflow_golden_equals_reference():
    ref_digest, ref_items = _workflow_closed_loop(JAX_PKG)
    port_digest, port_items = _workflow_closed_loop(PORT_PKG)
    assert port_digest == (118, 122, 4012.726521, 2107.16842, 62, 37, 2416.320648)
    assert port_digest == ref_digest
    _assert_same(port_items, ref_items)


# ---------------------------------------------------------------------------
# open loop: Poisson and MMPP arrivals through a finite queue, QoS classes,
# the gate or admission control; results equal request by request
# ---------------------------------------------------------------------------


def _open_loop(pkg, process_name, *, admission):
    sim, pol, ctl, _ = pkg
    spec = sim.FunctionSpec(
        name="openloop", prepare_ms=600.0, body_ms=1500.0, benchmark_ms=300.0,
        cold_start_ms=250.0, recycle_lifetime_ms=45_000.0, contention_rho=0.95,
        benchmark_noise=0.08,
    )
    profile = sim.PlatformProfile.gcf_gen1()
    knobs = dataclasses.replace(profile.knobs(), max_instances=4, queue_capacity=6)
    policy = pol.MinosPolicy(elysium_threshold=330.0, max_retries=4)
    if admission:
        ctrl = ctl.QueueAwareAdmissionController(ctl.ClassicMinosController(policy),
                                                 headroom=1.25, min_slots=2)
        plat = sim.FaaSPlatform(spec, sim.VariationModel(sigma=0.15), None, seed=3,
                                profile=profile, knobs=knobs, controller=ctrl)
    else:
        plat = sim.FaaSPlatform(spec, sim.VariationModel(sigma=0.15), policy, seed=3,
                                profile=profile, knobs=knobs)
    process = (sim.PoissonProcess(2.5) if process_name == "poisson" else
               sim.MMPPProcess(base_rate_per_s=0.5, burst_rate_per_s=4.0,
                               mean_off_ms=20_000.0, mean_on_ms=5_000.0))
    qos = (sim.QoSClass("gold", weight=1.0, slo_ms=6_000.0), sim.QoSClass("bronze", weight=2.0))
    run = sim.run_open_loop(plat, process, rng=np.random.RandomState(17),
                            duration_ms=90_000.0, qos_classes=qos)
    summary = sim.OpenLoopSummary.from_run(process_name, plat, run, qos_classes=qos)
    counts = (run.n_arrived, run.n_completed, run.n_dropped, run.n_defer_decisions,
              run.n_pending_at_end, plat.instances_started, plat.instances_terminated, plat.cost.total,
              run.mean_system_population())
    return counts, run, summary


@pytest.mark.parametrize("process", ["poisson", "mmpp"])
@pytest.mark.parametrize("admission", [False, True], ids=["gate", "admission"])
def test_open_loop_equals_reference_per_request(process, admission):
    ref = _open_loop(JAX_PKG, process, admission=admission)
    port = _open_loop(PORT_PKG, process, admission=admission)
    n_arrived, _, n_dropped, n_deferred = ref[0][:4]
    # the finite queue drops; admission defers instead
    assert n_arrived > 20 and (n_deferred if admission else n_dropped) > 0
    _assert_same(port, ref)


def test_open_loop_equals_reference_under_sanitizer(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    ref = _open_loop(JAX_PKG, "mmpp", admission=True)
    port = _open_loop(PORT_PKG, "mmpp", admission=True)
    _assert_same(port, ref)


def _workflow_open_loop(pkg, arm):
    sim = pkg[0]
    vm = sim.VariationModel(sigma=0.15)
    prof = sim.PlatformProfile.gcf_gen2()
    eng = sim.WorkflowEngine(sim.etl_chain(5), vm,
                             sim.workflow_arm_factory(arm, vm, pricing=prof.pricing),
                             profile=prof, seed=8)
    run = sim.run_workflow_open_loop(eng, sim.PoissonProcess(0.8),
                                     rng=np.random.RandomState(5), duration_ms=60_000.0)
    counts = (run.n_items, run.n_items_costed, eng.instances_started,
              eng.instances_terminated, eng.cost.total)
    return counts, run.items, sim.WorkflowSummary.from_run(arm, run)


@pytest.mark.parametrize("arm", ["disabled", "fixed", "adaptive"])
def test_workflow_open_loop_equals_reference_per_item(arm):
    ref = _workflow_open_loop(JAX_PKG, arm)
    port = _workflow_open_loop(PORT_PKG, arm)
    assert ref[0][0] > 10
    _assert_same(port, ref)


# ---------------------------------------------------------------------------
# the paper's day experiment and the chained-workflow workload
# ---------------------------------------------------------------------------


def _day(pkg):
    sim = pkg[0]
    week = sim.paper_week(seed=4, n_days=2)
    day = sim.run_day(1, week[1], n_vus=6, duration_ms=4 * 60 * 1000.0, seed=4,
                      include_adaptive=True)
    return (day, day.analysis_improvement, day.successful_requests_delta, day.cost_saving)


def test_run_day_equals_reference():
    ref, port = _day(JAX_PKG), _day(PORT_PKG)
    assert ref[0].minos.n_successful > 0 and ref[0].adaptive is not None
    _assert_same(port, ref)


def _chain(pkg):
    sim, pol, _, cost = pkg
    specs = [sim.FunctionSpec(name=f"s{i}", prepare_ms=300.0 + 100 * i, body_ms=700.0,
                              benchmark_ms=150.0, cold_start_ms=100.0, benchmark_noise=0.05)
             for i in range(3)]
    wf = sim.make_chain(specs, sim.VariationModel(sigma=0.2),
                        pol.MinosPolicy(elysium_threshold=160.0, max_retries=3),
                        cost.Pricing.gcf(256), seed=6)
    return sim.run_workflow(wf, n_items=12, inter_arrival_ms=400.0)


def test_chained_workload_equals_reference():
    ref = _chain(JAX_PKG)
    assert [len(stage) for stage in ref] == [12, 12, 12]
    _assert_same(_chain(PORT_PKG), ref)
