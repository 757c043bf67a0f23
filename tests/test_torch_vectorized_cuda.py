"""The vectorized Monte-Carlo path on the card: ``simulate_arms`` and
``simulate_open_arms`` with their step loops captured as CUDA graphs.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_vectorized_cuda.py

* The card against the CPU on shared draws (the port's CPU generator makes
  them, both devices run on them): integer summaries equal, float summaries
  and rows within rtol 1e-4 (the devices' ``exp``/``log``/``cos`` differ by
  an ulp), a float row also within 4 f32 ulps of its lane's horizon.
* The captured graphs against the same steps run op by op on the card:
  summaries and rows bitwise equal.
* A second call of the same shape captures nothing.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.sim.vectorized as TV
from repro_torch.sim import FunctionSpec, PlatformProfile, VariationModel
from repro_torch.sim.arrivals import PoissonProcess

pytestmark = pytest.mark.cuda

RTOL = 1e-4
ULPS = 4  # a float row may also differ by this many f32 ulps of the lane's horizon
INT_SUMMARIES = ("n_requests", "n_completed", "n_started", "n_terminated", "n_probes",
                 "n_dropped", "n_deferred", "n_parked_end", "bill_n")
SPEC = FunctionSpec(
    name="parity", prepare_ms=600.0, body_ms=1500.0, benchmark_ms=300.0,
    cold_start_ms=250.0, recycle_lifetime_ms=8_000.0, contention_rho=0.95,
    benchmark_noise=0.08,
)
VM = VariationModel(sigma=0.15)
THRESHOLD = SPEC.benchmark_ms * math.exp(
    stats.norm.ppf(0.4) * math.sqrt(VM.sigma ** 2 + SPEC.benchmark_noise ** 2))


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step loop runs only on the card")


def _profile(name):
    prof = {"gcf-gen1": PlatformProfile.gcf_gen1, "lambda": PlatformProfile.aws_lambda,
            "loaded": PlatformProfile.gcf_gen2_loaded}[name]()
    return dataclasses.replace(prof, recycle_lifetime_ms=8_000.0)


def _arms(pname, gates, think_time_ms=500.0):
    return TV.stack_arms([TV.arm_from_spec(SPEC, VM, profile=_profile(pname), gate=g,
                                           threshold=THRESHOLD, think_time_ms=think_time_ms)
                          for g in gates])


def _iats(n_steps, n_seeds):
    proc = PoissonProcess(0.9)
    return np.stack([proc.iats_ms(np.random.RandomState(5000 + i), n_steps)
                     for i in range(n_seeds)])


CASES = {
    "fixed": lambda **kw: TV._simulate_arms(_arms("gcf-gen1", ("off", "fixed")), seeds=range(4),
                                            n_steps=120, collect_requests=True, **kw),
    "adaptive": lambda **kw: TV._simulate_arms(_arms("lambda", ("fixed", "adaptive")),
                                               seeds=range(4), n_steps=120,
                                               collect_requests=True, **kw),
    "multi": lambda **kw: TV._simulate_arms(_arms("loaded", ("off", "fixed")), seeds=range(4),
                                            n_steps=120, n_streams=4, collect_requests=True,
                                            **kw),
    "open": lambda **kw: TV._simulate_open_arms(_arms("gcf-gen1", ("off", "fixed"), 0.0),
                                                seeds=range(4), iats_ms=_iats(120, 4),
                                                n_servers=2, collect_requests=True, **kw),
}


def _close(got, want, exact=False):
    for part in ("summary", "requests"):
        g, w = getattr(got, part), getattr(want, part)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if exact or w[k].dtype.kind in "biu" or k in INT_SUMMARIES:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            elif part == "summary":
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0, err_msg=k)
            else:  # a wait is the difference of two absolute times near the horizon
                ulp = np.spacing(np.abs(want.summary["horizon_ms"].astype(np.float32)))
                atol = (ULPS * ulp).reshape(ulp.shape + (1,) * (w[k].ndim - 2))
                fin = np.isfinite(w[k])
                np.testing.assert_array_equal(g[k][~fin], w[k][~fin], err_msg=k)
                assert (np.abs(g[k] - w[k]) <= RTOL * np.abs(w[k]) + atol)[fin].all(), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_matches_cpu_on_shared_draws(case):
    run = CASES[case]
    _close(run(device="cuda", draw_device="cpu"), run(device="cpu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_equals_eager_bitwise(case):
    run = CASES[case]
    _close(run(device="cuda"), run(device="cuda", eager=True), exact=True)


def test_second_call_of_a_shape_captures_nothing():
    run = CASES["fixed"]
    a = run(device="cuda")
    before = dict(TV.jit_stats)
    b = run(device="cuda")
    assert TV.jit_stats["compiles"] == before["compiles"]
    assert TV.jit_stats["calls"] == before["calls"] + 1
    _close(b, a, exact=True)


def test_default_device_is_the_card():
    res = TV.simulate_arms(_arms("gcf-gen1", ("fixed",)), seeds=[0], n_steps=60)
    want = TV.simulate_arms(_arms("gcf-gen1", ("fixed",)), seeds=[0], n_steps=60, device="cuda")
    for k in res.summary:
        np.testing.assert_array_equal(res.summary[k], want.summary[k])
