"""The port's Minos serving engine against ``repro``'s on the same seeds.

The gate is simulated in both packages from the same numpy RNG draws, so
replica starts and terminations, probe observations, pool speeds, retries,
simulated durations and latencies, and cost are EXACTLY equal. The port's
weights are loaded from the JAX engine's params (``load_jax_params``), so the
greedy tokens are identical too (f32 smoke configs on the CPU).

Also the port's counterparts of test_serving_jit.py: bucketing, eager ==
bucketed tokens, batch and decode-bucket padding leave tokens unchanged, and
the ``jit_stats`` bookkeeping.
"""
import _torch_cpu  # noqa: F401
import jax
import numpy as np
import pytest
import torch

import repro.core.control as jctl
import repro.core.cost as jcost
import repro.core.policy as jpol
import repro.serving.engine as jeng
import repro_torch.core.control as tctl
import repro_torch.core.cost as tcost
import repro_torch.core.policy as tpol
import repro_torch.serving.engine as teng
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.lifecycle import FunctionInstance
from repro_torch.models.convert import load_jax_params
from repro_torch.serving.backend import ModelServingBackend, ServeRequest, _bucket


def _requests(cls, vocab, n=8, prompt_len=12, new_tokens=5):
    rs = np.random.RandomState(11)
    return [cls(prompt=rs.randint(0, vocab, size=prompt_len).astype(np.int32),
                max_new_tokens=new_tokens, request_id=i) for i in range(n)]


def _policy(pol, ctl, case):
    """(policy, controller) for one case, built from one package's modules."""
    if case == "classic":
        return pol.MinosPolicy(elysium_threshold=180.0, max_retries=5), None
    if case == "adaptive":
        return pol.AdaptiveMinosPolicy(0.4, max_retries=5), None
    if case == "reprobe":
        inner = ctl.ClassicMinosController(pol.MinosPolicy(elysium_threshold=180.0,
                                                           max_retries=5))
        return None, ctl.ReprobeController(inner, max_uses_since_probe=2)
    raise ValueError(case)


def _serve_both(arch, case, **knobs):
    jpolicy, jctrl = _policy(jpol, jctl, case)
    tpolicy, tctrl = _policy(tpol, tctl, case)
    je = jeng.MinosServingEngine(jax_smoke_config(arch), jpolicy, jcost.Pricing.tpu_chip_seconds(4),
                                 seed=5, max_pool=3, controller=jctrl, **knobs)
    te = teng.MinosServingEngine(get_smoke_config(arch), tpolicy, tcost.Pricing.tpu_chip_seconds(4),
                                 seed=5, max_pool=3, controller=tctrl, device="cpu", **knobs)
    load_jax_params(te.params, jax.tree_util.tree_map(np.asarray, je.params))
    vocab = je.cfg.vocab
    jres = je.serve(_requests(jeng.ServeRequest, vocab))
    tres = te.serve(_requests(teng.ServeRequest, vocab))
    return je, te, jres, tres


def _assert_identical(je, te, jres, tres):
    assert te.instances_started == je.instances_started
    assert te.instances_terminated == je.instances_terminated
    assert te.benchmark_observations == je.benchmark_observations
    assert te.warm_pool_speeds == je.warm_pool_speeds
    assert te.cost.total == je.cost.total
    assert len(tres) == len(jres)
    for a, b in zip(jres, tres):
        assert b.request_id == a.request_id
        assert b.retries == a.retries
        assert b.sim_duration_ms == a.sim_duration_ms
        assert b.latency_ms == a.latency_ms
        assert b.replica_speed == a.replica_speed
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert b.tokens.dtype == np.int32


@pytest.mark.parametrize("case,knobs,arch", [
    pytest.param("classic", {}, "llama3.2-1b", id="classic-knobs0"),
    pytest.param("adaptive", {}, "llama3.2-1b", id="adaptive-knobs1"),
    pytest.param("reprobe", {"contention_rho": 0.9}, "llama3.2-1b", id="reprobe-knobs2"),
    pytest.param("classic", {}, "granite-moe-1b-a400m", id="classic-granite-moe"),
    pytest.param("classic", {}, "zamba2-1.2b", id="classic-zamba2"),
    pytest.param("adaptive", {}, "xlstm-1.3b", id="adaptive-xlstm"),
])
def test_engine_matches_reference_exactly(case, knobs, arch):
    je, te, jres, tres = _serve_both(arch, case, **knobs)
    _assert_identical(je, te, jres, tres)
    assert te.jit_stats == je.jit_stats


def test_engine_matches_reference_under_sanitizer(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    je, te, jres, tres = _serve_both("qwen3-0.6b", "classic")
    _assert_identical(je, te, jres, tres)
    assert te.jit_stats == je.jit_stats


# ---------------------------------------------------------------------------
# the bucketed decode path (test_serving_jit.py's counterparts)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_backend():
    return ModelServingBackend(get_smoke_config("llama3.2-1b"), seed=0, device="cpu")


def test_bucket_rounding():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert _bucket(3, base=8) == 8
    with pytest.raises(ValueError):
        _bucket(0)


def test_bucketed_tokens_equal_eager_tokens(dense_backend):
    req = ServeRequest(prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=5)
    eager = dense_backend.run_model(req, mode="eager")
    bucketed = dense_backend.run_model(req, mode="jit")
    np.testing.assert_array_equal(eager, bucketed)
    assert bucketed.dtype == np.int32 and bucketed.shape == (5,)


def test_batched_streams_do_not_change_tokens(dense_backend):
    req = ServeRequest(prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
    solo = dense_backend.run_model(req, load=1)
    for load in (2, 3, 4):
        np.testing.assert_array_equal(solo, dense_backend.run_model(req, load=load))


def test_decode_bucket_padding_preserves_prefix(dense_backend):
    prompt = np.arange(1, 5, dtype=np.int32)
    long = dense_backend.run_model(ServeRequest(prompt=prompt, max_new_tokens=8))
    for t in (2, 5, 7):
        short = dense_backend.run_model(ServeRequest(prompt=prompt, max_new_tokens=t))
        np.testing.assert_array_equal(short, long[:t])


def test_jit_stats_count_buckets_and_guard_eager():
    be = ModelServingBackend(get_smoke_config("llama3.2-1b"), seed=0, device="cpu")
    req = ServeRequest(prompt=np.arange(4, dtype=np.int32), max_new_tokens=4)
    be.run_model(req)
    assert be.jit_stats == {"jit_calls": 1, "eager_calls": 0, "bucket_compiles": 1}
    be.run_model(req)                       # same bucket
    assert be.jit_stats["bucket_compiles"] == 1
    be.run_model(req, load=2)               # new batch bucket
    assert be.jit_stats["bucket_compiles"] == 2
    be.run_model(req, mode="eager")
    assert be.jit_stats["eager_calls"] == 1


def test_body_duration_is_work_over_speed(dense_backend):
    inst = FunctionInstance(speed_factor=2.0)
    req = ServeRequest(prompt=np.arange(6, dtype=np.int32), max_new_tokens=4)
    dur, toks = dense_backend.body(req, inst, np.random.RandomState(0), load=2)
    work = dense_backend.c_prefill * 6 + dense_backend.c_decode * 4
    assert dur == pytest.approx(work / 2.0)
    assert len(toks) == 4


def test_time_model_and_calibration_run(dense_backend):
    req = ServeRequest(prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)
    assert dense_backend.time_model_ms(req, mode="jit") > 0.0
    alpha = dense_backend.calibrate_load_slowdown(loads=(1, 2), max_new_tokens=2, repeats=1)
    assert isinstance(alpha, float) and alpha >= 0.0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_back_to_back_requests_on_the_bucketed_path_equal_a_fresh_cache_each(arch):
    """Requests served one after another on the backend's reused static
    cache (the recurrent state of the one before left in it, then noise)
    give the tokens each gives alone from a fresh ``init_cache``, as the
    reference serves every request."""
    be = ModelServingBackend(get_smoke_config(arch), seed=3, device="cpu")
    rs = np.random.RandomState(5)
    reqs = [ServeRequest(prompt=rs.randint(0, be.cfg.vocab, size=s).astype(np.int32),
                         max_new_tokens=6) for s in (20, 11, 23)]
    Tb = _bucket(6, base=be.decode_bucket)
    cache_len = _bucket(20 + Tb, base=be.decode_bucket)
    assert all(_bucket(len(r.prompt) + Tb, base=be.decode_bucket) == cache_len for r in reqs)

    def fresh(req):
        m, p = be.model, be.params
        cache = m.init_cache(1, cache_len)
        prompt = torch.tensor(req.prompt)[None]
        m.prefill(p, {"tokens": prompt}, cache)
        return m.decode_tokens(p, cache, prompt[:, -1:], Tb)[0][0, :req.max_new_tokens].numpy()

    static = be.model.static_cache(1, cache_len)
    for i, req in enumerate(reqs):
        if i == 2:
            gen = torch.Generator().manual_seed(0)
            for name, t in static.items():
                if t.is_floating_point():
                    t.copy_(100 * torch.randn(t.shape, generator=gen))
        np.testing.assert_array_equal(be.run_model(req), fresh(req))
    assert be.model.static_cache(1, cache_len) is static
    np.testing.assert_array_equal(be.run_model(reqs[0], mode="eager"), fresh(reqs[0]))


def test_decode_mode_validated():
    with pytest.raises(ValueError, match="decode_mode"):
        ModelServingBackend(get_smoke_config("llama3.2-1b"), seed=0, device="cpu",
                            decode_mode="magic")
