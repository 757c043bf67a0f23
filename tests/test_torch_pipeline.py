"""The port's ASR→LLM serving pipeline (``repro_torch.serving.pipeline``)
against ``repro.serving.pipeline``: the ``--smoke`` setting of
``benchmarks/pipeline_sweep.py`` run through both packages.

The sweep's source is exec'd with its imports pointed at each package (as
``test_torch_fleet.py`` runs the fleet sweeps). ``build_asr_llm_pipeline``
draws each stage's weights from ``seed``, and ``Model.init(seed)`` draws other
values than ``jax.random``; so the port's builds run with ``device="cpu"``
and then take the weights of the reference's matching build, stage by stage
(``load_jax_params``). Then rows, headline and every item of every arm (each
stage's result: timings, retries, replica speed and tokens) must be EXACTLY
equal: the gate is simulated from the same numpy draws, and the f32 smoke
models give identical greedy tokens.

``--smoke --load-aware`` and ``--smoke --controllers`` run in
``test_torch_pipeline_load_aware.py`` and ``test_torch_pipeline_controllers.py``,
one file each, so that each gets a worker of its own.
"""
import _torch_cpu  # noqa: F401
import contextlib

import jax
import numpy as np
import torch

from repro_torch.models.convert import load_jax_params
from test_torch_fleet import _sweep_module
from test_torch_sim import _assert_same

SWEEP = "pipeline_sweep"


def run_sweep(package: str, fn: str, ref_builds=None, spec=None, **kwargs):
    """``fn(**kwargs)`` of the sweep through ``package``, with
    ``spec=PipelineSpec(**spec)`` of that package where ``spec`` is given.
    Returns (its result, the stage backends of every pipeline build, every
    ``run_workflow_batch`` result). For the port, ``ref_builds`` are the
    reference run's builds, whose weights the port's builds take in order."""
    mod = _sweep_module(SWEEP, package)
    if spec is not None:
        kwargs["spec"] = mod.PipelineSpec(**spec)
    assert mod.build_asr_llm_pipeline.__module__ == f"{package}.serving.pipeline"
    build, run_batch = mod.build_asr_llm_pipeline, mod.run_workflow_batch
    builds, runs = [], []

    def building(spec, *, seed=0, variation=None):
        if ref_builds is None:
            dag, backends = build(spec, seed=seed, variation=variation)
        else:
            dag, backends = build(spec, seed=seed, variation=variation, device="cpu")
            for name, be in backends.items():
                ref = ref_builds[len(builds)][name]
                load_jax_params(be.params, jax.tree_util.tree_map(np.asarray, ref.params))
        builds.append(backends)
        return dag, backends

    def keeping(engine, **kw):
        run = run_batch(engine, **kw)
        runs.append(run)
        return run

    mod.build_asr_llm_pipeline, mod.run_workflow_batch = building, keeping
    return getattr(mod, fn)(**kwargs), builds, runs


@contextlib.contextmanager
def one_torch_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them as fast
    as many, and leaves no spinning thread pool to slow the JAX run beside
    them (or the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_both(fn: str, **kwargs):
    """The sweep's ``fn(**kwargs)`` through the reference, then the port;
    checks that every run's items are equal. Returns ((result, builds) of
    the reference, of the port)."""
    ref, ref_builds, ref_runs = run_sweep("repro", fn, **kwargs)
    with one_torch_thread():
        port, port_builds, port_runs = run_sweep("repro_torch", fn, ref_builds, **kwargs)
    assert len(port_runs) == len(ref_runs) > 0
    for t_run, j_run in zip(port_runs, ref_runs):
        assert t_run.n_items == j_run.n_items > 0
        key = lambda it: it.item_id  # noqa: E731
        _assert_same(sorted(t_run.items, key=key), sorted(j_run.items, key=key))
        assert all(it.stage_results["llm"].output.dtype == np.int32 for it in t_run.items)
    for t_b, j_b in zip(port_builds, ref_builds):
        for name in ("asr", "llm"):
            assert t_b[name].jit_stats == j_b[name].jit_stats
    return (ref, ref_builds), (port, port_builds)


def test_pipeline_smoke_equals_reference():
    """The ``--smoke`` arm of ``pipeline_sweep.main``: 4 items, three gate
    arms, whisper → llama at smoke size; outputs identical across arms (the
    sweep asserts it) and equal to the reference's, item by item."""
    (ref, _), (port, _) = run_both(
        "pipeline_sweep", quick=True, n_items=4, seeds=(3,),
        spec=dict(transcript_tokens=3, answer_tokens=4, max_pool=3))
    ref_rows, ref_head, ref_agg, _ = ref
    port_rows, port_head, port_agg, port_backends = port
    assert port_rows == ref_rows
    assert port_head == ref_head
    assert port_agg == ref_agg
    assert port_backends["asr"].cfg.family == "encdec"
    assert port_backends["asr"].device.type == "cpu"
    assert port_backends["llm"].jit_stats["eager_calls"] == 0
