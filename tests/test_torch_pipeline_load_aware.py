"""``benchmarks/pipeline_sweep.py --smoke --load-aware`` through the port and
the reference (the machinery of ``test_torch_pipeline.py``).

``load_aware_sweep(smoke=True)`` runs ``pipeline_sweep`` with the spec and
arguments below, then three guards: (1) every body went through the bucketed
path, (2) the bucketed decode is at least 5x faster in wall time than the
eager one, (3) the fixed-gated arm beats the disabled one on body time. The
test runs the same ``pipeline_sweep`` call through both packages, holds rows,
headline and every item equal, and checks guards (1) and (3) on both. Guard
(2) is about wall-clock time on a compiled surface: the port has none on the
CPU (its ``decode_tokens`` there is the same loop as eager decode), so it is
not run here; ``chip_smoke.py`` times captured against eager serving on the
card.
"""
import _torch_cpu  # noqa: F401
from test_torch_pipeline import run_both

N_ITEMS = 200  # load_aware_sweep(smoke=True)
SPEC = dict(per_instance_concurrency=4, load_slowdown_alpha=0.6, gate_load_aware=True,
            transcript_tokens=3, answer_tokens=4, max_pool=3)


def test_pipeline_load_aware_smoke_equals_reference():
    (ref, _), (port, _) = run_both("pipeline_sweep", quick=True, n_items=N_ITEMS, seeds=(3,),
                                   spec=SPEC, inter_arrival_ms=50.0)
    assert port[:3] == ref[:3]  # rows, headline, per-arm aggregates
    for rows, headline, agg, backends in (ref, port):
        for name, be in backends.items():  # guard (1)
            assert be.jit_stats["eager_calls"] == 0, (name, be.jit_stats)
            assert be.jit_stats["jit_calls"] >= N_ITEMS, (name, be.jit_stats)
        assert agg["fixed"]["body_ms"] < agg["disabled"]["body_ms"]  # guard (3)
    # streams really shared replicas: batched buckets were compiled
    assert any(key[1] > 1 for key in port[3]["llm"]._compiled_buckets)
