"""``benchmarks/pipeline_sweep.py --smoke --controllers`` through the port
and the reference (the machinery of ``test_torch_pipeline.py``): static
against queue-aware admission on the load-aware pipeline. ``admission_sweep``
runs its own guards on both packages (the queue-aware arm defers, and cuts
replica churn and cost per item); rows, headline and every item must be
equal.
"""
from test_torch_pipeline import run_both


def test_pipeline_controllers_smoke_equals_reference():
    (ref, _), (port, _) = run_both("admission_sweep", smoke=True)
    ref_rows, ref_head = ref
    port_rows, port_head = port
    assert port_rows == ref_rows
    assert port_head == ref_head
    assert [r["arm"] for r in port_rows] == ["static", "queue-aware"]
    assert port_rows[1]["admission_defers"] > 0
