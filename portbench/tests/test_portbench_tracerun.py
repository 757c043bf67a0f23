"""``tracerun.py`` on the CPU at small sizes: the benchmark's run with the
program's tracer on reads the substrate's host time; the numbers that need
graphs read None, and nothing raises. And its readers on synthetic
profiles and device spans."""
from __future__ import annotations

import json
import types

import pytest
import torch

from portbench import harness, tracerun
from repro_torch import trace

CELLS = [w["name"] for w in json.loads((harness.Path(__file__).resolve().parents[2]
                                         / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_run_reads_the_substrate(tree, workload):
    """The harness's untraced run (its traced one times the graphs with CUDA
    events, so it runs on the card alone)."""
    torch.set_num_threads(2)
    lines = tracerun.run(tree, workload, 2**31 + 11, 1.0, False, device="cpu",
                         settle_s=(0.3, 1.0))
    result, out = lines[0], {k: v for line in lines[1:] for k, v in line.items()}
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"req_ms_p50", "req_ms_p90", "out_tok_per_s", "setup_s"}
    spans = out["spans"]
    assert spans["substrate_host_ms"] > 0 and spans["requests"] == result["attempted"]
    assert {"serve.request", "backend.body", "backend.h2d", "backend.readback"} \
        <= set(spans["host_ms"])
    # on the CPU the compiled surface runs eagerly: no graph, no device span
    assert spans["decode_launch_ms"] is None
    assert spans["device_ms"] == {"decode_ms_per_step": None, "prefill_ms_per_ktok": None}
    assert spans["outside_replays"]["share"] == pytest.approx(1.0)
    assert spans["outside_replays"]["replays_s"] == 0
    assert "scopes" not in out and "idle_by_span" not in out
    assert not trace.enabled() and trace.records() == []


def _event(name, start, end, cid=0, cuda=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, id=cid, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU, is_user_annotation=False)


def test_idle_is_put_down_to_the_innermost_span():
    key = "decode,1,64,2"
    cpu = [_event("serve.request", 5, 100), _event("backend.body", 10, 95),
           _event(f"graph.replay[{key}]", 20, 30), _event("cudaGraphLaunch", 22, 28, cid=7),
           _event("backend.readback", 60, 94), _event(harness.PROFILER_OVERHEAD, 80, 85)]
    dev = [_event("k0", 30, 40, cid=7, cuda=True), _event("k1", 42, 50, cid=7, cuda=True),
           _event("memcpy", 82, 84, cid=9, cuda=True), _event("k2", 90, 96, cid=11, cuda=True)]
    idle, busy, flush = tracerun.idle_by_span(cpu, dev, 0, 110)
    assert busy == pytest.approx(26e-6)
    assert flush == pytest.approx(6e-6)
    assert idle == pytest.approx({tracerun.OUTSIDE: 30e-6, tracerun.INSIDE_GRAPH: 2e-6,
                                  "backend.body": 32e-6, "serve.request": 14e-6})
    found = tracerun.launches(cpu, dev)
    assert found == [(key, [("k0", 30, 10), ("k1", 42, 8)])]
    by_kind, sums = tracerun.scope_ms(trace, found, {key: [("ffn", 0, 1), ("logits", 1, 2)]})
    assert by_kind == {"decode": {"launches": 1, "matched": 1, "work": 2,
                                  "ms": pytest.approx({"ffn": 0.01, "logits": 0.008,
                                                       trace.GAPS: 0.002})}}
    assert sums == [pytest.approx(0.02)]
    assert tracerun.shares(by_kind) == {"decode": pytest.approx(
        {"ffn": 50.0, "logits": 40.0, trace.GAPS: 10.0})}
    # the launch found among the window's device spans by its run of keys
    devices = [("device.prefill", 1, None, 1.0), ("device.decode", 2, None, 0.025)]
    assert tracerun.launch_over_device_span(found, sums, ["prefill,1,8,64", key], devices) \
        == {"decode": [pytest.approx(0.8)] * 3}
    assert tracerun.launch_over_device_span(found, sums, [key, key], devices) == {}


def test_window_idle_lays_device_spans_on_the_host_clock():
    """The window's time outside the replays' device spans, on the host
    clock, each instant under the innermost span open then."""
    trace.enable()
    with trace.span("serve.request", request_id=3) as root:
        with trace.span("backend.body") as body:
            pass
    trace.disable()
    root.t0, root.t1, body.t0, body.t1 = 100, 900, 150, 850
    devices = [("device.prefill", body.id, 200, 1e-4), ("device.decode", body.id, 320, 3e-4),
               ("device.decode", body.id, 1000, 1e-4)]
    outside, inside = tracerun.outside_replays(devices, trace.records(), 0, 1000)
    assert inside == pytest.approx(400e-9)
    assert outside == pytest.approx({tracerun.OUTSIDE: 100e-9 + 100e-9,
                                     "serve.request": 50e-9 + 50e-9,
                                     "backend.body": 50e-9 + 20e-9 + 230e-9})
    trace.clear()
