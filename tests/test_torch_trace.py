"""The port's tracer (``repro_torch.trace``) on the CPU: the spans of a
served request and their tree, the tracer off, the eager scopes under
``torch.profiler``, the scopes' order in a step, the graph cache's spans
around a stand-in graph, and the pure readers (scope map, scope times,
self time). Capture-time scope maps need the card:
``tests/test_torch_trace_cuda.py``."""
import _torch_cpu  # noqa: F401
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.cost import Pricing
from repro_torch.core.policy import MinosPolicy
from repro_torch.models import graphs
from repro_torch.models.model import build_model
from repro_torch.serving.engine import MinosServingEngine, ServeRequest

ARCHS = ["granite-moe-1b-a400m", "zamba2-1.2b"]
SCOPES = {"granite-moe-1b-a400m": {"attention", "ffn", "logits"},
          "zamba2-1.2b": {"mamba2", "shared_block", "logits"}}


@pytest.fixture(autouse=True)
def _tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _engine(arch):
    return MinosServingEngine(get_smoke_config(arch), MinosPolicy(elysium_threshold=200.0),
                              Pricing.tpu_chip_seconds(4), seed=5, max_pool=3, device="cpu")


def _requests(vocab, n=3):
    rs = np.random.RandomState(3)
    return [ServeRequest(prompt=rs.randint(0, vocab, size=S).astype(np.int32),
                         max_new_tokens=T, request_id=100 + i)
            for i, (S, T) in enumerate([(5, 3), (9, 4), (12, 6)][:n])]


@pytest.mark.parametrize("arch", ARCHS)
def test_served_requests_give_one_tree_each(arch):
    eng = _engine(arch)
    trace.enable()
    res = eng.serve(_requests(eng.cfg.vocab))
    recs = trace.records()
    by_id = {s.id: s for s in recs}
    roots = [s for s in recs if s.parent is None]
    assert [s.name for s in roots] == ["serve.request"] * 3
    assert [s.request_id for s in roots] == [100, 101, 102]
    children: dict = {}
    for s in recs:
        assert s.t1 is not None and s.t1 >= s.t0
        if s.parent is not None:
            parent = by_id[s.parent]
            assert s.request_id == parent.request_id
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
            children.setdefault(s.parent, []).append(s)
    for root, r in zip(roots, res):
        # the request's result is its ServeResult, joined by request_id
        assert root.attrs == {} and root.request_id == r.request_id
        body, = children[root.id]
        assert body.name == "backend.body"
        # on the CPU the compiled surface runs eagerly: no graph spans
        assert [c.name for c in children[body.id]] == ["backend.h2d", "backend.readback"]
    own = trace.self_ms(recs, "serve.request")
    assert sorted(own) == [r.id for r in roots]
    for r in roots:
        assert 0 <= own[r.id] <= r.ms


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_serves_the_same_tokens(arch):
    for entry in (trace.span("serve.request", request_id=1), trace.scope("ffn"),
                  trace.device_span("device.decode"), trace.capture()):
        assert entry is trace.NULL
    with trace.span("x") as sp:
        sp.set(a=1)
    assert trace.NULL.scopes is None
    reqs = _requests(get_smoke_config(arch).vocab)
    off = _engine(arch).serve(reqs)
    assert trace.records() == [] and trace.device_spans() == []
    trace.enable()
    on = _engine(arch).serve(reqs)
    assert len(trace.records()) > 0
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.retries, a.latency_ms) == (b.retries, b.latency_ms)


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_and_eager_scopes_are_profiler_ranges(arch):
    eng = _engine(arch)
    req = _requests(eng.cfg.vocab, 1)
    eng.serve(req)  # off: no program range
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.serve(req)
    assert not {e.name for e in prof.events()} & (SCOPES[arch] | {"serve.request"})
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.serve(req)
    names = {e.name for e in prof.events()}
    assert {"serve.request", "backend.body", "backend.h2d", "backend.readback"} <= names
    assert SCOPES[arch] <= names


class _FakeCapture:
    """Stands in for a capture: each read of the frontier finds a new node."""

    def __init__(self) -> None:
        self.marks, self.n, self.open = [], 0, None

    def frontier(self) -> int:
        self.n += 1
        return self.n


@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_marks_its_modules_in_order(arch, monkeypatch):
    """Inside a capture each scope reads the capture's frontier at its ends
    and opens no profiler range."""
    m = build_model(get_smoke_config(arch), device="cpu")
    params = m.init(0)
    cache = m.init_cache(1, 16)
    m.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, cache)
    cap = _FakeCapture()
    monkeypatch.setattr(trace, "_capture", cap)
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m._decode_loop(params, cache, torch.zeros((1, 1), dtype=torch.int32), 1)
    names = [name for name, _, _ in cap.marks]
    L = m.cfg.n_layers
    if arch == "zamba2-1.2b":
        assert names == ["mamba2"] * L + ["shared_block", "logits", "logits"]
    else:
        assert names == ["attention", "ffn"] * L + ["logits", "logits"]
    assert all(a < b for _, a, b in cap.marks)
    assert not {e.name for e in prof.events()} & SCOPES[arch]


def test_scopes_do_not_nest_in_a_capture(monkeypatch):
    cap = _FakeCapture()
    monkeypatch.setattr(trace, "_capture", cap)
    trace.enable()
    with trace.scope("ffn"):
        with pytest.raises(RuntimeError, match="do not nest"):
            with trace.scope("logits"):
                pass
    with trace.scope("logits"):
        pass
    assert [name for name, _, _ in cap.marks] == ["ffn", "logits"]


class _FakeEvent:
    def __init__(self, enable_timing=False) -> None:
        pass

    def record(self) -> None:
        pass

    def elapsed_time(self, other) -> float:
        return 2.5


class _FakeGraph:
    def __init__(self) -> None:
        self.replays = 0

    def replay(self) -> None:
        self.replays += 1


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_graph_runs_open_their_spans(kind, monkeypatch):
    """``GraphCache.run`` around a stand-in for a captured graph: one span
    a call with the key, its copies and replay as children, and the device
    span around the replay."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    params = torch.nn.Linear(2, 2)
    cache = graphs.GraphCache()
    cache._params, cache._weights = params, tuple(p.data_ptr() for p in params.parameters())
    key = (kind, 1, 4, 16)
    fake = _FakeGraph()
    cache.graphs[key] = graphs._Graph(fake, torch.zeros((1, 1)), torch.ones((1, 3)),
                                      {k: {} for k in ("launches", "plain", "form_launches",
                                                       "form_plain")}, [("other", 0, 3)])
    static = {"lengths": torch.zeros(1)}
    foreign = {"lengths": torch.ones(1)}
    trace.enable()
    with trace.span("backend.body", request_id=7):
        out = cache.run(key, params, torch.ones((1, 1)), None, foreign, static)
    assert fake.replays == 1 and torch.equal(out, torch.ones((1, 3)))
    assert torch.equal(static["lengths"], torch.ones(1))
    body, weights, run, copy_in, replay, copy_out = trace.records()
    assert (weights.name, weights.parent) == ("graph.weights", body.id)
    assert (run.name, run.parent, run.attrs) == (f"graph.{kind}", body.id, {"key": key})
    assert [s.name for s in (copy_in, replay, copy_out)] == \
        ["graph.copy_in", "graph.replay", "graph.copy_out"]
    assert {s.parent for s in (copy_in, replay, copy_out)} == {run.id}
    assert {s.request_id for s in trace.records()} == {7}
    assert replay.attrs == {"key": key}
    (name, parent, start, ms), = trace.device_spans()
    assert (name, parent, ms) == (f"device.{kind}", run.id, 2.5)
    assert start is None  # no card: no anchor


def test_scope_map_counts_operations_and_fills_the_gaps():
    # node 4 is an empty node (type 5): no device operation
    marks = [("attention", 0, 3), ("ffn", 3, 5), ("logits", 6, 7)]
    got = trace.op_ranges(marks, [0, 1, 2, 0, 5, 0, 0, 0])
    assert got == [("attention", 0, 3), ("ffn", 3, 4), ("other", 4, 5), ("logits", 5, 6),
                   ("other", 6, 7)]
    assert trace.op_ranges([], [0, 0]) == [("other", 0, 2)]


def test_marks_by_node_become_counts_along_the_chain():
    order = [0xA0, 0xB0, 0xC0, 0xD0]
    marks = [("attention", None, 0xB0), ("ffn", 0xB0, 0xB0), ("logits", 0xC0, 0xD0)]
    assert trace.chain_marks(marks, order) == [("attention", 0, 2), ("ffn", 2, 2),
                                              ("logits", 3, 4)]


def test_scope_times_map_a_launch_onto_its_ranges():
    scope_map = [("attention", 0, 2), ("ffn", 2, 5), ("logits", 5, 6)]
    # (name, start us, duration us): 2 us each, a gap of 1 us before every op but the first
    ops = [("k", 10.0 + 3 * i, 2.0) for i in range(6)]
    got = trace.scope_times(scope_map, ops)
    assert got == pytest.approx({"attention": 4e-6, "ffn": 6e-6, "logits": 2e-6,
                                 trace.GAPS: 5e-6})
    assert sum(got.values()) == pytest.approx((ops[-1][1] + ops[-1][2] - ops[0][1]) * 1e-6)
    # a scope that comes back in the same launch adds up; an operation that
    # overlaps the one before counts once
    again = trace.scope_times([("ffn", 0, 3), ("other", 3, 4), ("ffn", 4, 6)],
                              ops[:3] + [("k", 17.0, 2.0)] + ops[4:])
    assert again == pytest.approx({"ffn": 10e-6, "other": 1e-6, trace.GAPS: 6e-6})
    assert sum(again.values()) == pytest.approx(17e-6)
    assert trace.scope_times(scope_map, ops[:5]) is None
    assert trace.scope_times(scope_map, ops + ops[:1]) is None


def test_self_time_leaves_out_the_children():
    trace.enable()
    with trace.span("serve.request", request_id=1) as root:
        with trace.span("backend.body") as body:
            with trace.span("backend.h2d"):
                pass
    own = trace.self_ms(trace.records(), "serve.request")
    assert own == {root.id: pytest.approx(root.ms - body.ms)}
    assert trace.self_ms(trace.records(), "backend.body")[body.id] <= body.ms
