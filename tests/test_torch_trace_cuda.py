"""The tracer's scope maps on the card: a graph captured with the tracer on
records the module of each of its nodes, and one profiled replay runs
exactly those nodes in that order.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import trace
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import build_model

pytestmark = pytest.mark.cuda

# arch -> (the module whose share the benchmark reads, the scope of attention)
ARCHS = {"granite-moe-1b-a400m": ("ffn", "attention"),
         "zamba2-1.2b": ("mamba2", "shared_block")}
# the attention kernel each kind of graph launches (K2 in prefill, K3 in decode)
KERNELS = {"prefill": "flash", "decode": "decode_kernel"}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _serve(m, params, prompt, n_steps):
    cache = m.static_cache(1, 64)
    _, cache = m.prefill_jit(params, {"tokens": prompt}, cache)
    toks, _ = m.decode_tokens(params, cache, prompt[:, -1:], n_steps)
    return toks, cache


def _launch_ops(prof, key):
    """The device operations, ordered by start, of the graph launches under
    the ``graph.replay`` ranges of graph ``key``: one list a launch."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    out = []
    for r in (e for e in cpu if e.name == f"graph.replay[{trace.label(key)}]"):
        ids = {e.id for e in cpu if e.name == "cudaGraphLaunch"
               and r.time_range.start <= e.time_range.start <= r.time_range.end}
        ops = sorted((e for e in dev if e.id in ids), key=lambda e: e.time_range.start)
        out.append([(e.name, e.time_range.start, e.time_range.end - e.time_range.start)
                    for e in ops])
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_replay_runs_the_nodes_of_its_scope_map(arch, kind):
    module, attention = ARCHS[arch]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    m = build_model(cfg)
    params = m.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (1, 24), generator=gen, device="cuda",
                           dtype=torch.int32)
    trace.enable()
    _serve(m, params, prompt, 8)  # captures both graphs, then replays them
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        toks_on, cache = _serve(m, params, prompt, 8)
        torch.cuda.synchronize()
    n = 24 if kind == "prefill" else 8
    key = m.graph_key(kind, params, cache, 1, n)
    scope_map = m.graphs.graphs[key].scopes
    captures = [s for s in trace.records() if s.name == "graph.capture"
                and s.attrs["key"] == key]
    assert len(captures) == 1 and captures[0].attrs["scopes"] is scope_map
    assert m.graphs.capture_ms[key] > 0
    launch, = _launch_ops(prof, key)
    assert len(launch) == scope_map[-1][2], (len(launch), scope_map[-1])
    times = trace.scope_times(scope_map, launch)
    print(f"{arch} {kind}: {len(launch)} operations, ms by scope "
          f"{ {k: round(v * 1e3, 4) for k, v in times.items()} }")
    assert times[module] > 0 and times["logits"] > 0 and times[trace.GAPS] >= 0
    assert sum(times.values()) == pytest.approx(
        (max(s + d for _, s, d in launch) - launch[0][1]) * 1e-6)
    seen = 0
    for name, a, b in scope_map:
        for op, _, _ in launch[a:b]:
            if KERNELS[kind] in op:
                assert name == attention, (op, name)
                seen += 1
    launched = m.graphs.graphs[key].recorded["launches"][
        "flash_attention" if kind == "prefill" else "decode_attention"]
    assert seen == launched > 0
    spans = [d for d in trace.device_spans() if d[0] == f"device.{kind}"]
    assert len(spans) == 2 and all(start is not None and ms > 0 for _, _, start, ms in spans)
    # the same graph captured with the tracer off: no scope map, the same tokens
    trace.disable()
    m_off = build_model(cfg)
    toks_off, _ = _serve(m_off, params, prompt, 8)
    toks_off, _ = _serve(m_off, params, prompt, 8)
    assert m_off.graphs.graphs[key].scopes is None
    assert torch.equal(toks_on, toks_off)
