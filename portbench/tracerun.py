"""Serve one cell through the benchmark's own run with the program's tracer
on, and read what the tracer shows:

    python3 portbench/tracerun.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on an NVIDIA card. The run is
:func:`.harness.run` itself, with ``repro_torch.trace`` turned on before
the engine is built; ``--trace`` is the harness's. It prints the harness's
result line, then one JSON object a line:

* ``spans``, from the window's records: ``substrate_host_ms`` (median over
  the requests of ``serve.request`` less ``backend.body``),
  ``decode_launch_ms`` (median over the decode replays of ``graph.replay``,
  the host inside ``CUDAGraph.replay()``), ``host_ms`` (the median
  request's host ms by span, each less its children), ``device_ms`` (the
  replays' CUDA-event spans: decode ms a step and prefill ms per 1,000
  prompt tokens, medians) and ``outside_replays`` (the window's time
  outside those device spans, placed on the host clock by the tracer's
  anchors, each instant under the innermost span open then; the eager
  copies before and after a replay count here, so it is not the device's
  idle time);
* with ``--trace 1``, ``scopes``: each scope's share of the device time of
  the profiled stretch's decode and prefill launches (a launch's time is
  its scopes plus the waits between its nodes), the launches whose
  operations matched their scope map (and each that did not, with the
  operations found and those of its map), and the least, median and most
  of each launch's scope sum over its device span; and ``idle_by_span``: the
  stretch's idle seconds by the innermost program span open where each gap
  starts, beside the stretch's idle time less CUPTI's flushes.

Read host spans from ``--trace 0``: once CUPTI has started, graph launches
take many times their host time for the rest of the process (PERF.md §6).
So a scope's ms is its share from ``--trace 1`` times the decode step or
prefill ms of ``--trace 0``. This file goes once the harness turns the
tracer on in its own runs and reads these numbers (PERF.md §7).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness  # noqa: E402

# the program's spans, by the name of their records (a profiler range adds
# a graph's key in brackets)
SPANS = ("serve.request", "backend.body", "backend.h2d", "backend.readback", "graph.weights",
         "graph.capture", "graph.prefill", "graph.decode", "graph.copy_in", "graph.replay",
         "graph.copy_out")
OUTSIDE = "outside serve"
INSIDE_GRAPH = "between a graph's nodes"


def _median(values: list) -> Optional[float]:
    return statistics.median(values) if values else None


# ---------------------------------------------------------------------------
# the tracer's records
# ---------------------------------------------------------------------------


def substrate_host_ms(trace, spans: list) -> Optional[float]:
    return _median(list(trace.self_ms(spans, "serve.request").values()))


def decode_launch_ms(spans: list) -> Optional[float]:
    return _median([s.ms for s in spans
                    if s.name == "graph.replay" and s.attrs["key"][0] == "decode"])


def host_ms(trace, spans: list) -> dict:
    """Each span's median, over the requests, of its ms less its children's,
    summed in the request (0 where a request has none)."""
    by_id = {s.id: s for s in spans}
    rids = {s.request_id for s in spans if s.name == "serve.request"}
    out = {}
    for name in SPANS:
        per = dict.fromkeys(rids, 0.0)
        for sid, ms in trace.self_ms(spans, name).items():
            per[by_id[sid].request_id] += ms
        if any(per.values()):
            out[name] = statistics.median(per.values())
    return out


def device_ms(devices: list, by_id: dict) -> dict:
    """Medians of the replays' device spans: ms a decode step, and prefill
    ms per 1,000 prompt tokens. A decode key is (kind, B, rows, steps), a
    prefill key (kind, B, S, rows)."""
    step, ktok = [], []
    for name, parent, _, ms in devices:
        key = by_id[parent].attrs["key"]
        if name == "device.decode":
            step.append(ms / key[3])
        else:
            ktok.append(ms / (key[1] * key[2]) * 1e3)
    return {"decode_ms_per_step": _median(step), "prefill_ms_per_ktok": _median(ktok)}


def _innermost(spans: list, a: int, b: int) -> dict[str, float]:
    """The ns of ``[a, b)`` by the innermost of ``spans`` open at each
    instant (``outside serve`` where none is)."""
    inside = [s for s in spans if s.t0 < b and s.t1 > a]
    cuts = sorted({a, b} | {t for s in inside for t in (s.t0, s.t1) if a < t < b})
    out: dict[str, float] = {}
    for x, y in zip(cuts, cuts[1:]):
        open_ = [s for s in inside if s.t0 <= x < s.t1]
        name = min(open_, key=lambda s: s.t1 - s.t0).name if open_ else OUTSIDE
        out[name] = out.get(name, 0.0) + (y - x)
    return out


def outside_replays(devices: list, spans: list, t0: int, t1: int) -> tuple[dict, float]:
    """The time between ``t0`` and ``t1`` (host ns) outside the replays'
    device spans (``devices`` as ``trace.device_spans()`` gives them), in
    seconds, each instant under the innermost of ``spans`` open then.
    Returns (seconds by span, seconds inside replays)."""
    busy: list[list[int]] = []
    for _, _, start, ms in sorted(devices, key=lambda d: d[2] or 0):
        if start is None:
            continue
        a, b = max(start, t0), min(start + round(ms * 1e6), t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    out: dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            for name, ns in _innermost(spans, a, b).items():
                out[name] = out.get(name, 0.0) + ns * 1e-9
    return out, sum(b - a for a, b in busy) * 1e-9


# ---------------------------------------------------------------------------
# the profiled stretch
# ---------------------------------------------------------------------------


def _span_name(name: str) -> Optional[str]:
    base = name.split("[", 1)[0]
    return base if base in SPANS else None


def split_events(events: list) -> tuple[list, list]:
    """(CPU events, device operations ordered by start) of a profile."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation), key=lambda e: e.time_range.start)
    return cpu, dev


def launches(cpu: list, dev: list) -> list[tuple[str, list]]:
    """Each graph launch under a ``graph.replay[...]`` range, in order: (the
    graph's key as the range names it, its device operations as (name,
    start us, duration us) ordered by start). A launch's operations share
    the correlation id of its ``cudaGraphLaunch``."""
    by_id: dict[int, list] = {}
    for e in dev:
        by_id.setdefault(e.id, []).append(e)
    calls = [e for e in cpu if e.name == "cudaGraphLaunch"]
    out = []
    for r in sorted((e for e in cpu if e.name.startswith("graph.replay[")),
                    key=lambda e: e.time_range.start):
        ops = [o for c in calls if r.time_range.start <= c.time_range.start <= r.time_range.end
               for o in by_id.get(c.id, [])]
        ops.sort(key=lambda o: o.time_range.start)
        out.append((r.name[len("graph.replay["):-1],
                    [(o.name, o.time_range.start, o.time_range.end - o.time_range.start)
                     for o in ops]))
    return out


def scope_ms(trace, found: list, scope_maps: dict) -> tuple[dict, list]:
    """Device ms by scope of the launches, by kind of graph, with the steps
    (decode) or prompt tokens (prefill) they ran; and per launch the sum of
    its scopes in ms (None where its operations did not match its map)."""
    out: dict[str, dict] = {}
    sums = []
    for key, ops in found:
        kind, B, n, rows = key.split(",")[:4]
        k = out.setdefault(kind, {"launches": 0, "matched": 0, "work": 0, "ms": {}})
        k["launches"] += 1
        times = trace.scope_times(scope_maps[key], ops) if key in scope_maps else None
        sums.append(None if times is None else sum(times.values()) * 1e3)
        if times is None:
            continue
        k["matched"] += 1
        # a decode key is (kind, B, rows, steps), a prefill key (kind, B, S, rows)
        k["work"] += int(rows) if kind == "decode" else int(B) * int(n)
        for name, s in times.items():
            k["ms"][name] = k["ms"].get(name, 0.0) + s * 1e3
    return out, sums


def shares(by_kind: dict) -> dict:
    """Each scope's share in % of its kind's launches' device time."""
    return {kind: {name: 100 * ms / sum(k["ms"].values()) for name, ms in k["ms"].items()}
            for kind, k in by_kind.items() if k["ms"]}


def idle_by_span(cpu: list, dev: list, t0: float, t1: float) -> tuple[dict, float, float]:
    """The idle time of the device between ``t0`` and ``t1`` (profiler us),
    in seconds: a gap between two operations of one graph launch under
    ``between a graph's nodes``, every other gap under the innermost program
    span open where it starts, or ``outside serve``; the gaps that open
    while CUPTI flushes its buffers (``harness.PROFILER_OVERHEAD``) apart.
    Returns (seconds by span, busy seconds, flush seconds)."""
    ranges = [(e.time_range.start, e.time_range.end, _span_name(e.name)) for e in cpu]
    ranges = [r for r in ranges if r[2] is not None]
    flushes = [(e.time_range.start, e.time_range.end) for e in cpu
               if e.name == harness.PROFILER_OVERHEAD]
    intervals: list[list] = []  # [start, end, id of the first op, id of the last]
    for e in dev:
        s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if f <= s:
            continue
        if intervals and s <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], f)
            intervals[-1][3] = e.id
        else:
            intervals.append([s, f, e.id, e.id])
    gaps = [(a[1], b[0], a[3] == b[2]) for a, b in zip(intervals, intervals[1:])]
    if intervals:
        gaps = [(t0, intervals[0][0], False)] + gaps + [(intervals[-1][1], t1, False)]
    else:
        gaps = [(t0, t1, False)]
    out: dict[str, float] = {}
    flush_s = 0.0
    for a, b, same_launch in gaps:
        if b <= a:
            continue
        if any(f0 <= a < f1 for f0, f1 in flushes):
            flush_s += (b - a) * 1e-6
            continue
        if same_launch:
            name = INSIDE_GRAPH
        else:
            inside = [r for r in ranges if r[0] <= a < r[1]]
            name = min(inside, key=lambda r: r[1] - r[0])[2] if inside else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    busy = sum(iv[1] - iv[0] for iv in intervals) * 1e-6
    return out, busy, flush_s


def launch_over_device_span(found: list, sums: list, labels: list, devices: list) -> dict:
    """By kind, the least, median and most of each matched launch's scope
    sum over its CUDA-event device span. The launches are found in the
    window's device spans (``labels`` their graphs' keys) as the one run of
    keys that equals the stretch's; {} where no run or more than one does."""
    keys = [key for key, _ in found]
    at = [i for i in range(len(labels) - len(keys) + 1) if labels[i:i + len(keys)] == keys]
    if len(at) != 1 or not keys:
        return {}
    out: dict[str, list] = {}
    for key, s, d in zip(keys, sums, devices[at[0]:]):
        if s is not None:
            out.setdefault(key.split(",")[0], []).append(s / d[3])
    return {k: [min(v), statistics.median(v), max(v)] for k, v in out.items()}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(root: Path, workload: str, seed: int, seconds: float, profiled: bool, *,
        device="cuda", t_start: Optional[float] = None,
        settle_s: tuple[float, float] = (harness.SETTLE_MIN_S, harness.SETTLE_MAX_S)) -> list:
    """:func:`.harness.run` with the tracer on; returns the lines it prints."""
    from repro_torch import trace

    kept: list = []
    read = harness.read_profile

    def keep(prof, wall_s):
        kept.append(prof.events())
        return read(prof, wall_s)

    first: list[int] = []
    trace.clear()
    trace.enable()
    harness.read_profile = keep
    try:
        result = harness.run(root, workload, seed, seconds, profiled, device=device,
                             t_start=t_start, settle_s=settle_s,
                             before_window=lambda engine: first.append(len(trace.records())))
    finally:
        harness.read_profile = read
        trace.disable()
    recs = trace.records()
    win = recs[first[0]:]
    by_id = {s.id: s for s in recs}
    devices = [d for d in trace.device_spans() if d[1] is not None and d[1] >= first[0]]
    roots = [s for s in win if s.name == "serve.request"]
    lines = [result, {"spans": {
        "substrate_host_ms": substrate_host_ms(trace, win),
        "decode_launch_ms": decode_launch_ms(win),
        "host_ms": host_ms(trace, win) if win else {},
        "device_ms": device_ms(devices, by_id),
        "requests": len(roots), "spans_per_request": len(win) / max(1, len(roots))}}]
    if roots:
        t0, t1 = roots[0].t0, roots[-1].t1
        by_span, inside = outside_replays(devices, win, t0, t1)
        lines[-1]["spans"]["outside_replays"] = {
            "share": sum(by_span.values()) / ((t1 - t0) * 1e-9), "s_by_span": by_span,
            "replays_s": inside}
    if kept:
        scope_maps = {trace.label(s.attrs["key"]): s.attrs["scopes"] for s in recs
                      if s.name == "graph.capture" and s.attrs.get("scopes") is not None}
        cpu, dev = split_events(kept[0])
        found = launches(cpu, dev)
        by_kind, sums = scope_ms(trace, found, scope_maps)
        labels = [trace.label(by_id[d[1]].attrs["key"]) for d in devices]
        lines.append({"scopes": {
            "share": shares(by_kind),
            "launches": {k: {"n": v["launches"], "matched": v["matched"], "work": v["work"]}
                         for k, v in by_kind.items()},
            "scope_sum_over_device_span": launch_over_device_span(found, sums, labels, devices),
            # (place in the stretch, key, operations found, operations of its map)
            "unmatched": [[i, key, len(ops), scope_maps[key][-1][2] if key in scope_maps else None]
                          for i, ((key, ops), n) in enumerate(zip(found, sums)) if n is None]}})
        served = [e for e in cpu if e.name == "serve.request"]
        if served:
            a = min(e.time_range.start for e in served)
            b = max(e.time_range.end for e in served)
            idle, busy, flush = idle_by_span(cpu, dev, a, b)
            lines.append({"idle_by_span": idle, "idle_s": sum(idle.values()),
                          "stretch_idle_s": (b - a) * 1e-6 - busy - flush, "flush_s": flush})
    trace.clear()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for line in run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                    t_start=T_START):
        harness.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
