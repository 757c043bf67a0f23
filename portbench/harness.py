"""One run of one cell: set-up, the timed window, the check, the result.

What belongs to a configuration, a traffic mix, a cell or a per-layer
metric is a file found by name under the benchmark's directory (``bench``):

* ``BENCHMARK.json`` at the root names the cell's configuration and mix;
* the configuration's ``file`` (``configs/<config>.json``) holds the sizes
  the program is built with, the engine's settings, the seeded weights'
  rules (:mod:`.weights`) and the name of its plain reference
  (``reference/<name>.py``);
* ``traffic/<traffic>.json`` is the mix (:mod:`.traffic`);
* ``cells/<workload>.json`` holds the cell's check: how many finished
  requests it compares, and the limit of each number compared;
* ``metrics/<metric>.py`` reads one per-layer metric: ``read(ctx)`` returns
  a number, or None where it finds nothing to read.

The timed path is ``MinosServingEngine.serve``, one request a call, in a
closed loop with one client. The program takes the configuration, the
seed's weights (written into its parameters in place) and the requests;
everything it is judged by is computed here.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import roofline, traffic, weights
from .reference.common import Precision, no_tf32, served_sequence

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
PROFILE_AT = 0.25  # share of the traced window served before the profiled stretch
# After the captures the card may serve at a slower level (+6-17% a request)
# for a stretch that looks settled and then steps down once, 1 to 47 s seen
# (PERF.md): the warm-up serves on for at least SETTLE_MIN_S, until two
# blocks agree, and at most SETTLE_MAX_S.
SETTLE_MIN_S = 30.0
SETTLE_MAX_S = 60.0
SETTLE_TOL = 0.01


# ---------------------------------------------------------------------------
# finding a cell's files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    mix: dict             # the traffic mix
    check: dict           # cells/<workload>.json
    end_to_end: list      # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list       # ... and per_layer entries
    bench: Path           # the benchmark's directory


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "portbench"
    return Cell(
        name=workload,
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        mix=traffic.load(bench / "traffic" / f"{w['traffic']}.json"),
        check=json.loads((bench / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        bench=bench,
    )


def load_module(path: Path, name: str):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cell: Cell):
    return load_module(cell.bench / "reference" / f"{cell.config['reference']}.py",
                       f"portbench.reference.{cell.config['reference']}")


def metric_reader(cell: Cell, name: str) -> Callable[[dict], Optional[float]]:
    return load_module(cell.bench / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def arch_config(cfg: dict):
    """The program's config object built from the configuration file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if cfg.get("moe"):
        kw["moe"] = MoEConfig(**cfg["moe"])
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    return ArchConfig(**kw)


def build_engine(cfg: dict, seed: int, device):
    """The serving engine with the serving launcher's documented settings
    (``repro_torch.launch.serve``), which the configuration file holds: a
    Minos gate at the pre-test threshold of ``pass_fraction``."""
    from repro_torch.core.cost import Pricing
    from repro_torch.core.elysium import pretest_threshold
    from repro_torch.core.policy import MinosPolicy
    from repro_torch.serving.engine import MinosServingEngine

    e = cfg["engine"]
    rs = np.random.RandomState(0)
    thr = pretest_threshold(e["probe_work_ms"] / np.exp(rs.normal(0, e["speed_sigma"], 128)),
                            pass_fraction=e["pass_fraction"])
    return MinosServingEngine(
        arch_config(cfg), MinosPolicy(elysium_threshold=thr, max_retries=e["max_retries"]),
        Pricing.tpu_chip_seconds(e["pricing_chips"]), seed=seed % 2**32,
        speed_sigma=e["speed_sigma"], probe_work_ms=e["probe_work_ms"],
        max_pool=e["max_pool"], per_instance_concurrency=e["per_instance_concurrency"],
        decode_mode=e["decode_mode"], device=device)


def serve_request(engine, req: traffic.Request):
    from repro_torch.serving.engine import ServeRequest

    return engine.serve([ServeRequest(prompt=req.prompt, max_new_tokens=req.new_tokens,
                                      request_id=req.index)])[0]


class Spans:
    """CUDA events around ``Model.prefill_jit`` and ``Model.decode_tokens``,
    recorded from here (the model's methods are wrapped on the instance),
    each call also a ``torch.profiler.record_function`` range, so that the
    profiler ties the kernels of a graph's replay to it."""

    def __init__(self, model) -> None:
        self.model = model
        self.events: list[tuple[str, int, torch.cuda.Event, torch.cuda.Event]] = []
        for kind, attr in (("prefill", "prefill_jit"), ("decode", "decode_tokens")):
            object.__setattr__(model, attr, self._wrap(kind, getattr(model, attr)))

    def _wrap(self, kind: str, fn):
        def wrapped(*args, **kwargs):
            n = args[1]["tokens"].shape[1] if kind == "prefill" else args[3]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"portbench.{kind}"):
                e0.record()
                out = fn(*args, **kwargs)
                e1.record()
            self.events.append((kind, n, e0, e1))
            return out
        return wrapped

    def remove(self) -> None:
        for attr in ("prefill_jit", "decode_tokens"):
            object.__delattr__(self.model, attr)


@dataclasses.dataclass
class Done:
    req: traffic.Request
    tokens: np.ndarray
    t0: float
    t1: float
    spans: list = dataclasses.field(default_factory=list)  # (kind, n, ms)

    @property
    def wall_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


def _captures(engine) -> int:
    return engine.model.graph_stats["captures"]


def nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the profiled stretch
# ---------------------------------------------------------------------------


PROFILER_OVERHEAD = "Buffer Flush"  # CUPTI's record of its own buffer flushes


def read_profile(prof, wall_s: float) -> dict:
    """What the profiled stretch shows: every device operation (name, start
    us, duration us), the busy time, the kernels of the decode replays, and
    the breakdown. A device gap that opens while CUPTI flushes its activity
    buffers (its ``Buffer Flush`` overhead record) is the profiler's: it is
    left out of the stretch's length and listed apart."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation), key=lambda e: e.time_range.start)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [(e.name, e.time_range.start, e.time_range.end - e.time_range.start) for e in dev]
    intervals = []
    for _, s, d in kernels:
        if intervals and s <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], s + d)
        else:
            intervals.append([s, s + d])
    busy_us = sum(b - a for a, b in intervals)
    # the kernels a decode graph's launch ran share its correlation id
    ranges = [(e.time_range.start, e.time_range.end) for e in cpu if e.name == "portbench.decode"]
    launches = {e.id for e in cpu if e.name == "cudaGraphLaunch"
                and any(a <= e.time_range.start <= b for a, b in ranges)}
    decode_kernels = sum(e.id in launches for e in dev)
    by_name: dict[str, float] = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    iv = np.asarray(intervals, np.float64).reshape(-1, 2)
    g0, g1 = iv[:-1, 1], iv[1:, 0]
    flush = np.zeros(len(g0), bool)
    for e in cpu:
        if e.name == PROFILER_OVERHEAD:
            flush |= (e.time_range.start <= g0) & (g0 < e.time_range.end)
    flush_s = float((g1 - g0)[flush].sum()) * 1e-6
    idle = []
    for i in np.argsort(-(g1 - g0) * ~flush)[:9]:
        inside = [e for e in cpu if e.time_range.start <= g0[i] < e.time_range.end]
        host = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inside else "host outside any recorded op"
        idle.append([host[:120], float(g1[i] - g0[i]) * 1e-6])
    idle.append([f"{PROFILER_OVERHEAD} (the profiler's, left out of window_s)", flush_s])
    return {
        "kernels": kernels,
        "busy_s": busy_us * 1e-6,
        "window_s": wall_s - flush_s,
        "decode_kernels": decode_kernels,
        "breakdown": {"device_ops": [[n[:120], t * 1e-6] for n, t in device_ops],
                      "idle_gaps": idle},
    }


def warm_profiler(device: torch.device) -> None:
    """Start CUPTI once in set-up: its first start takes seconds."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(16, device=device).sum()
        _sync(device)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def warmup_requests(cell: Cell, seed: int) -> list:
    """One request of each of the cell's shapes, prompts drawn from ``seed``."""
    rng = np.random.Generator(np.random.PCG64([seed, 1]))
    vocab = cell.config["vocab"]
    return [traffic.Request(-1, rng.integers(0, vocab, S, dtype=np.int64).astype(np.int32), T)
            for S, T in traffic.warmup_shapes(cell.mix)]


def warm_up(engine, cell: Cell, seed: int) -> list:
    """Serve one request of each of the cell's shapes, through the timed
    entry point (captures every graph its traffic will replay)."""
    for req in warmup_requests(cell, seed):
        serve_request(engine, req)
    return sorted(engine.model.graphs.capture_ms.items(), key=lambda kv: str(kv[0]))


def settle(engine, cell: Cell, seed: int, min_s: float = SETTLE_MIN_S,
           max_s: float = SETTLE_MAX_S) -> list[float]:
    """Serve the warm-up's requests again, block after block, until at
    least ``min_s`` have passed and the last two blocks took the same time
    within ``SETTLE_TOL``, the last also within it of the fastest; or until
    ``max_s`` have passed. Returns each block's seconds (every block does
    the same work, so a step between two is the card's level changing)."""
    reqs = warmup_requests(cell, seed)
    blocks: list[float] = []
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        for req in reqs:
            serve_request(engine, req)
        blocks.append(time.perf_counter() - t)
        elapsed = time.perf_counter() - start
        if elapsed >= max_s:
            return blocks
        if elapsed >= min_s and len(blocks) >= 2 \
                and abs(blocks[-1] / blocks[-2] - 1) <= SETTLE_TOL \
                and blocks[-1] <= min(blocks) * (1 + SETTLE_TOL):
            return blocks


def timed_window(engine, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device) -> tuple[list, float, Optional[dict]]:
    """Serve requests one at a time until ``seconds`` have passed; the
    window ends with the request that crosses it. With ``trace`` the
    prefill and decode spans are recorded throughout and a stretch of
    ``profile_requests`` requests, from ``PROFILE_AT`` of the window, under
    ``torch.profiler``; the seconds the profiler takes to start and stop
    leave the window. Returns (requests done, window seconds, profile)."""
    spans = Spans(engine.model) if trace else None
    done: list[Done] = []
    prof = prof_t0 = None
    profiled = 0
    overhead = 0.0
    n_profile = cell.mix["profile_requests"]
    reqs = traffic.stream(cell.mix, seed, cell.config["vocab"])
    start = time.perf_counter()
    try:
        while True:
            req = next(reqs)
            if trace and prof is None and profiled == 0 and \
                    time.perf_counter() - start >= PROFILE_AT * seconds:
                t = time.perf_counter()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                _sync(device)
                prof_t0 = time.perf_counter()
                overhead += prof_t0 - t
            n0 = len(spans.events) if spans else 0
            t0 = time.perf_counter()
            res = serve_request(engine, req)
            t1 = time.perf_counter()
            d = Done(req, np.asarray(res.tokens), t0, t1)
            if spans:
                d.spans = spans.events[n0:]
            done.append(d)
            if prof is not None and profiled < n_profile:
                profiled += 1
                if profiled == n_profile:
                    _sync(device)
                    t = time.perf_counter()
                    prof_wall = t - prof_t0
                    prof.__exit__(None, None, None)
                    overhead += time.perf_counter() - t
            if t1 - start >= seconds:
                break
    finally:
        if spans:
            spans.remove()
    window_s = done[-1].t1 - start - overhead
    profile = None
    if prof is not None:
        if profiled < n_profile:  # the window closed inside the stretch
            _sync(device)
            prof_wall = time.perf_counter() - prof_t0
            prof.__exit__(None, None, None)
        profile = read_profile(prof, prof_wall)
        profile["requests"] = [d for d in done if d.t0 >= prof_t0][:profiled]
    if spans:
        _sync(device)
        for d in done:
            d.spans = [(kind, n, e0.elapsed_time(e1)) for kind, n, e0, e1 in d.spans]
    return done, window_s, profile


def sample(done: list, seed: int, n: int) -> list:
    """``n`` finished requests drawn from ``seed``, the longest among them."""
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i].req.prompt) + done[i].req.new_tokens, -i))
    rng = np.random.Generator(np.random.PCG64([seed, 2]))
    rest = [i for i in range(len(done)) if i != longest]
    picked = [longest] + list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return [done[i] for i in sorted(picked)]


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """By how much each chosen token's logit lies below the row's best, in
    standard deviations of the row (the reference's logits)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, chosen.long()[:, None])[:, 0]
    return (best - got) / ref_logits.std(dim=-1)


def reference_logits(cell: Cell, W: dict, d: Done, prec: Optional[Precision] = None):
    """The reference's logits at the positions that chose ``d``'s served
    tokens, (T, V) float32."""
    dev = next(iter(W.values())).device
    seq = served_sequence(torch.as_tensor(d.req.prompt, device=dev),
                          torch.as_tensor(d.tokens, device=dev))
    S = len(d.req.prompt)
    return reference(cell).logits(cell.config, W, seq, S, prec)[S:S + len(d.tokens)]


def _stats(per_request: list, prefix: str) -> dict:
    g = torch.cat(per_request)
    return {prefix + "gap_max": float(g.max()), prefix + "gap_mean": float(g.mean()),
            prefix + "req_gap_mean_max": max(float(r.mean()) for r in per_request),
            prefix + "flip_share": float((g > 0).float().mean())}


def check(cell: Cell, done: list, seed: int, specs: list, device,
          control: bool = False) -> dict:
    """The numbers compared, over a sample of the finished requests: by how
    much the served tokens' logits lie below the reference's best, in
    standard deviations of the reference's row: the mean over the tokens
    (``gap_mean``), the widest (``gap_max``), the largest of the requests'
    own means (``req_gap_mean_max``), and the share of tokens that are not
    the reference's best (``flip_share``). With ``control`` the same
    for the token that the float8 control puts first (``control_...``) and
    for the one that the reference in the served bfloat16 puts first
    (``bf16_...``), on the same positions."""
    no_tf32()
    W = weights.make(specs, cell.config["init"], seed, device)
    picked = sample(done, seed, cell.check["sample"])
    served, ctl, b16 = [], [], []
    for d in picked:
        lg = reference_logits(cell, W, d)
        served.append(gaps(lg, torch.as_tensor(d.tokens, device=lg.device)))
        if control:
            ctl.append(gaps(lg, reference_logits(cell, W, d, Precision("fp8")).argmax(dim=-1)))
            b16.append(gaps(lg, reference_logits(cell, W, d, Precision("bf16")).argmax(dim=-1)))
    out = {"requests": len(picked), "tokens": sum(len(g) for g in served)}
    out.update(_stats(served, ""))
    if control:
        out.update(_stats(ctl, "control_"))
        out.update(_stats(b16, "bf16_"))
    return out


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(cell: Cell, done: list, window_s: float, setup_s: float) -> dict:
    wall = [d.wall_ms for d in done]
    values = {
        "req_ms_p50": percentile(wall, 50),
        "req_ms_p90": percentile(wall, 90),
        "out_tok_per_s": sum(len(d.tokens) for d in done) / window_s,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def context(cell: Cell, done: list, window_s: float, profile: Optional[dict]) -> dict:
    """What a per-layer metric reads."""
    return {"config": cell.config, "mix": cell.mix, "requests": done, "window_s": window_s,
            "profile": profile, "roofline": roofline}


def per_layer(cell: Cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        v = metric_reader(cell, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def free(engine) -> None:
    """Drop the graphs and static caches of the program; the caller drops
    the engine itself, and then :func:`release`."""
    engine.model.graphs.graphs.clear()
    engine.model.graphs.caches.clear()


def release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None,
        before_window: Optional[Callable] = None,
        settle_s: tuple[float, float] = (SETTLE_MIN_S, SETTLE_MAX_S)) -> dict:
    """One run of ``workload``; returns the result object (printed last by
    the command). ``before_window(engine)`` may change the program after
    the warm-up (the tests plant faults there); ``settle_s`` is
    :func:`settle`'s least and most seconds (the tests shorten it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = load_cell(root, workload)
    setup = {}
    t = time.perf_counter()
    import repro_torch.serving.engine  # noqa: F401  (the program's import)
    from repro_torch.kernels import _build

    setup["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        _build.build()
    setup["kernel_build_s"] = _build.last_build_s
    setup["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = build_engine(cell.config, seed, device)
    setup["engine_s"] = time.perf_counter() - t
    t = time.perf_counter()
    specs = weights.write(engine.params, cell.config["init"], seed)
    _sync(device)
    setup["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    captures = warm_up(engine, cell, seed)
    _sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup["captures_ms"] = [[list(k), ms] for k, ms in captures]
    t = time.perf_counter()
    blocks = settle(engine, cell, seed, *settle_s)
    setup["settle_s"] = time.perf_counter() - t
    setup["settle_blocks_s"] = blocks
    if trace:
        warm_profiler(device)
    if before_window is not None:
        before_window(engine)
    n_captures = _captures(engine)
    smi_before = nvidia_smi() if device.type == "cuda" else None
    _build.reset_counters()
    setup_s = time.perf_counter() - t_start
    done, window_s, profile = timed_window(engine, cell, seed, seconds, trace, device)
    smi_after = nvidia_smi() if device.type == "cuda" else None
    if _captures(engine) != n_captures:
        raise RuntimeError(f"{_captures(engine) - n_captures} graph capture(s) inside the "
                           f"window: the warm-up missed a shape")
    gate = {
        "replicas_started": engine.replicas_started,
        "replicas_terminated": engine.replicas_terminated,
        "sim_cost_usd": engine.cost.total,
        "launches": dict(_build.launches), "plain": dict(_build.plain),
        "graph_stats": dict(engine.model.graph_stats),
    }
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log({"setup": setup, "setup_s": setup_s})
    log({"gate": gate})
    log({"nvidia_smi": {"before": smi_before, "after": smi_after}})
    log({"window": _window_summary(done, window_s)})
    free(engine)
    del engine
    release()
    numbers = check(cell, done, seed, specs, device)
    limits = cell.check["limits"]
    failed = sum(len(d.tokens) != d.req.new_tokens for d in done)
    correct = failed == 0 and all(numbers[k] <= lim for k, lim in limits.items())
    if trace:
        metrics = per_layer(cell, context(cell, done, window_s, profile))
    else:
        metrics = end_to_end(cell, done, window_s, setup_s)
    result = {"correct": correct, "attempted": len(done), "failed": failed, "metrics": metrics,
              "device": _device(device, memory_peak, profile)}
    if profile is not None:
        result["breakdown"] = profile["breakdown"]
    result["check"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    for k in ("gap_mean", "gap_max", "req_gap_mean_max", "flip_share", "tokens"):
        # shown beside them, not compared
        result["check"].setdefault(k, {"value": numbers[k], "limit": None})
    return result


def _window_summary(done: list, window_s: float) -> dict:
    """Requests and wall ms by decode bucket: the gap between two buckets'
    medians over their steps is the decode step's ms by the host clock,
    which tells the replay level a run sat at; and each request's (S, T,
    wall ms) in the order served."""
    by_tb: dict[int, list] = {}
    for d in done:
        by_tb.setdefault(traffic.bucket(d.req.new_tokens, 8), []).append(d.wall_ms)
    med = {tb: statistics.median(v) for tb, v in sorted(by_tb.items())}
    tbs = sorted(med)
    step = ((med[tbs[-1]] - med[tbs[0]]) / (tbs[-1] - tbs[0])) if len(tbs) > 1 else None
    return {"requests": len(done), "window_s": window_s,
            "median_ms_by_Tb": {str(k): v for k, v in med.items()},
            "n_by_Tb": {str(k): len(v) for k, v in sorted(by_tb.items())},
            "host_step_ms": step,
            "wall_ms": [[len(d.req.prompt), d.req.new_tokens, round(d.wall_ms, 2)] for d in done]}


def _device(device: torch.device, memory_peak: int, profile: Optional[dict]) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": memory_peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["window_s"]
    return out
