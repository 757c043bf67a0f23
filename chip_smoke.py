"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed 2] [--requests 8] [--new-tokens 32]

Run from the root of a checkout. It imports ``src/repro_torch`` (never
``jax``, never ``repro``) and, in order:

1. builds the three hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the sweep shapes of ``tests/test_kernels.py``,
   in f32 and bf16;
3. runs the Minos probe, ``MatmulProbe(n=512, repeats=8)``, on the card;
4. serves ``--requests`` requests (ragged prompts of 64-256 tokens,
   ``--new-tokens`` greedy tokens each) on full-width llama3.2-1b (bf16,
   random weights from ``--seed``) through ``MinosServingEngine``, in an
   ungated and a gated arm, and checks that the tokens agree across arms and
   that phases 3-4 launched every kernel and called no plain version;
5. runs one request in f32 on the kernel path and on the plain path and
   checks that the logits agree and the greedy tokens are equal;
6. times each kernel (CUDA graphs of repeated launches, timed with CUDA
   events) beside its bound, its plain version and the PyTorch library call
   that computes the same function, and each request's prefill and decode.

It exits non-zero, printing no result, if there is no CUDA device or any
phase fails. Its last two lines are the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"  # the one card this script needs

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a call could take
# is the larger of bytes / HBM rate and operations / peak rate for the type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32: FFMA, bf16: tensor cores

SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul_probe.cu", "src/repro/kernels/matmul_probe.py:43"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:72"),
}
TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}


class PhaseError(RuntimeError):
    pass


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def rand(shape, dtype, seed, device=None):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.tensor(x, device=device or DEVICE).to(dtype)


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (so the host's launch cost
    is not in the number), after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def compare(name, got, want, dtype, failures, *, atol_scale=1.0):
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol * atol_scale))
    if not ok or not torch.isfinite(got.float()).all():
        failures.append(f"{name}: max_abs_err {err:.3e} (rtol {tol}, atol {tol * atol_scale})")
    return err


def check_kernels(main_shapes, failures) -> dict[str, float]:
    """Returns the max abs error at the main path's shape, per kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul

    main_err = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        # K1: the probe's shape, the sweep of test_kernels.py, the ragged case
        for m, k, n in ((512, 512, 512), (128, 512, 128), (256, 1024, 256),
                        (128, 128, 384), (100, 300, 77)):
            a, b = rand((m, k), dtype, 0), rand((k, n), dtype, 1)
            err = compare(f"matmul {dtype} {m}x{k}x{n}", matmul(a, b), ref.matmul_ref(a, b),
                          dtype, failures, atol_scale=10.0)
            n_cases += 1
            if dtype == torch.float32 and (m, k, n) == (512, 512, 512):
                main_err["matmul"] = err
        # K2: MHA, GQA 4:1, MQA; d 64/96/128; causal on/off; ragged S
        for d in (64, 96, 128):
            for b_, qh, kvh in ((1, 4, 4), (2, 8, 2), (2, 4, 1)):
                for s in (128, 77, 200):
                    for causal in (True, False):
                        q = rand((b_, qh, s, d), dtype, 2)
                        k, v = rand((b_, kvh, s, d), dtype, 3), rand((b_, kvh, s, d), dtype, 4)
                        compare(f"flash {dtype} {(b_, qh, kvh, s, d)} causal={causal}",
                                flash_attention(q, k, v, causal=causal),
                                ref.attention_ref(q, k, v, causal=causal), dtype, failures)
                        n_cases += 1
        b_, qh, kvh, s, d = main_shapes["flash"]
        q, k, v = rand((b_, qh, s, d), dtype, 5), rand((b_, kvh, s, d), dtype, 6), rand((b_, kvh, s, d), dtype, 7)
        err = compare(f"flash {dtype} main {main_shapes['flash']}", flash_attention(q, k, v),
                      ref.attention_ref(q, k, v), dtype, failures)
        n_cases += 1
        if dtype == torch.bfloat16:
            main_err["flash_attention"] = err
        # K3: random lengths in [1, S] with a length-1 row; zeros at length 0
        rs = np.random.RandomState(8)
        for b_, qh, kvh, s, d in ((2, 4, 2, 512, 64), (1, 8, 8, 1024, 128), (3, 4, 1, 256, 64),
                                  (2, 32, 8, 300, 96), main_shapes["decode"]):
            q, k, v = rand((b_, qh, 1, d), dtype, 9), rand((b_, kvh, s, d), dtype, 10), rand((b_, kvh, s, d), dtype, 11)
            lengths = rs.randint(1, s + 1, size=b_)
            if b_ > 1:
                lengths[-1] = 1
            if (b_, qh, kvh, s, d) == main_shapes["decode"]:
                lengths[:] = main_shapes["decode_valid"]
            lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
            err = compare(f"decode {dtype} {(b_, qh, kvh, s, d)} lengths={lengths.tolist()}",
                          decode_attention(q, k, v, lens),
                          ref.decode_attention_ref(q, k, v, lens), dtype, failures)
            n_cases += 1
            if dtype == torch.bfloat16 and (b_, qh, kvh, s, d) == main_shapes["decode"]:
                main_err["decode_attention"] = err
        q, k, v = rand((2, 4, 1, 64), dtype, 12), rand((2, 2, 256, 64), dtype, 13), rand((2, 2, 256, 64), dtype, 14)
        out = decode_attention(q, k, v, torch.tensor([0, 3], dtype=torch.int32, device=DEVICE))
        if not torch.all(out[0] == 0):
            failures.append(f"decode {dtype}: length 0 did not give zeros")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain: {n_cases} cases, {len(failures)} outside tolerance "
          f"(f32 rtol/atol 2e-3, bf16 5e-2; matmul atol x10 as in tests/test_kernels.py)")
    for f in failures:
        print(f"    FAIL {f}")
    return main_err


# ---------------------------------------------------------------------------
# phases 3-6
# ---------------------------------------------------------------------------


def make_requests(cfg, n, new_tokens, seed, ServeRequest):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        s = int(rs.randint(64, 257))
        while s % 64 == 0:  # ragged: no prompt length is a multiple of 64
            s = int(rs.randint(64, 257))
        reqs.append(ServeRequest(prompt=rs.randint(0, cfg.vocab, size=s).astype(np.int32),
                                 max_new_tokens=new_tokens, request_id=i))
    return reqs


def serve_arms(cfg, reqs, seed, tag):
    from repro_torch.core.cost import Pricing
    from repro_torch.core.elysium import pretest_threshold
    from repro_torch.core.policy import MinosPolicy
    from repro_torch.serving.engine import MinosServingEngine

    # the pre-test of examples/serve_minos.py: replica speeds set the threshold
    rs = np.random.RandomState(seed)
    probe_work = 200.0
    thr = pretest_threshold(probe_work / np.exp(rs.normal(0.0, 0.15, size=64)), pass_fraction=0.4)
    engines, results = {}, {}
    for name, policy in (
        ("baseline", MinosPolicy(elysium_threshold=0.0, enabled=False)),
        ("minos", MinosPolicy(elysium_threshold=thr, max_retries=5)),
    ):
        eng = MinosServingEngine(cfg, policy, Pricing.tpu_chip_seconds(chips=1), seed=seed,
                                 max_pool=4, probe_work_ms=probe_work)
        if engines:  # the same weights in both arms: same seed, then shared
            first = engines["baseline"]
            if not torch.equal(eng.params.embed, first.params.embed):
                raise PhaseError("arms drew different weights from one seed")
            eng.backend.params = eng.params = first.params
        t0 = time.perf_counter()
        results[name] = eng.serve(list(reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engines[name] = eng
        print(f"[4] {name:8s}: {len(results[name])} served in {wall:.3f} s wall | replicas started "
              f"{eng.replicas_started} terminated {eng.replicas_terminated} | pool speed "
              f"{eng.pool_mean_speed:.3f} | cost ${eng.cost.total:.6f} | threshold "
              f"{policy.elysium_threshold:.1f} ms ({tag})")
    return engines, results


def check_outputs(cfg, reqs, results):
    for a, b, req in zip(results["baseline"], results["minos"], reqs):
        if not np.array_equal(a.tokens, b.tokens):
            raise PhaseError(f"request {req.request_id}: tokens differ across arms")
        if a.tokens.shape != (req.max_new_tokens,) or a.tokens.dtype != np.int32:
            raise PhaseError(f"request {req.request_id}: tokens {a.tokens.shape} {a.tokens.dtype}")
        if a.tokens.min() < 0 or a.tokens.max() >= cfg.vocab:
            raise PhaseError(f"request {req.request_id}: token out of the vocabulary")
    print(f"[4] tokens identical across arms for all {len(reqs)} requests; "
          f"first request's: {results['baseline'][0].tokens[:8].tolist()}...")


def f32_kernel_vs_plain(cfg, req, seed):
    from repro_torch.models.model import build_model, greedy_token

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mk = build_model(cfg32)
    mp = build_model(cfg32, use_kernels=False)
    params = mk.init(seed)
    prompt = torch.tensor(req.prompt, device=DEVICE)[None]
    T = req.max_new_tokens
    caches = {}
    logits = {}
    for name, m in (("kernel", mk), ("plain", mp)):
        caches[name] = m.init_cache(1, prompt.shape[1] + T)
        logits[name], _ = m.prefill(params, {"tokens": prompt}, caches[name])
    scale = logits["plain"].abs().max().item()
    worst = (logits["kernel"] - logits["plain"]).abs().max().item() / scale
    # teacher-forced decode: both paths see the kernel path's tokens
    tok = greedy_token(logits["kernel"])
    toks = {"kernel": [], "plain": []}
    for _ in range(T):
        step = {}
        for name, m in (("kernel", mk), ("plain", mp)):
            step[name], _ = m.decode_step(params, caches[name], tok)
            toks[name].append(greedy_token(step[name]))
        worst = max(worst, (step["kernel"] - step["plain"]).abs().max().item()
                    / step["plain"].abs().max().item())
        tok = toks["kernel"][-1]
    tk, tp = torch.cat(toks["kernel"], 1), torch.cat(toks["plain"], 1)
    finite = all(torch.isfinite(x).all().item() for x in logits.values())
    print(f"[5] f32 full width, one {prompt.shape[1]}-token prompt, {T} steps: max |logit "
          f"difference| / max |logit| = {worst:.3e} (tolerance 1e-4: the paths differ only in "
          f"attention's summation order); greedy tokens equal: {torch.equal(tk, tp)}")
    if not finite or worst > 1e-4 or not torch.equal(tk, tp):
        raise PhaseError("f32 kernel path disagrees with the plain path")
    del mk, mp, params, caches


def time_kernels(main_shapes, main_err, launches, card_str):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul

    rows = []
    # K1 at the probe's shape: n = 512, f32
    n = 512
    a, b = rand((n, n), torch.float32, 0), rand((n, n), torch.float32, 1)
    bms, by = bound(3 * n * n * 4, 2 * n**3, torch.float32)
    rows.append(("matmul", f"({n},{n})x({n},{n}) f32",
                 graph_ms(lambda: matmul(a, b)), graph_ms(lambda: ref.matmul_ref(a, b)),
                 graph_ms(lambda: torch.matmul(a, b)), bms, by))
    # K2 at the longest prompt: causal, bf16
    bq, qh, kvh, s, d = main_shapes["flash"]
    q, k, v = rand((bq, qh, s, d), torch.bfloat16, 5), rand((bq, kvh, s, d), torch.bfloat16, 6), rand((bq, kvh, s, d), torch.bfloat16, 7)
    pairs = bq * qh * s * (s + 1) / 2  # causal (q, k) pairs this input needs
    bms, by = bound(2 * (2 * bq * qh * s * d + 2 * bq * kvh * s * d), 4 * d * pairs, torch.bfloat16)
    rows.append(("flash_attention", f"q({bq},{qh},{s},{d}) kv({bq},{kvh},{s},{d}) bf16 causal",
                 graph_ms(lambda: flash_attention(q, k, v)),
                 graph_ms(lambda: ref.attention_ref(q, k, v)),
                 graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True)), bms, by))
    # K3 at one decode step of that prompt: the cache's valid prefix only
    bq, qh, kvh, cache, d = main_shapes["decode"]
    valid = main_shapes["decode_valid"]
    qd = rand((bq, qh, 1, d), torch.bfloat16, 9)
    kc, vc = rand((bq, kvh, cache, d), torch.bfloat16, 10), rand((bq, kvh, cache, d), torch.bfloat16, 11)
    lens = torch.full((bq,), valid, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(cache, device=DEVICE) < valid)[None, None, None, :]
    bms, by = bound(2 * (2 * bq * kvh * valid * d + 2 * bq * qh * d) + 4 * bq,
                    4 * d * bq * qh * valid, torch.bfloat16)
    rows.append(("decode_attention", f"q({bq},{qh},1,{d}) cache({bq},{kvh},{cache},{d}) valid {valid} bf16",
                 graph_ms(lambda: decode_attention(qd, kc, vc, lens)),
                 graph_ms(lambda: ref.decode_attention_ref(qd, kc, vc, lens)),
                 graph_ms(lambda: F.scaled_dot_product_attention(qd, kc, vc, attn_mask=mask,
                                                                 enable_gqa=True)), bms, by))
    out = []
    for name, shape, ms, plain_ms, lib_ms, bms, by in rows:
        print(f"[6] {name:16s} {shape}: kernel {ms:.5f} ms | bound {bms:.5f} ms ({by}) | "
              f"plain {plain_ms:.5f} ms | library {lib_ms:.5f} ms | launches on the main path "
              f"{launches[name]} ({card_str})")
        src, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": main_err[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return out


def time_requests(engine, reqs, card_str):
    be = engine.backend
    model, params = be.model, be.params
    from repro_torch.serving.backend import _bucket

    for req in reqs:
        S, T = len(req.prompt), req.max_new_tokens
        Tb = _bucket(T, base=be.decode_bucket)
        prompt = torch.tensor(req.prompt, device=DEVICE)[None]
        cache = model.init_cache(1, _bucket(S + Tb, base=be.decode_bucket))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, _ = model.decode_tokens(params, cache, prompt[:, -1:], Tb)
        toks.cpu()
        t2 = time.perf_counter()
        print(f"[6] request {req.request_id}: prompt {S} tokens, prefill {(t1 - t0) * 1e3:.3f} ms, "
              f"decode {Tb} steps {(t2 - t1) * 1e3:.3f} ms ({(t2 - t1) * 1e3 / Tb:.3f} ms/step) "
              f"wall ({card_str})")

    # One decode step of the first request, eager against its device time
    # (the same step captured in a CUDA graph and replayed): how long the
    # card idles while the host launches. The cache has room for the steps
    # both measurements take.
    req = reqs[0]
    prompt = torch.tensor(req.prompt, device=DEVICE)[None]
    cache = model.init_cache(1, len(req.prompt) + 64)
    model.prefill(params, {"tokens": prompt}, cache)
    tok = prompt[:, -1:].clone()
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_ms = graph_ms(lambda: model.decode_step(params, cache, tok), calls=1, replays=steps)
    print(f"[6] decode step (prompt {len(req.prompt)}): eager {eager_ms:.4f} ms wall, "
          f"{device_ms:.4f} ms on the device as one CUDA graph; the card idles "
          f"{1 - device_ms / eager_ms:.3f} of an eager step ({card_str})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # seed 2: the gated arm's first cold replicas fail the gate, so a run shows
    # terminations and requeues, not only the pass path
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.benchmark import MatmulProbe
    from repro_torch.kernels import _build, ops
    from repro_torch.serving.backend import ServeRequest, _bucket

    card_str = card()
    print(f"card: {card_str}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    out_dir = _build.build()
    for name in _build.KERNELS:
        _build.kernel(name)
    print(f"[1] kernels {list(_build.KERNELS)} ready in {time.perf_counter() - t0:.3f} s "
          f"({'built' if _build.last_build_s is not None else 'already built'}) in {out_dir.relative_to(ROOT) if out_dir.is_relative_to(ROOT) else out_dir}")

    cfg = get_config("llama3.2-1b")
    reqs = make_requests(cfg, args.requests, args.new_tokens, args.seed, ServeRequest)
    longest = max(len(r.prompt) for r in reqs)
    tb = _bucket(args.new_tokens, base=8)
    main_shapes = {
        "flash": (1, cfg.n_heads, cfg.n_kv_heads, longest, cfg.head_dim),
        "decode": (1, cfg.n_heads, cfg.n_kv_heads, _bucket(longest + tb, base=8), cfg.head_dim),
        "decode_valid": longest + tb // 2,  # mid-way through that request's decode
    }

    # 2. kernels against their plain versions
    failures: list[str] = []
    main_err = check_kernels(main_shapes, failures)
    if failures:
        raise PhaseError(f"{len(failures)} kernel comparisons outside tolerance")

    # 3-4. the main path: the probe, then serving in both arms
    ops.reset_counters()
    probe = MatmulProbe(n=512, repeats=8)
    probe_ms = probe.run()
    print(f"[3] MatmulProbe(n=512, repeats=8).run(): {probe_ms:.4f} ms on the card beside "
          f"work_ms_at_unit_speed() {probe.work_ms_at_unit_speed():.4f} ms (simulated time "
          f"anchor, {probe.flops:.0f} FLOP) ({card_str})")
    engines, results = serve_arms(cfg, reqs, args.seed, card_str)
    launches, plain = dict(ops.launches), dict(ops.plain)
    print(json.dumps({"counters": {"launches": launches, "plain": plain}}))
    if min(launches.values()) <= 0 or max(plain.values()) != 0:
        raise PhaseError(f"main path did not go through every kernel: {launches} {plain}")
    check_outputs(cfg, reqs, results)

    # 5. f32: kernel path against plain path at full width
    f32_kernel_vs_plain(cfg, reqs[0], args.seed)

    # 6. times
    kernels = time_kernels(main_shapes, main_err, launches, card_str)
    time_requests(engines["baseline"], reqs, card_str)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
