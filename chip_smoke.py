"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed 2] [--requests 8] [--new-tokens 32]

Run from the root of a checkout. It imports ``src/repro_torch`` (never
``jax``, never ``repro``) and, in order:

1. builds the three hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, at the sweep shapes of ``tests/test_kernels.py`` and
   at the edge shapes of ``tests/test_torch_kernels_cuda.py``, in f32 and
   bf16, and checks that two calls on the same inputs give bitwise the same
   output;
3. runs the Minos probe, ``MatmulProbe(n=512, repeats=8)``, on the card;
4. serves ``--requests`` requests (ragged prompts of 64-256 tokens,
   ``--new-tokens`` greedy tokens each) on full-width llama3.2-1b (bf16,
   random weights from ``--seed``) through ``MinosServingEngine``, in an
   ungated and a gated arm, on the compiled surface (``prefill_jit`` and
   ``decode_tokens``, each a CUDA graph captured at the first call of a
   shape), and checks that the tokens agree across arms and that phases 3-4
   launched each kernel exactly as often as the path needs (the probe's
   repeats; one K2 launch a layer a request; one K3 launch a layer a decode
   step) and called no plain version;
4b. serves the same requests again through the captured path and through
   the eager one (prefill, then one ``decode_step`` at a time) and checks
   that the tokens are equal and the K/V rows each wrote agree;
5. runs one request in f32 on the kernel path and on the plain path and
   checks that the logits agree and the greedy tokens are equal; then the
   longest prompt's prefill in bf16, the serving dtype, on both paths with
   the serving weights, and holds the logits to ``BF16_LOGIT_LIMIT``;
6. times each kernel (CUDA graphs of repeated launches, timed with CUDA
   events) beside its bound, its plain version and the PyTorch library call
   that computes the same function; K3 also over a 4000-key prefix, with the
   cache warm and cold in L2, and at length 0; then each request's prefill
   and decode on the captured and on the eager path (phase 4b's run), the
   capture time of each shape, the kernels of one eager decode step and the
   device's idle share in an eager and in a captured step (``torch.profiler``),
   and the memory the graphs and their static caches hold.

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
# rtol = atol, per kernel and dtype (PERF.md says how each was set). bf16
# flash: the kernel rounds P to bf16 before PV, as the Pallas kernel does, and
# the plain version does not; its largest error over phase 2's cases on the
# card was 1.5625e-2 (one bf16 ulp at |out| in [2, 4)), so twice that. bf16
# decode: 2e-2 (measured at most 4.9e-4). bf16 matmul: 8 mantissa bits over a
# K-long sum, atol x10 as for f32.
TOL = {
    "matmul": {torch.float32: 2e-3, torch.bfloat16: 5e-2},
    "flash_attention": {torch.float32: 2e-3, torch.bfloat16: 3.125e-2},
    "decode_attention": {torch.float32: 2e-3, torch.bfloat16: 2e-2},
}
# max |logit difference| / max |logit|, bf16 prefill of the longest prompt,
# kernel path against plain path on the same weights: PERF.md says how it was set
BF16_LOGIT_LIMIT = 1.1e-2


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


def compare(name, fn, want, failures, worst, *, tol, atol_scale=1.0):
    """Holds ``fn()`` against ``want``, and a second call against the first.
    ``worst`` keeps the largest error per kernel and dtype (the first two
    words of ``name``), with |want| where it occurred."""
    got = fn()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    key = " ".join(name.split()[:2])
    if err >= worst.get(key, (0.0, 0.0))[0]:
        worst[key] = (err, want.float().flatten()[diff.argmax()].abs().item())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol * atol_scale))
    if not ok or not torch.isfinite(got.float()).all():
        failures.append(f"{name}: max_abs_err {err:.3e} (rtol {tol}, atol {tol * atol_scale})")
    if not torch.equal(fn(), got):
        failures.append(f"{name}: two calls on the same inputs differ")
    return err


# K2 edge shapes, as in tests/test_torch_kernels_cuda.py:
# (batch, q_heads, kv_heads, q_seq, kv_seq, d)
FLASH_EDGES = [
    *[(batch, qh, kvh, s, s, d)
      for batch, qh, kvh in ((1, 32, 8), (2, 8, 2))
      for s in (1, 15, 64, 65, 250)
      for d in (64, 96, 128)],
    (1, 32, 8, 65, 250, 64), (2, 8, 2, 1, 200, 128), (1, 8, 2, 100, 129, 96),
]


def check_kernels(main_shapes, failures) -> dict[str, float]:
    """Returns the max abs error at the main path's shape, per kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul

    main_err, worst = {}, {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        # K1: the probe's shape, the sweep of test_kernels.py, the ragged and
        # unaligned cases, one row of A, K = 1
        for m, k, n in ((512, 512, 512), (128, 512, 128), (256, 1024, 256),
                        (128, 128, 384), (100, 300, 77), (1, 512, 512), (512, 1, 512)):
            a, b = rand((m, k), dtype, 0), rand((k, n), dtype, 1)
            err = compare(f"matmul {dtype} {m}x{k}x{n}", lambda: matmul(a, b),
                          ref.matmul_ref(a, b), failures, worst, tol=TOL["matmul"][dtype],
                          atol_scale=10.0)
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
                                lambda: flash_attention(q, k, v, causal=causal),
                                ref.attention_ref(q, k, v, causal=causal), failures,
                                worst, tol=TOL["flash_attention"][dtype])
                        n_cases += 1
        for b_, qh, kvh, sq, skv, d in FLASH_EDGES:
            for causal in (True, False):
                q = rand((b_, qh, sq, d), dtype, 2)
                k, v = rand((b_, kvh, skv, d), dtype, 3), rand((b_, kvh, skv, d), dtype, 4)
                compare(f"flash {dtype} {(b_, qh, kvh, sq, skv, d)} causal={causal}",
                        lambda: flash_attention(q, k, v, causal=causal),
                        ref.attention_ref(q, k, v, causal=causal), failures, worst,
                        tol=TOL["flash_attention"][dtype])
                n_cases += 1
        b_, qh, kvh, s, d = main_shapes["flash"]
        q, k, v = rand((b_, qh, s, d), dtype, 5), rand((b_, kvh, s, d), dtype, 6), rand((b_, kvh, s, d), dtype, 7)
        err = compare(f"flash {dtype} main {main_shapes['flash']}",
                      lambda: flash_attention(q, k, v), ref.attention_ref(q, k, v), failures,
                      worst, tol=TOL["flash_attention"][dtype])
        n_cases += 1
        if dtype == torch.bfloat16:
            main_err["flash_attention"] = err
        # K3: random lengths in [1, S] with a length-1 row, or the lengths
        # given; then the edges of tests/test_torch_kernels_cuda.py (group 16,
        # a long prefix, fewer keys than splits, per-batch lengths that
        # differ); zeros at length 0
        rs = np.random.RandomState(8)
        for b_, qh, kvh, s, d, given in (
                (2, 4, 2, 512, 64, None), (1, 8, 8, 1024, 128, None), (3, 4, 1, 256, 64, None),
                (2, 32, 8, 300, 96, None), (*main_shapes["decode"], [main_shapes["decode_valid"]]),
                (1, 16, 1, 2048, 128, None), (1, 32, 8, 4096, 64, [4000]),
                (2, 32, 8, 512, 64, [3, 20]), (4, 8, 2, 300, 64, [300, 17, 1, 150])):
            q, k, v = rand((b_, qh, 1, d), dtype, 9), rand((b_, kvh, s, d), dtype, 10), rand((b_, kvh, s, d), dtype, 11)
            lengths = rs.randint(1, s + 1, size=b_)
            if b_ > 1:
                lengths[-1] = 1
            if given is not None:
                lengths = np.asarray(given)
            lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
            err = compare(f"decode {dtype} {(b_, qh, kvh, s, d)} lengths={lengths.tolist()}",
                          lambda: decode_attention(q, k, v, lens),
                          ref.decode_attention_ref(q, k, v, lens), failures, worst,
                          tol=TOL["decode_attention"][dtype])
            n_cases += 1
            if dtype == torch.bfloat16 and (b_, qh, kvh, s, d) == main_shapes["decode"]:
                main_err["decode_attention"] = err
        q, k, v = rand((2, 4, 1, 64), dtype, 12), rand((2, 2, 256, 64), dtype, 13), rand((2, 2, 256, 64), dtype, 14)
        out = decode_attention(q, k, v, torch.tensor([0, 3], dtype=torch.int32, device=DEVICE))
        if not torch.all(out[0] == 0):
            failures.append(f"decode {dtype}: length 0 did not give zeros")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain: {n_cases} cases, {len(failures)} failures (rtol = atol: f32 "
          f"2e-3; bf16 flash 3.125e-2, decode 2e-2, matmul 5e-2; matmul atol x10 as in "
          f"tests/test_kernels.py; every case called twice and compared bitwise)")
    print("[2] largest max_abs_err over the cases (at |plain|): " + "; ".join(
        f"{k.replace('torch.', '')} {e:.4e} ({w:.4f})" for k, (e, w) in sorted(worst.items())))
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


def bf16_kernel_vs_plain(engine, req):
    """Prefill logits in bf16 at full width, kernel path against plain path
    on the serving weights: the check that the bf16 attention kernel, the
    one serving runs, carries the model."""
    from repro_torch.models.model import build_model

    mk, params = engine.backend.model, engine.backend.params
    mp = build_model(mk.cfg, use_kernels=False)
    prompt = torch.tensor(req.prompt, device=DEVICE)[None]
    # the forward pass runs the prefill layers and keeps every position's logits
    logits = {name: m.forward(params, {"tokens": prompt}).float()
              for name, m in (("kernel", mk), ("plain", mp))}
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    rel = diff / logits["plain"].abs().max().item()
    finite = torch.isfinite(logits["kernel"]).all().item()
    print(f"[5] bf16 full width, one {prompt.shape[1]}-token prompt, logits at every position: "
          f"max |logit difference| / max |logit| = {rel:.3e} (limit {BF16_LOGIT_LIMIT:.1e}; "
          f"max |logit difference| {diff:.4e})")
    if not finite or rel > BF16_LOGIT_LIMIT:
        raise PhaseError("bf16 kernel path disagrees with the plain path")


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
    # K3 over a long prefix, beside the main row (not in the kernels line)
    cache, valid = 4096, 4000
    kc, vc = rand((bq, kvh, cache, d), torch.bfloat16, 12), rand((bq, kvh, cache, d), torch.bfloat16, 13)
    lens = torch.full((bq,), valid, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(cache, device=DEVICE) < valid)[None, None, None, :]
    lbms, lby = bound(2 * (2 * bq * kvh * valid * d + 2 * bq * qh * d) + 4 * bq,
                      4 * d * bq * qh * valid, torch.bfloat16)
    long_ms = graph_ms(lambda: decode_attention(qd, kc, vc, lens))
    long_plain = graph_ms(lambda: ref.decode_attention_ref(qd, kc, vc, lens))
    long_lib = graph_ms(lambda: F.scaled_dot_product_attention(qd, kc, vc, attn_mask=mask,
                                                               enable_gqa=True))
    # the same with the cache cold in L2, as a decode step finds it: eight
    # caches (67 MB, more than the 50 MB L2) taken in turn
    caches = [(rand((bq, kvh, cache, d), torch.bfloat16, 20 + 2 * i),
               rand((bq, kvh, cache, d), torch.bfloat16, 21 + 2 * i)) for i in range(8)]
    turn = iter(range(1 << 30))

    def cold(fn):
        return lambda: fn(*caches[next(turn) % len(caches)])
    cold_ms = graph_ms(cold(lambda kc_, vc_: decode_attention(qd, kc_, vc_, lens)), calls=24)
    cold_lib = graph_ms(cold(lambda kc_, vc_: F.scaled_dot_product_attention(
        qd, kc_, vc_, attn_mask=mask, enable_gqa=True)), calls=24)
    print(f"[6] decode_attention long q({bq},{qh},1,{d}) cache({bq},{kvh},{cache},{d}) valid "
          f"{valid} bf16: kernel {long_ms:.5f} ms | bound {lbms:.5f} ms ({lby}) | plain "
          f"{long_plain:.5f} ms | library {long_lib:.5f} ms SDPA + mask | L2-cold (8 caches "
          f"in turn): kernel {cold_ms:.5f} ms, library {cold_lib:.5f} ms ({card_str})")
    del kc, vc, caches
    # what a call costs with no keys to read (length 0 at the main shape),
    # beside the least a captured kernel costs (one one-element add)
    kc, vc = rand((bq, kvh, main_shapes["decode"][3], d), torch.bfloat16, 10), rand(
        (bq, kvh, main_shapes["decode"][3], d), torch.bfloat16, 11)
    zero = torch.zeros((bq,), dtype=torch.int32, device=DEVICE)
    one = torch.zeros(1, device=DEVICE)
    print(f"[6] decode_attention fixed cost: length 0 at the main shape "
          f"{graph_ms(lambda: decode_attention(qd, kc, vc, zero)):.5f} ms | a one-element add "
          f"{graph_ms(lambda: one.add_(1)):.5f} ms ({card_str})")
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


def eager_decode(model, params, cache, tok, n_steps):
    """The greedy loop one ``decode_step`` at a time: the eager path."""
    from repro_torch.models.model import greedy_token

    out = []
    for _ in range(n_steps):
        logits, _ = model.decode_step(params, cache, tok)
        tok = greedy_token(logits)
        out.append(tok)
    return torch.cat(out, 1)


def captured_vs_eager(engine, reqs, served):
    """Phase 4b: each request through the captured path (phase 4's graphs,
    replayed) and through the eager path, on caches of the same length, so
    that the kernels see the same shapes. Returns each request's wall times."""
    from repro_torch.serving.backend import _bucket

    be = engine.backend
    model, params = be.model, be.params
    tol = TOL["decode_attention"][torch.bfloat16]
    rows, worst = [], 0.0
    for req, res in zip(reqs, served):
        S, T = len(req.prompt), req.max_new_tokens
        Tb = _bucket(T, base=be.decode_bucket)
        cache_len = _bucket(S + Tb, base=be.decode_bucket)
        prompt = torch.tensor(req.prompt, device=DEVICE)[None]
        caches = {"captured": model.static_cache(1, cache_len),
                  "eager": model.init_cache(1, cache_len)}
        toks, times = {}, {}
        for path, cache in caches.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            if path == "captured":
                model.prefill_jit(params, {"tokens": prompt}, cache)
            else:
                model.prefill(params, {"tokens": prompt}, cache)
            ev[1].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if path == "captured":
                out = model.decode_tokens(params, cache, prompt[:, -1:], Tb)[0]
            else:
                out = eager_decode(model, params, cache, prompt[:, -1:], Tb)
            ev[2].record()
            toks[path] = out.cpu()
            # (prefill wall, decode wall, prefill span, decode span) in ms; a
            # span is the time between CUDA events recorded before and after
            times[path] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3,
                           ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))
        if not torch.equal(toks["captured"], toks["eager"]):
            raise PhaseError(f"request {req.request_id}: captured and eager tokens differ")
        if not np.array_equal(toks["captured"][0, :T].numpy(), res.tokens):
            raise PhaseError(f"request {req.request_id}: captured tokens differ from served ones")
        a, b = caches["captured"], caches["eager"]
        diff = max((a[n][:, :, :, :S + Tb].float() - b[n][:, :, :, :S + Tb].float()
                    ).abs().max().item() for n in ("k", "v"))
        worst = max(worst, diff)
        if diff > tol or not torch.equal(a["lengths"], b["lengths"]):
            raise PhaseError(f"request {req.request_id}: captured K/V rows differ from eager "
                             f"by {diff:.3e}")
        rows.append((req.request_id, S, Tb, times))
    print(f"[4b] captured vs eager, {len(reqs)} requests: tokens equal (and equal to phase 4's); "
          f"K/V rows max |diff| {worst:.4e} (tolerance {tol}, the bf16 decode tolerance)")
    return rows


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (kernels, copies and sets, summed
    device ms, ms from the first device activity's start to the last one's
    end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise PhaseError("torch.profiler recorded no device activity")
    copies = sum(1 for e in dev if e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    return len(dev) - copies, copies, busy, span, dev


def heaviest(dev, n=5) -> str:
    """The ``n`` kernel names with the most device time in ``dev``, with
    their share of it and their count."""
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    total = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n]
    return "; ".join(f"{sum(v) / total:.3f} in {len(v)} x {name[:70]}" for name, v in top)


def clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def time_requests(engines, reqs, rows, card_str):
    from repro_torch.serving.backend import _bucket

    for rid, S, Tb, times in rows:
        (cp, cd, cps, cds), (ep, ed, _, _) = times["captured"], times["eager"]
        print(f"[6] request {rid}: prompt {S} tokens | captured: prefill {cp:.3f} ms, decode "
              f"{Tb} steps {cd:.3f} ms ({cd / Tb:.4f} ms/step) wall; event spans prefill "
              f"{cps:.3f} ms, decode {cds:.3f} ms | eager: prefill {ep:.3f} ms, decode "
              f"{ed:.3f} ms ({ed / Tb:.4f} ms/step) wall ({card_str})")
    for name, eng in engines.items():
        print(f"[6] {name} arm, capture wall time per shape: " + "; ".join(
            f"{key[0]}{key[1:]} {ms:.1f} ms" for key, ms in eng.model.graphs.capture_ms.items())
            + f" | {eng.model.graph_stats} ({card_str})")

    # The first request's decode, eager and captured: kernels a step, device
    # time (the profiler's sum of kernel times), wall time, idle share.
    be = engines["baseline"].backend
    model, params = be.model, be.params
    req = reqs[0]
    S = len(req.prompt)
    Tb = _bucket(req.max_new_tokens, base=be.decode_bucket)
    prompt = torch.tensor(req.prompt, device=DEVICE)[None]
    cache = model.init_cache(1, S + 64)
    model.prefill(params, {"tokens": prompt}, cache)
    tok = prompt[:, -1:].clone()
    steps = 16
    model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, copies, busy, _, _ = profiled(lambda: model.decode_step(params, cache, tok))
    graph_step = graph_ms(lambda: model.decode_step(params, cache, tok), calls=1, replays=steps)
    print(f"[6] eager decode step (prompt {S}): {kernels} kernels and {copies} copies/sets "
          f"(torch.profiler), {busy:.4f} ms of device time, {eager_ms:.4f} ms wall; idle share "
          f"{1 - busy / eager_ms:.3f}; the step as one CUDA graph {graph_step:.4f} ms on the "
          f"device ({card_str})")

    # The same request's captured prefill and decode loop: wall time and
    # event span unprofiled, five times, the card's clocks sampled during
    # the fifth (its wall holds the sampling, so it is left out of the
    # means); then one of each under the profiler for its kernel time. The
    # idle share is 1 - kernel time / unprofiled wall: the gaps between the
    # graph's kernels (event span - kernel time) and the host's share (wall
    # - event span). The profiler's own trace span is longer than the
    # unprofiled one: tracing slows the replay.
    static = model.static_cache(1, _bucket(S + Tb, base=be.decode_bucket))
    runs = {"prefill": lambda: model.prefill_jit(params, {"tokens": prompt}, static)[0],
            "decode": lambda: model.decode_tokens(params, static, tok, Tb)[0]}
    for name, fn in runs.items():
        walls, spans = [], []
        for i in range(5):
            static["lengths"].fill_(S)  # back to the end of the prompt
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = fn()
            end.record()
            sampled = clocks() if i == 4 else None
            out.cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
            spans.append(start.elapsed_time(end))
        static["lengths"].fill_(S)
        kernels, copies, busy, trace, dev = profiled(lambda: fn().cpu())
        wall, span = float(np.mean(walls[:4])), float(np.mean(spans[:4]))
        what = f"decode loop (prompt {S}, {Tb} steps)" if name == "decode" else \
            f"prefill (prompt {S})"
        per_step = (f" ({wall / Tb:.4f} ms wall and {busy / Tb:.4f} ms of kernels a step)"
                    if name == "decode" else "")
        print(f"[6] captured {what}: unprofiled wall {' '.join(f'{w:.3f}' for w in walls[:4])}"
              f" ms, event spans {' '.join(f'{s:.3f}' for s in spans[:4])} ms; clocks during "
              f"the fifth (SM, memory, power): {sampled}; profiled: {kernels} kernels and "
              f"{copies} copies/sets, {busy:.4f} ms of kernel time (trace span {trace:.4f} ms)"
              f"{per_step}; idle share {1 - busy / wall:.3f}: between the graph's kernels "
              f"{(span - busy) / wall:.3f}, on the host {(wall - span) / wall:.3f} ({card_str})")
        print(f"[6] captured {name}, heaviest kernels (share of kernel time): {heaviest(dev)}")


def graph_memory(engines, card_str):
    """What each arm's graphs hold on the device: their static caches, and
    the segments of their shared memory pool (from the allocator's snapshot)."""
    segments = torch.cuda.memory_snapshot()
    for name, eng in engines.items():
        g = eng.model.graphs
        static = sum(t.numel() * t.element_size() for c in g.caches.values() for t in c.values())
        pool = sum(s["total_size"] for s in segments
                   if tuple(s.get("segment_pool_id", ())) == tuple(g.pool))
        print(f"[6] {name} arm: {len(g.graphs)} graphs hold {static / 1e6:.3f} MB of static "
              f"caches ({len(g.caches)}) and {pool / 1e6:.3f} MB in their memory pool "
              f"({card_str})")


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
    # the probe's repeats; per request and arm, one K2 launch a layer and one
    # K3 launch a layer a decode step (the bucket's steps)
    expected = {"matmul": probe.repeats,
                "flash_attention": 2 * len(reqs) * cfg.n_layers,
                "decode_attention": 2 * len(reqs) * cfg.n_layers * tb}
    if launches != expected or max(plain.values()) != 0:
        raise PhaseError(f"main path launches {launches}, plain {plain}; expected {expected} "
                         f"launches and no plain call")
    print(f"[4] launches exactly as the path needs: {expected}; no plain call")
    check_outputs(cfg, reqs, results)
    rows = captured_vs_eager(engines["baseline"], reqs, results["baseline"])

    # 5. kernel path against plain path at full width: f32, then bf16
    f32_kernel_vs_plain(cfg, reqs[0], args.seed)
    bf16_kernel_vs_plain(engines["baseline"], max(reqs, key=lambda r: len(r.prompt)))

    # 6. times
    kernels = time_kernels(main_shapes, main_err, launches, card_str)
    time_requests(engines, reqs, rows, card_str)
    graph_memory(engines, card_str)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
