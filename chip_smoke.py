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
   the serving weights, and holds the logits to ``BF16_LOGIT_LIMIT`` (see
   ``bf16_kernel_vs_plain``);
6. times each kernel (CUDA graphs of repeated launches, timed with CUDA
   events) beside its bound, its plain version and the PyTorch library call
   that computes the same function; K3 also over a 4000-key prefix, with the
   cache warm and cold in L2, and at length 0; then each request's prefill
   and decode on the captured and on the eager path (phase 4b's run), the
   capture time of each shape, the kernels of one eager decode step and the
   device's idle share in an eager and in a captured step (``torch.profiler``),
   and the memory the graphs and their static caches hold;
7. the MoE family: (a) serves the same requests on full-width
   granite-moe-1b-a400m (24 layers, 32 experts top-8, bf16, random weights
   from ``--seed``) in both arms on the captured path, with the launches
   held exactly as in phase 4 (no probe: no K1); (b) holds captured serving
   to eager serving as phase 4b; (c) holds the kernel path to the plain path
   as phase 5, and prints the share of routing choices (token, layer, k) both
   paths made; then times the requests, captures and steps as phase 6, and
   one layer's MoE FFN against a decode step; (d) runs deepseek-moe-16b at
   full width and ``DEEPSEEK_LAYERS`` layers (shared experts, head_dim 128,
   16 kv heads) on the kernel path against the plain path, in bf16 and f32;
   and times K2 and K3 at both archs' shapes.

It exits non-zero, printing no result, if there is no CUDA device or any
phase fails. Its last two lines are the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
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
# kernel path against plain path on the same weights, or twice the plain
# path's own distance from f32 where that is larger: PERF.md says how it was set
BF16_LOGIT_LIMIT = 1.1e-2
MOE_ARCH = "granite-moe-1b-a400m"  # phase 7's served arch
DEEPSEEK_LAYERS = 4  # of deepseek-moe-16b's 28, at full width (about 5.5 GB in bf16)
DEEPSEEK_STEPS = 8   # its teacher-forced f32 decode steps


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


def check_kernels(main_shapes, failures) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul

    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        # K1: the probe's shape, the sweep of test_kernels.py, the ragged and
        # unaligned cases, one row of A, K = 1
        for m, k, n in ((512, 512, 512), (128, 512, 128), (256, 1024, 256),
                        (128, 128, 384), (100, 300, 77), (1, 512, 512), (512, 1, 512)):
            a, b = rand((m, k), dtype, 0), rand((k, n), dtype, 1)
            compare(f"matmul {dtype} {m}x{k}x{n}", lambda: matmul(a, b),
                    ref.matmul_ref(a, b), failures, worst, tol=TOL["matmul"][dtype],
                    atol_scale=10.0)
            n_cases += 1
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
        compare(f"flash {dtype} main {main_shapes['flash']}",
                lambda: flash_attention(q, k, v), ref.attention_ref(q, k, v), failures,
                worst, tol=TOL["flash_attention"][dtype])
        n_cases += 1
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
            compare(f"decode {dtype} {(b_, qh, kvh, s, d)} lengths={lengths.tolist()}",
                    lambda: decode_attention(q, k, v, lens),
                    ref.decode_attention_ref(q, k, v, lens), failures, worst,
                    tol=TOL["decode_attention"][dtype])
            n_cases += 1
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


def prompt_of(req) -> torch.Tensor:
    return torch.tensor(req.prompt, device=DEVICE)[None]


def serve_arms(cfg, reqs, seed, tag, ph="4"):
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
        print(f"[{ph}] {name:8s}: {len(results[name])} served in {wall:.3f} s wall | replicas started "
              f"{eng.replicas_started} terminated {eng.replicas_terminated} | pool speed "
              f"{eng.pool_mean_speed:.3f} | cost ${eng.cost.total:.6f} | threshold "
              f"{policy.elysium_threshold:.1f} ms ({tag})")
    return engines, results


def check_outputs(cfg, reqs, results, ph="4"):
    for a, b, req in zip(results["baseline"], results["minos"], reqs):
        if not np.array_equal(a.tokens, b.tokens):
            raise PhaseError(f"request {req.request_id}: tokens differ across arms")
        if a.tokens.shape != (req.max_new_tokens,) or a.tokens.dtype != np.int32:
            raise PhaseError(f"request {req.request_id}: tokens {a.tokens.shape} {a.tokens.dtype}")
        if a.tokens.min() < 0 or a.tokens.max() >= cfg.vocab:
            raise PhaseError(f"request {req.request_id}: token out of the vocabulary")
    print(f"[{ph}] tokens identical across arms for all {len(reqs)} requests; "
          f"first request's: {results['baseline'][0].tokens[:8].tolist()}...")


@contextlib.contextmanager
def routes(replay=None):
    """Records the experts that each MoE layer chose while the block runs:
    ``moe.gates``' indices, (B, S, K) a call, in call order. With ``replay``
    (another run's record) each call takes the experts recorded there, in
    their order, and renormalises its own probabilities at them, as
    ``moe.gates`` does: the run then routes exactly as the recorded one."""
    from repro_torch.models import moe

    seen, gates = [], moe.gates
    recorded = iter(replay) if replay is not None else None

    def recording(m, probs):
        if recorded is None:
            vals, idx = gates(m, probs)
        else:
            idx = next(recorded)
            vals = probs.gather(-1, idx)
            vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
        seen.append(idx.clone())
        return vals, idx

    moe.gates = recording
    try:
        yield seen
    finally:
        moe.gates = gates


def agreement(a, b) -> float:
    """The share of (token, layer, k) routing choices that two runs'
    records (``routes()``) both made."""
    hits = total = 0
    for x, y in zip(a, b, strict=True):
        same = (x[..., :, None] == y[..., None, :]).any(-1)  # (B, S, K)
        hits += int(same.sum())
        total += same.numel()
    return hits / total


def f32_kernel_vs_plain(cfg, prompt, T, seed, ph="5"):
    """One request in f32 (prefill, then ``T`` teacher-forced decode steps)
    on the kernel path and on the plain path, fresh weights from ``seed``."""
    from repro_torch.models.model import build_model, greedy_token

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    paths = {"kernel": build_model(cfg32), "plain": build_model(cfg32, use_kernels=False)}
    params = paths["kernel"].init(seed)
    caches, logits, chosen = {}, {}, {"kernel": [], "plain": []}
    for name, m in paths.items():
        caches[name] = m.init_cache(1, prompt.shape[1] + T)
        with routes() as seen:
            logits[name], _ = m.prefill(params, {"tokens": prompt}, caches[name])
        chosen[name] += seen
    scale = logits["plain"].abs().max().item()
    worst = (logits["kernel"] - logits["plain"]).abs().max().item() / scale
    # teacher-forced decode: both paths see the kernel path's tokens
    tok = greedy_token(logits["kernel"])
    toks = {"kernel": [], "plain": []}
    for _ in range(T):
        step = {}
        for name, m in paths.items():
            with routes() as seen:
                step[name], _ = m.decode_step(params, caches[name], tok)
            chosen[name] += seen
            toks[name].append(greedy_token(step[name]))
        worst = max(worst, (step["kernel"] - step["plain"]).abs().max().item()
                    / step["plain"].abs().max().item())
        tok = toks["kernel"][-1]
    tk, tp = torch.cat(toks["kernel"], 1), torch.cat(toks["plain"], 1)
    finite = all(torch.isfinite(x).all().item() for x in logits.values())
    routing = ""
    if cfg.moe is not None:
        routing = (f"; routing choices both paths made: "
                   f"{agreement(chosen['kernel'], chosen['plain']):.6f}")
    print(f"[{ph}] f32 {cfg.arch_id} full width ({cfg.n_layers} layers), one {prompt.shape[1]}-token "
          f"prompt, {T} steps: max |logit difference| / max |logit| = {worst:.3e} (tolerance 1e-4: "
          f"the paths differ only in attention's summation order); greedy tokens equal: "
          f"{torch.equal(tk, tp)}{routing}")
    if not finite or worst > 1e-4 or not torch.equal(tk, tp):
        raise PhaseError(f"f32 kernel path disagrees with the plain path ({cfg.arch_id})")
    del paths, params, caches


def bf16_kernel_vs_plain(mk, params, prompt, ph="5"):
    """Prefill logits in bf16 at full width, kernel path against plain path
    on the same weights: the check that the bf16 attention kernel, the one
    serving runs, carries the model.

    With an MoE FFN a routing choice can flip between the paths where two
    experts' probabilities lie within the paths' bf16 difference, and a flip
    moves its token's logits and the later ones by more than attention's
    rounding does. So the plain path runs twice: routing itself (the share
    of choices both paths made, and its logits' difference, are printed)
    and replaying the kernel path's choices (held). A plain f32 run of the
    same weights and routing measures how far the held plain path is from
    the arithmetic both bf16 paths round: the two bf16 paths may differ by
    ``BF16_LOGIT_LIMIT``, or by twice that distance where it is larger (a
    kernel path no farther from f32 than the plain path). PERF.md gives the
    measured numbers."""
    from repro_torch.models.model import build_model

    moe = mk.cfg.moe is not None
    held = "plain, kernel's routing" if moe else "plain"
    mp = build_model(mk.cfg, use_kernels=False)
    m32, p32 = f32_copy(mk.cfg, params)
    # (name, model, weights, whose routing to replay); the forward pass runs
    # the prefill layers and keeps every position's logits
    runs = [("kernel", mk, params, None), ("plain", mp, params, None),
            ("f32", m32, p32, "kernel" if moe else None)]
    if moe:
        runs.append((held, mp, params, "kernel"))
    logits, chosen = {}, {}
    for name, m, w, replay in runs:
        with routes(chosen.get(replay)) as chosen[name]:
            logits[name] = m.forward(w, {"tokens": prompt})[0].float()
    del m32, p32

    def rel(a, b):
        return (logits[a] - logits[b]).abs().max().item() / logits[b].abs().max().item()

    err, from_f32 = rel("kernel", held), rel(held, "f32")
    limit = max(BF16_LOGIT_LIMIT, 2 * from_f32)
    top = logits[held].abs().max().item()
    step = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16's spacing at the largest logit
    routing = ""
    if moe:
        routing = (f"; routing choices both paths made: {agreement(chosen['kernel'], chosen['plain']):.6f}"
                   f", each path routing itself {rel('kernel', 'plain'):.3e} (not held)")
    print(f"[{ph}] bf16 {mk.cfg.arch_id} full width ({mk.cfg.n_layers} layers), one "
          f"{prompt.shape[1]}-token prompt, logits at every position, max |logit difference| / "
          f"max |logit|: kernel against {held} path {err:.3e} (limit {limit:.3e}: "
          f"{BF16_LOGIT_LIMIT:.1e}, or twice the {held} path's distance from f32 "
          f"{from_f32:.3e}); kernel path from f32 {rel('kernel', 'f32'):.3e}; max |logit| "
          f"{top:.4f}, bf16 spacing there {step:.6f}{routing}")
    if not torch.isfinite(logits["kernel"]).all().item() or err > limit:
        raise PhaseError(f"bf16 kernel path disagrees with the plain path ({mk.cfg.arch_id})")


def f32_copy(cfg, params):
    """A plain-path f32 model and an f32 copy of ``params``."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import Transformer

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = Transformer(cfg32, torch.device(DEVICE))
    with torch.no_grad():
        for a, b in zip(p32.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    return build_model(cfg32, use_kernels=False), p32


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def flash_row(shape):
    """K2 at ``shape`` (batch, q heads, kv heads, S, d), causal, bf16 (the
    inputs of phase 2's main case): (shape text, max_abs_err, kernel ms,
    plain ms, library ms, bound ms, bound by)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    bq, qh, kvh, s, d = shape
    q, k, v = rand((bq, qh, s, d), torch.bfloat16, 5), rand((bq, kvh, s, d), torch.bfloat16, 6), rand((bq, kvh, s, d), torch.bfloat16, 7)
    pairs = bq * qh * s * (s + 1) / 2  # causal (q, k) pairs this input needs
    bms, by = bound(2 * (2 * bq * qh * s * d + 2 * bq * kvh * s * d), 4 * d * pairs, torch.bfloat16)
    return (f"q({bq},{qh},{s},{d}) kv({bq},{kvh},{s},{d}) bf16 causal",
            max_err(flash_attention(q, k, v), ref.attention_ref(q, k, v)),
            graph_ms(lambda: flash_attention(q, k, v)),
            graph_ms(lambda: ref.attention_ref(q, k, v)),
            graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True)), bms, by)


def decode_row(shape, valid):
    """K3 at ``shape`` (batch, q heads, kv heads, cache rows, d), ``valid``
    rows in use, bf16 (phase 2's main-case inputs); as :func:`flash_row`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    bq, qh, kvh, cache, d = shape
    qd = rand((bq, qh, 1, d), torch.bfloat16, 9)
    kc, vc = rand((bq, kvh, cache, d), torch.bfloat16, 10), rand((bq, kvh, cache, d), torch.bfloat16, 11)
    lens = torch.full((bq,), valid, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(cache, device=DEVICE) < valid)[None, None, None, :]
    bms, by = bound(2 * (2 * bq * kvh * valid * d + 2 * bq * qh * d) + 4 * bq,
                    4 * d * bq * qh * valid, torch.bfloat16)
    return (f"q({bq},{qh},1,{d}) cache({bq},{kvh},{cache},{d}) valid {valid} bf16",
            max_err(decode_attention(qd, kc, vc, lens), ref.decode_attention_ref(qd, kc, vc, lens)),
            graph_ms(lambda: decode_attention(qd, kc, vc, lens)),
            graph_ms(lambda: ref.decode_attention_ref(qd, kc, vc, lens)),
            graph_ms(lambda: F.scaled_dot_product_attention(qd, kc, vc, attn_mask=mask,
                                                            enable_gqa=True)), bms, by)


def report_rows(rows, launches, card_str, ph, suffix=""):
    """Prints ``(name, row)`` pairs and returns their entries of the
    ``kernels`` JSON line, named ``name + suffix``; ``launches`` None: a
    shape that no served path runs (the entries are then not for that line)."""
    out = []
    for name, (shape, err, ms, plain_ms, lib_ms, bms, by) in rows:
        where = ("not on a served path" if launches is None
                 else f"launches on the main path {launches[name]}")
        print(f"[{ph}] {name + suffix:16s} {shape}: kernel {ms:.5f} ms | bound {bms:.5f} ms ({by}) | "
              f"plain {plain_ms:.5f} ms | library {lib_ms:.5f} ms | max_abs_err {err:.4e} | "
              f"{where} ({card_str})")
        src, replaces = SOURCES[name]
        out.append({"name": name + suffix, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": launches and launches[name], "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return out


def time_kernels(main_shapes, launches, card_str):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.matmul_probe import matmul

    # K1 at the probe's shape: n = 512, f32
    n = 512
    a, b = rand((n, n), torch.float32, 0), rand((n, n), torch.float32, 1)
    bms, by = bound(3 * n * n * 4, 2 * n**3, torch.float32)
    rows = [("matmul", (f"({n},{n})x({n},{n}) f32", max_err(matmul(a, b), ref.matmul_ref(a, b)),
                        graph_ms(lambda: matmul(a, b)), graph_ms(lambda: ref.matmul_ref(a, b)),
                        graph_ms(lambda: torch.matmul(a, b)), bms, by)),
            # K2 at the longest prompt; K3 at one decode step of that prompt
            ("flash_attention", flash_row(main_shapes["flash"])),
            ("decode_attention", decode_row(main_shapes["decode"], main_shapes["decode_valid"]))]
    # K3 over a long prefix, beside the main row (not in the kernels line)
    bq, qh, kvh, _, d = main_shapes["decode"]
    qd = rand((bq, qh, 1, d), torch.bfloat16, 9)
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
    return report_rows(rows, launches, card_str, "6")


def eager_decode(model, params, cache, tok, n_steps):
    """The greedy loop one ``decode_step`` at a time: the eager path."""
    from repro_torch.models.model import greedy_token

    out = []
    for _ in range(n_steps):
        logits, _ = model.decode_step(params, cache, tok)
        tok = greedy_token(logits)
        out.append(tok)
    return torch.cat(out, 1)


def captured_vs_eager(engine, reqs, served, ph="4b"):
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
    print(f"[{ph}] captured vs eager, {len(reqs)} requests: tokens equal (and equal to the served ones); "
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


def time_requests(engines, reqs, rows, card_str, ph="6") -> float:
    """Prints the requests' times, the captures and the profiled steps;
    returns the kernel ms of one captured decode step."""
    from repro_torch.serving.backend import _bucket

    for rid, S, Tb, times in rows:
        (cp, cd, cps, cds), (ep, ed, _, _) = times["captured"], times["eager"]
        print(f"[{ph}] request {rid}: prompt {S} tokens | captured: prefill {cp:.3f} ms, decode "
              f"{Tb} steps {cd:.3f} ms ({cd / Tb:.4f} ms/step) wall; event spans prefill "
              f"{cps:.3f} ms, decode {cds:.3f} ms | eager: prefill {ep:.3f} ms, decode "
              f"{ed:.3f} ms ({ed / Tb:.4f} ms/step) wall ({card_str})")
    for name, eng in engines.items():
        print(f"[{ph}] {name} arm, capture wall time per shape: " + "; ".join(
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
    print(f"[{ph}] eager decode step (prompt {S}): {kernels} kernels and {copies} copies/sets "
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
        per_step = (f" ({wall / Tb:.4f} ms wall, {busy / Tb:.4f} ms of kernels and "
                    f"{kernels / Tb:.1f} kernels a step)" if name == "decode" else "")
        print(f"[{ph}] captured {what}: unprofiled wall {' '.join(f'{w:.3f}' for w in walls[:4])}"
              f" ms, event spans {' '.join(f'{s:.3f}' for s in spans[:4])} ms; clocks during "
              f"the fifth (SM, memory, power): {sampled}; profiled: {kernels} kernels and "
              f"{copies} copies/sets, {busy:.4f} ms of kernel time (trace span {trace:.4f} ms)"
              f"{per_step}; idle share {1 - busy / wall:.3f}: between the graph's kernels "
              f"{(span - busy) / wall:.3f}, on the host {(wall - span) / wall:.3f} ({card_str})")
        print(f"[{ph}] captured {name}, heaviest kernels (share of kernel time): {heaviest(dev)}")
        step_ms = busy / Tb
    return step_ms


def graph_memory(engines, card_str, ph="6"):
    """What each arm's graphs hold on the device: their static caches, and
    the segments of their shared memory pool (from the allocator's snapshot)."""
    segments = torch.cuda.memory_snapshot()
    for name, eng in engines.items():
        g = eng.model.graphs
        static = sum(t.numel() * t.element_size() for c in g.caches.values() for t in c.values())
        pool = sum(s["total_size"] for s in segments
                   if tuple(s.get("segment_pool_id", ())) == tuple(g.pool))
        print(f"[{ph}] {name} arm: {len(g.graphs)} graphs hold {static / 1e6:.3f} MB of static "
              f"caches ({len(g.caches)}) and {pool / 1e6:.3f} MB in their memory pool "
              f"({card_str})")


# ---------------------------------------------------------------------------
# phase 7: the MoE family
# ---------------------------------------------------------------------------


def moe_ffn_share(engine, step_ms, card_str):
    """One layer's MoE FFN at the decode shape (one token), as a CUDA graph,
    times the layers, against the kernel time of a captured decode step."""
    model, params = engine.backend.model, engine.backend.params
    cfg = model.cfg
    x = rand((1, 1, cfg.d_model), cfg.torch_dtype, 30)
    mlp = params.layers[0].mlp
    ms = graph_ms(lambda: mlp(x))
    kernels, copies, busy, _, dev = profiled(lambda: mlp(x))
    print(f"[7] MoE FFN of one layer at the decode shape (1 token): {ms:.5f} ms on the device "
          f"(CUDA graph), {kernels} kernels and {copies} copies/sets (torch.profiler); x "
          f"{cfg.n_layers} layers = {ms * cfg.n_layers:.4f} ms, {ms * cfg.n_layers / step_ms:.3f} "
          f"of a captured decode step's {step_ms:.4f} ms of kernels ({card_str})")
    print(f"[7] MoE FFN, heaviest kernels (share of its kernel time): {heaviest(dev)}")


def moe_phase(args, card_str):
    """Phase 7: granite-moe-1b-a400m served at full width behind the gate on
    the captured path, held to its exact launches, to the eager path and to
    the plain path; deepseek-moe-16b at full width and reduced depth against
    the plain path; K2 and K3 timed at both archs' shapes. Returns the
    kernels-line entries of the granite path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ServeRequest, _bucket

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    reqs = make_requests(cfg, args.requests, args.new_tokens, args.seed, ServeRequest)
    longest = max(reqs, key=lambda r: len(r.prompt))
    S, tb = len(longest.prompt), _bucket(args.new_tokens, base=8)
    # 7a. serving, both arms: one K2 launch a layer a request, one K3 launch
    # a layer a decode step, and nothing else
    ops.reset_counters()
    engines, results = serve_arms(cfg, reqs, args.seed, card_str, ph="7a")
    launches, plain = dict(ops.launches), dict(ops.plain)
    print(json.dumps({"counters": {"path": MOE_ARCH, "launches": launches, "plain": plain}}))
    expected = {"matmul": 0, "flash_attention": 2 * len(reqs) * cfg.n_layers,
                "decode_attention": 2 * len(reqs) * cfg.n_layers * tb}
    if launches != expected or max(plain.values()) != 0:
        raise PhaseError(f"{MOE_ARCH} launches {launches}, plain {plain}; expected {expected} "
                         f"launches and no plain call")
    print(f"[7a] launches exactly as the path needs: {expected}; no plain call")
    check_outputs(cfg, reqs, results, ph="7a")
    # 7b. captured against eager
    rows = captured_vs_eager(engines["baseline"], reqs, results["baseline"], ph="7b")
    # 7c. kernel path against plain path: f32, then bf16 on the serving weights
    f32_kernel_vs_plain(cfg, prompt_of(reqs[0]), args.new_tokens, args.seed, ph="7c")
    be = engines["baseline"].backend
    bf16_kernel_vs_plain(be.model, be.params, prompt_of(longest), ph="7c")
    # times: requests, captures, profiled steps, the MoE FFN's share, memory
    step_ms = time_requests(engines, reqs, rows, card_str, ph="7")
    moe_ffn_share(engines["baseline"], step_ms, card_str)
    graph_memory(engines, card_str, ph="7")
    cache_len = _bucket(S + tb, base=8)
    kernels = report_rows(
        [("flash_attention", flash_row((1, cfg.n_heads, cfg.n_kv_heads, S, cfg.head_dim))),
         ("decode_attention", decode_row((1, cfg.n_heads, cfg.n_kv_heads, cache_len, cfg.head_dim),
                                         S + tb // 2))],
        launches, card_str, "7", suffix=f"[{MOE_ARCH}]")
    del engines, results, be
    torch.cuda.empty_cache()
    # 7d. deepseek-moe-16b: full width, DEEPSEEK_LAYERS of its layers; the
    # shared experts, head_dim 128 and group 1 through K2 and K3
    ds = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=DEEPSEEK_LAYERS)
    prompt = torch.tensor(np.random.RandomState(args.seed).randint(0, ds.vocab, size=(1, S)),
                          dtype=torch.int32, device=DEVICE)
    from repro_torch.models.model import build_model

    mk = build_model(ds)
    params = mk.init(args.seed)
    bf16_kernel_vs_plain(mk, params, prompt, ph="7d")
    del mk, params
    torch.cuda.empty_cache()
    f32_kernel_vs_plain(ds, prompt, DEEPSEEK_STEPS, args.seed, ph="7d")
    report_rows(
        [("flash_attention", flash_row((1, ds.n_heads, ds.n_kv_heads, S, ds.head_dim))),
         ("decode_attention", decode_row((1, ds.n_heads, ds.n_kv_heads, cache_len, ds.head_dim),
                                         S + tb // 2))],
        None, card_str, "7d", suffix="[deepseek-moe-16b]")
    print(f"[7] phase 7 took {time.perf_counter() - t0:.1f} s")
    return kernels


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
    check_kernels(main_shapes, failures)
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
    f32_kernel_vs_plain(cfg, prompt_of(reqs[0]), args.new_tokens, args.seed)
    bf16_kernel_vs_plain(engines["baseline"].backend.model, engines["baseline"].backend.params,
                         prompt_of(max(reqs, key=lambda r: len(r.prompt))))

    # 6. times
    kernels = time_kernels(main_shapes, launches, card_str)
    time_requests(engines, reqs, rows, card_str)
    graph_memory(engines, card_str)
    del engines, results
    torch.cuda.empty_cache()

    # 7. the MoE family
    kernels += moe_phase(args, card_str)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
