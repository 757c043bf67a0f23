"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed 2] [--requests 8] [--new-tokens 32]

Run from the root of a checkout. It imports ``src/repro_torch`` (never
``jax``, never ``repro``) and, in order:

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, at the sweep shapes of ``tests/test_kernels.py`` and
   at the edge shapes of ``tests/test_torch_kernels_cuda.py``, and K2 with
   a sliding window (windows below, at and past S, not a multiple of 64,
   1; causal and not; GQA group 1 and 4; fewer queries than keys), in f32
   and bf16 (attention held per output row, so that the small outputs over
   whisper's 1,500 keys meet a limit of their size: ``row_limits``), and
   checks that two calls on the same inputs give bitwise the same output;
3. runs the Minos probe, ``MatmulProbe(n=512, repeats=8)``, on the card:
   ``run()`` is host time around the launches and a device synchronize, as
   ``repro``'s is; the same work's time between CUDA events is printed
   beside it;
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
   and times K2 and K3 at both archs' shapes; (e) holds the MoE's
   queue-position kernel to its plain cumsum form, bit for bit, on routing
   indices drawn on the card at granite's S 896 (32 experts, top-8) and
   granite-4.0-h-small's S 2,048 and 3,840 (72 experts, top-10), and times
   both beside the kernel's byte bound;
8. the encoder-decoder family and the pipeline: (a) serves ``--requests``
   requests (decoder start token ``1 + i % 7``, zero audio frames, as the
   pipeline's ASR stage sends them) on full-width whisper-small (12 + 12
   layers, 1,500 frames, bf16, random weights from ``--seed``) in both arms
   on the captured path, with the launches held exactly (one non-causal K2
   launch an encoder layer a request, two K3 launches, self and cross, a
   decoder layer a decode step); (b) holds captured serving to eager serving
   (cross K/V bitwise); (c) on random frames (zero frames make the encoder's
   output 0), holds the encoder output, the cross K/V and 32 decode steps'
   logits of the kernel path to the plain path in f32, and the same three
   in bf16 by phase 5's rule, each relative to its largest value; (e) times the requests, captures and steps
   as phase 6, and K2 non-causal over 1,500 frames and K3 over the 1,500-row
   cross cache; (d) runs whisper-small into llama3.2-1b, both at full width,
   as ``serving/pipeline.py`` wires them, through the three gate arms of
   ``benchmarks/pipeline_sweep.py`` (8 items each), and checks that the
   outputs are identical across arms and the launches exact per item;
9. the vectorized Monte-Carlo path (``simulate_arms``, ``simulate_open_arms``,
   batched over arms x seeds, the step loop captured as CUDA graphs), at the
   settings of ``benchmarks/grid_sweep.py``, ``loadaware_sweep`` and
   ``openloop_sweep._vec_leg`` rebuilt from the port: (a) the card against
   the CPU on shared draws (the port's CPU generator) for the grid's smoke
   and quick (adaptive) arms and the load-aware and open-loop smoke settings
   (integer summaries and rows equal, floats within 1e-4); (b) captured
   against eager on the card, bitwise, with no capture on a second call of a
   shape and one lane alone equal to it in a batch; (c) the closed loop on
   the card's own draws against the copied event engine at the reference's
   KS / 2pp / 1pp bounds; (d) times: capture, cached wall, lanes x steps a
   second, kernels a captured step and the idle share of a profiled replay,
   the step's byte bound and the speedup per arm over the event engine, for
   the full grid (1,080 arms x 4 seeds x 400 steps), the quick grid, and the
   load-aware and open-loop quick settings; the eager path on the smoke grid;
   the full grid with the whole scan in one graph; (e) the full grid at least
   20x per arm over the event engine. It launches no kernel of K1-K3;
10. the recurrent families: (a) serves the same requests on full-width
   zamba2-1.2b (38 Mamba2 layers, d_model 2048, 64 SSD heads of 64, d_state
   64, one shared attention block of 32/32 heads with window 4096 applied
   after each of the first 6 of its 7 Mamba groups; bf16, random weights
   from ``--seed``) in both arms on the captured path, with the launches
   held exactly (K2 once an application a request, K3 once an application a
   decode step, the SSD kernel once a Mamba2 layer a request, no plain
   call), captured against eager (K/V rows, SSD
   states and conv contexts), and the kernel path against the plain path in
   f32 (a 600-token prompt, three SSD chunks) and bf16 as phase 5; (b) the same requests on full-width xlstm-1.3b
   (6 x [7 mLSTM + 1 sLSTM], 4 heads, bf16), which launches no kernel and
   calls no plain version, captured against eager (the captured requests
   back to back on one static cache, the eager ones each from a fresh
   cache: tokens equal, states within 2e-2 of their largest value), one
   static cache a batch size, and the card against the CPU in f32 at full
   width and ``XLSTM_CPU_LAYERS`` layers (logits within 1e-4 of the
   largest, greedy tokens equal); (d) for both, phase 6's times, each
   decode step's byte bound, the graphs' memory, and K2 and K3 at zamba2's
   served shapes and K2 where the window masks (q(1,32,1024,64), window
   256) beside SDPA with a band mask; the SSD kernel at the documents'
   traffic's shortest and longest prompts (S 2048 and 3840, 8 and 15
   chunks), y and the final state held against the plain scan in f32 to
   1e-5 of their largest value, and timed against the plain scan;
11. training (``train/loop.py``, ``optim/adamw.py``): (a) full-width,
   full-depth llama3.2-1b (bf16 parameters, f32 master/mu/nu, remat on)
   takes 20 AdamW steps (``TrainConfig(peak_lr=1e-3, warmup_steps=2)``) at
   batch 4 x 2,048 from ``TokenStream(seed=--seed)`` through
   ``make_train_step``, with the launches held exactly (K2 twice a layer a
   step, the forward and the remat recompute; one plain recomputation a
   layer in the backward; no plain call, no K1 or K3), the loss finite and
   the mean of the last 5 steps below the first; (b) one f32 loss and its
   gradients at full width and 4 layers, the kernel path against the plain
   path (loss within 1e-5 relative, each gradient within 1e-4 of its largest
   |grad|), and one bf16 loss and its gradients at full width and 4 layers
   at 11a's batch (K2's bf16 body, as 11a runs it), the kernel path against
   the plain path within twice the plain path's own distance from an f32
   run of the same weights; (c) ``FlashAttention`` alone against autograd
   through the plain version: the bf16 kernel at 11a's shape (q(4,32,2048,64),
   kv(4,8,2048,64), causal), and wiring cases at phase 2's shapes (causal,
   non-causal, window 256, GQA group 1 and 4, fewer queries than keys; f32
   1e-4 of the largest value, bf16 phase 2's per-row limits); and the bf16
   kernel at 11a's shape on the kernels line's inputs, per row as phase 2
   holds it; (d) the same as (b) for granite-moe-1b-a400m (2 layers, the aux
   loss), whisper-small (2 + 2 layers, 1,500 frames: non-causal K2 and cross
   attention), zamba2-1.2b (one Mamba group and one shared-block
   application, 4,352 tokens so that the window masks; again at a second
   seed, and the plain path against itself on the batch doubled as a
   reading of the f32 rounding) with exact launches, and xlstm-1.3b (8
   layers, no kernel: the card against the CPU); (e) a checkpoint round trip (save after 3 steps, restore into fresh
   modules and state: step 4 bitwise equal); (f) 11a's times: step wall,
   forward, backward and optimizer (CUDA events), tokens/s, MFU, K2's and
   the plain attention backward's shares of a step and the idle share
   (``torch.profiler``), peak memory, the optimizer's byte bound, and K2 at
   the training shape beside SDPA.

12. multi-device and launch (M11): (a) ``python -m repro_torch.launch.serve``
   at its defaults on the card; (b) full-width llama3.2-1b (bf16) on a
   (1, 1) ("data", "model") NCCL mesh with ``DECODE_ATTN_MODE =
   "shard_map"`` and the cache placed along its length: the requests of
   phase 4, 32 greedy steps each, eagerly, with tokens identical to the
   unsharded eager path, logits within phase 5's bf16 limit, K3's
   log-sum-exp form launched exactly layers x steps x requests times (K2 once
   a layer a request, nothing else) and no collective (each is skipped at
   size 1; the merge's three all-reduces a call are held on gloo groups of
   2 and 4 ranks by the CPU tests); (c) the port's flash-decode
   (``models/attention.py``: ``flash_decode_slice``, K3's log-sum-exp form,
   on each of 4 and 8 slices of phase 2's main decode cache at their global
   offsets, the new row written by its slice, one slice past the prefix and
   one straddling it; ``merge_slices`` over the stacked slices) held per
   row to unsharded K3 and to the plain version in bf16 and f32, each
   slice's log-sum-exp within 1e-4 of the plain one's, the slices' caches
   bitwise the written cache; (d) the port's dry-run of
   llama3.2-1b at its four shapes, decode_32k with the length-sharded
   flash-decode, and train_4k under each of ``repro``'s hillclimb knobs
   (dp-only, fsdp, accum-steps 2, seq-parallel), on the 16x16 fake mesh (a
   child process: host work, no device): per-device FLOPs, HBM bytes,
   collective bytes by kind and the H100 data-sheet roofline terms, and
   each knob's argument, temp and wire bytes beside the baseline's; (e) K3
   with and without its log-sum-exp beside its bound, one request's eager
   decode step unsharded and sharded in turns, then each under
   ``torch.profiler`` (host time by op), and the same request's captured
   step unsharded and sharded in turns (ms a step, kernels a step, idle
   share); (f) 12b's requests through ``prefill_jit`` and ``decode_tokens``
   on the mesh (CUDA graphs of the placed model on its placed static
   cache), tokens bitwise the unsharded captured path's, K2 once a layer a
   request and K3's log-sum-exp form once a layer a step, counted by the
   replays, no plain call, no collective, and one decode graph for the
   sharded bucket apart from the unsharded one's.

13. the recurrent families placed (M11b-4): full-width zamba2-1.2b (38
   Mamba2 layers, the shared block after 6 of its 7 groups, bf16) on a
   (1, 1) ("data", "model") NCCL mesh, placed with ``place_params`` and
   ``place_cache``: phase 10a's requests through ``prefill_jit`` and
   ``decode_tokens`` (CUDA graphs of the placed model on its placed static
   cache), tokens bitwise the unsharded captured path's (captured before the
   mesh existed), K2 and K3 launched exactly as often as there, no plain
   call, no collective, one decode graph for each bucket; then full-width
   xlstm-1.3b the same way (no kernel launched). At one rank every split is
   trivial: the gloo cases of the CPU tests hold the split arithmetic; this
   holds the placed path's capture, cache placement and launches. The
   captured ms a decode step of each, sharded beside unsharded, in turns.

It exits non-zero, printing no result, if there is no CUDA device or any
phase fails. Its last two lines are the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import socket
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
    # repro's ssd_chunked (src/repro/models/ssm.py) is plain jnp: no Pallas kernel
    "ssd_chunked": ("src/repro_torch/kernels/csrc/ssd_chunk.cu", "none"),
    # so are repro's MoE queue positions (src/repro/models/moe.py)
    "moe_positions": ("src/repro_torch/kernels/csrc/moe_positions.cu", "none"),
}
# rtol = atol, per kernel and dtype (PERF.md says how each was set). bf16
# flash: the kernel rounds P to bf16 before PV, as the Pallas kernel does, and
# the plain version does not; its largest error over phase 2's cases on the
# card was 1.5625e-2 (one bf16 ulp at |out| in [2, 4)), so twice that. bf16
# decode: 2e-2 (measured at most 4.9e-4). bf16 matmul: 8 mantissa bits over a
# K-long sum, atol x10 as for f32. Attention's outputs shrink as the keys grow
# (about 0.2 at most over whisper's 1,500 keys), so the attention limits are
# held per output row by row_limits() below.
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
GRANITE4H_ROUTER = (72, 10)  # granite-4.0-h-small's experts and top-k (portbench/configs)
DEEPSEEK_STEPS = 8   # its teacher-forced f32 decode steps
WHISPER = "whisper-small"  # phase 8's served arch, the pipeline's ASR stage
ZAMBA = "zamba2-1.2b"  # phase 10's hybrid: Mamba2 and a shared windowed attention block
XLSTM = "xlstm-1.3b"   # phase 10's xLSTM: no kernel on its path
XLSTM_CPU_LAYERS = 8   # one plan group (7 mLSTM + 1 sLSTM): the card against the CPU in f32
XLSTM_CPU_STEPS = 8    # its teacher-forced decode steps


class PhaseError(RuntimeError):
    pass


def kernel_counts(**given) -> dict:
    """Every kernel's count: ``given``'s, 0 for the others."""
    from repro_torch.kernels import _build

    return _build.counts(**given)


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


def row_limits(want, dtype, tol):
    """rtol = atol for each row (last axis) of an attention output: ``tol``,
    or where the row's largest |want| is smaller than the |out| in [2, 4) that
    ``tol`` was set at, in bf16 two ulps at that largest value (the measured
    worst error is one), in f32 ``tol`` times it. A row of zeros must match
    exactly. As tests/test_torch_kernels_cuda.py holds them."""
    top = want.float().abs().amax(-1, keepdim=True)
    if dtype == torch.bfloat16:
        scaled = 2 * torch.exp2(torch.floor(torch.log2(top)) - 7)
    else:
        scaled = tol * top
    return torch.clamp(scaled, max=tol)


def compare(name, fn, want, failures, worst, *, tol, atol_scale=1.0, per_row=False):
    """Holds ``fn()`` against ``want``, and a second call against the first:
    within rtol = ``tol``, atol = ``tol * atol_scale``, or with ``per_row``
    within :func:`row_limits`. ``worst`` keeps the largest error per kernel
    and dtype (the first two words of ``name``), with |want| where it
    occurred, and the largest share of its limit that any error took."""
    got = fn()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if per_row:
        lim = row_limits(want, got.dtype, tol)
        allowed = lim + lim * want.float().abs()
    else:
        allowed = tol * atol_scale + tol * want.float().abs()
    share = (diff / allowed).nan_to_num(nan=0.0, posinf=float("inf")).max().item()
    key = " ".join(name.split()[:2])
    e0, w0, s0 = worst.get(key, (0.0, 0.0, 0.0))
    if err >= e0:
        e0, w0 = err, want.float().flatten()[diff.argmax()].abs().item()
    worst[key] = (e0, w0, max(s0, share))
    if share > 1 or not torch.isfinite(got.float()).all():
        limit = f"per-row limit, {share:.2f} of it" if per_row else f"rtol {tol}, atol {tol * atol_scale}"
        failures.append(f"{name}: max_abs_err {err:.3e} ({limit})")
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
    # whisper-small: its encoder over 1,500 frames, and decoder queries over them
    (1, 12, 12, 1500, 1500, 64), (1, 12, 12, 9, 1500, 64),
]
# K2 with a sliding window, as in tests/test_torch_kernels_cuda.py: GQA group
# 1 and 4, ragged tails, fewer queries than keys, zamba2's 32/32 heads at a
# served prompt and at the windowed timing shape; windows below S, not a
# multiple of 64, 1 (each row its own key), and past S (zamba2's 4096)
FLASH_WINDOW_SHAPES = [
    (1, 8, 8, 200, 200, 64), (2, 8, 2, 130, 130, 128), (1, 32, 8, 77, 250, 64),
    (1, 4, 4, 65, 65, 96), (1, 32, 32, 250, 250, 64), (1, 32, 32, 1024, 1024, 64),
]
FLASH_WINDOWS = (1, 37, 64, 100, 256, 4096)


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
                                worst, tol=TOL["flash_attention"][dtype], per_row=True)
                        n_cases += 1
        for b_, qh, kvh, sq, skv, d in FLASH_EDGES:
            for causal in (True, False):
                q = rand((b_, qh, sq, d), dtype, 2)
                k, v = rand((b_, kvh, skv, d), dtype, 3), rand((b_, kvh, skv, d), dtype, 4)
                compare(f"flash {dtype} {(b_, qh, kvh, sq, skv, d)} causal={causal}",
                        lambda: flash_attention(q, k, v, causal=causal),
                        ref.attention_ref(q, k, v, causal=causal), failures, worst,
                        tol=TOL["flash_attention"][dtype], per_row=True)
                n_cases += 1
        for b_, qh, kvh, sq, skv, d in FLASH_WINDOW_SHAPES:
            q = rand((b_, qh, sq, d), dtype, 2)
            k, v = rand((b_, kvh, skv, d), dtype, 3), rand((b_, kvh, skv, d), dtype, 4)
            for window in FLASH_WINDOWS:
                for causal in (True, False):
                    compare(f"flash {dtype} {(b_, qh, kvh, sq, skv, d)} causal={causal} "
                            f"window={window}",
                            lambda: flash_attention(q, k, v, causal=causal, window=window),
                            ref.attention_ref(q, k, v, causal=causal, window=window), failures,
                            worst, tol=TOL["flash_attention"][dtype], per_row=True)
                    n_cases += 1
        b_, qh, kvh, s, d = main_shapes["flash"]
        q, k, v = rand((b_, qh, s, d), dtype, 5), rand((b_, kvh, s, d), dtype, 6), rand((b_, kvh, s, d), dtype, 7)
        compare(f"flash {dtype} main {main_shapes['flash']}",
                lambda: flash_attention(q, k, v), ref.attention_ref(q, k, v), failures,
                worst, tol=TOL["flash_attention"][dtype], per_row=True)
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
                (2, 32, 8, 512, 64, [3, 20]), (4, 8, 2, 300, 64, [300, 17, 1, 150]),
                (1, 12, 12, 1500, 64, [1500])):  # whisper's cross cache
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
                    tol=TOL["decode_attention"][dtype], per_row=True)
            n_cases += 1
        q, k, v = rand((2, 4, 1, 64), dtype, 12), rand((2, 2, 256, 64), dtype, 13), rand((2, 2, 256, 64), dtype, 14)
        out = decode_attention(q, k, v, torch.tensor([0, 3], dtype=torch.int32, device=DEVICE))
        if not torch.all(out[0] == 0):
            failures.append(f"decode {dtype}: length 0 did not give zeros")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain: {n_cases} cases, {len(failures)} failures (rtol = atol: f32 "
          f"2e-3; bf16 flash 3.125e-2, decode 2e-2, matmul 5e-2; matmul atol x10 as in "
          f"tests/test_kernels.py; attention held per output row, below these where the row's "
          f"largest |plain| is small: bf16 two ulps there, f32 2e-3 of it; every case called "
          f"twice and compared bitwise; K2 also with a sliding window, "
          f"{len(FLASH_WINDOW_SHAPES) * len(FLASH_WINDOWS) * 2} cases a dtype)")
    print("[2] largest max_abs_err over the cases (at |plain|; largest share of a limit): "
          + "; ".join(f"{k.replace('torch.', '')} {e:.4e} ({w:.4f}; {sh:.3f})"
                      for k, (e, w, sh) in sorted(worst.items())))
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


def request_inputs(be, req):
    """What backend ``be`` feeds its model for ``req``: (prefill batch, the
    first decode token, the cache rows prefill fills; an encoder-decoder's
    decoder starts empty)."""
    batch, tok = be.prefill_inputs(prompt_of(req))
    return batch, tok, 0 if "frames" in batch else len(req.prompt)


def finish(out) -> None:
    """Wait for the device, reading ``out`` back as serving does (a graph
    that returns nothing, an encdec prefill's, is only synchronized)."""
    if out is not None:
        out.cpu()
    torch.cuda.synchronize()


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


def serve_and_count(cfg, reqs, args, card_str, expected, ph):
    """Serves ``reqs`` in both arms (phase 4's ``serve_arms``) with the
    counters at 0 first; holds the launches to ``expected`` and no plain
    call, and the tokens across arms. Returns (engines, results, launches)."""
    from repro_torch.kernels import ops

    ops.reset_counters()
    engines, results = serve_arms(cfg, reqs, args.seed, card_str, ph=ph)
    launches, plain = dict(ops.launches), dict(ops.plain)
    print(json.dumps({"counters": {"path": cfg.arch_id, "launches": launches, "plain": plain}}))
    if launches != expected or max(plain.values()) != 0:
        raise PhaseError(f"{cfg.arch_id} launches {launches}, plain {plain}; expected {expected} "
                         f"launches and no plain call")
    print(f"[{ph}] launches exactly as the path needs: {expected}; no plain call")
    check_outputs(cfg, reqs, results, ph=ph)
    return engines, results, launches


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
    order = "attention's and the SSD scan's" if cfg.family == "hybrid" else "attention's"
    print(f"[{ph}] f32 {cfg.arch_id} full width ({cfg.n_layers} layers), one {prompt.shape[1]}-token "
          f"prompt, {T} steps: max |logit difference| / max |logit| = {worst:.3e} (tolerance 1e-4: "
          f"the paths differ only in {order} summation order); greedy tokens equal: "
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


def f32_copy(cfg, params, device=DEVICE):
    """A plain-path f32 model and an f32 copy of ``params`` on ``device``."""
    from repro_torch.models.model import build_model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = type(params)(cfg32, torch.device(device))
    with torch.no_grad():
        for a, b in zip(p32.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    return build_model(cfg32, device=device, use_kernels=False), p32


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def flash_row(shape, causal=True, window=None):
    """K2 at ``shape`` (batch, q heads, kv heads, S, d), bf16 (the inputs of
    phase 2's main case), with an optional sliding ``window``: (shape text,
    max_abs_err, kernel ms, plain ms, library ms, bound ms, bound by). The
    library call is SDPA, with a band mask where the window masks keys."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    bq, qh, kvh, s, d = shape
    q, k, v = rand((bq, qh, s, d), torch.bfloat16, 5), rand((bq, kvh, s, d), torch.bfloat16, 6), rand((bq, kvh, s, d), torch.bfloat16, 7)
    # the (q, k) pairs this input needs
    pos = torch.arange(s, device=DEVICE)
    keep = torch.ones((s, s), dtype=torch.bool, device=DEVICE)
    if causal:
        keep &= pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= pos[:, None] - pos[None, :] < window
    pairs = bq * qh * int(keep.sum())
    bms, by = bound(2 * (2 * bq * qh * s * d + 2 * bq * kvh * s * d), 4 * d * pairs, torch.bfloat16)
    if window is None or window >= s:  # the window masks nothing: SDPA's own causal path
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep, enable_gqa=True)  # noqa: E731
    kw = dict(causal=causal, window=window)
    text = f"q({bq},{qh},{s},{d}) kv({bq},{kvh},{s},{d}) bf16 {'causal' if causal else 'non-causal'}"
    if window is not None:
        text += f" window {window}" + (" (masks nothing)" if window >= s else "")
    return (text,
            max_err(flash_attention(q, k, v, **kw), ref.attention_ref(q, k, v, **kw)),
            graph_ms(lambda: flash_attention(q, k, v, **kw)),
            graph_ms(lambda: ref.attention_ref(q, k, v, **kw)), graph_ms(lib), bms, by)


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


def ssd_flops(B, S, H, N, P, L) -> int:
    """The products of the chunked SSD, two operations a multiply-add: C.B
    once a chunk for every head (one group), and for each head the
    intra-chunk product over the pairs j <= i, C_i.H_c and the chunk's own
    state at each position."""
    flops = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n + 1) // 2
        flops += 2 * N * pairs + H * (2 * P * pairs + 2 * 2 * N * P * n)
    return B * flops


def ssd_row(S, H, N, chunk, P=None):
    """The SSD kernel at zamba2's shape, x (1, S, H, P) bf16 with d_state N
    (P = N unless given: granite-4.0-h's heads are 64 over a state of 128)
    and one group, its x, Bm and Cm slices of one packed (1, S, H P + 2 N)
    tensor as the conv's output hands them over; ``dt`` the model's softplus
    of a projection, ``A`` its initial -linspace(1, 16, H). y and the final
    state are held against the plain scan in f32 (the same bf16 values
    widened) to 1e-5 of max |want| (``tests/test_torch_ssm.py``'s rule), once
    as the model's ``dt`` gives them and once with ``dt`` a hundred times
    smaller, so that the state carried over the chunks reaches every row;
    the bf16 call must give the f32 call's y rounded and its state bit for
    bit. Then both timed in bf16, as :func:`flash_row`; no library has the
    scan."""
    from repro_torch.kernels.ssd_chunk import ssd_chunked
    from repro_torch.models.ssm import ssd_chunked as plain_scan

    P = P or N
    gen = torch.Generator(device=DEVICE).manual_seed(S)
    packed = torch.randn(1, S, H * P + 2 * N, generator=gen, device=DEVICE).to(torch.bfloat16)

    def split(t):
        return t[..., :H * P].reshape(1, S, H, P), t[..., H * P:H * P + N], t[..., H * P + N:]
    x16, B16, C16 = split(packed)
    x32, B32, C32 = split(packed.float())
    dt = F.softplus(torch.randn(1, S, H, generator=gen, device=DEVICE))
    A = -torch.linspace(1.0, 16.0, H, device=DEVICE)
    D = torch.randn(H, generator=gen, device=DEVICE)
    errs, abs_err, same = [], 0.0, True
    with torch.no_grad():
        for scale in (1.0, 0.01):
            want_y, want_h = plain_scan(x32, dt * scale, A, B32, C32, D, chunk=chunk)
            y, h = ssd_chunked(x32, dt * scale, A, B32, C32, D, chunk=chunk)
            y16, h16 = ssd_chunked(x16, dt * scale, A, B16, C16, D, chunk=chunk)
            errs.append(tuple(max_err(a, b) / b.abs().max().item()
                              for a, b in ((y, want_y), (h, want_h))))
            abs_err = max(abs_err, max_err(y, want_y))
            same &= torch.equal(y16, y.to(torch.bfloat16)) and torch.equal(h16, h)
    text = (f"x(1,{S},{H},{P}) bf16 strided, d_state {N}, chunk {chunk} "
            f"({-(-S // chunk)} chunks)")
    print(f"[10d] ssd_chunked {text}: y, h within {errs[0][0]:.2e}, {errs[0][1]:.2e} of max "
          f"|want| (dt x 0.01: {errs[1][0]:.2e}, {errs[1][1]:.2e}; rule 1e-5); bf16 call the "
          f"f32 call rounded: {same}")
    if max(max(e) for e in errs) > 1e-5 or not same:
        raise PhaseError(f"ssd_chunked kernel disagrees with the plain scan at S {S}")
    nbytes = (2 * (S * H * P + 2 * S * N) * packed.element_size()  # x, Bm, Cm read; y written
              + 4 * (S * H + H * N * P + 2 * H))                    # dt, h_final, A, D
    bms, by = bound(nbytes, ssd_flops(1, S, H, N, P, chunk), torch.float32)
    return (text, abs_err,
            graph_ms(lambda: ssd_chunked(x16, dt, A, B16, C16, D, chunk=chunk)),
            graph_ms(lambda: plain_scan(x16, dt, A, B16, C16, D, chunk=chunk)), None, bms, by)


def report_rows(rows, launches, card_str, ph, suffix=""):
    """Prints ``(name, row)`` pairs and returns their entries of the
    ``kernels`` JSON line, named ``name + suffix``; ``launches`` None: a
    shape that no served path runs (the entries are then not for that line);
    a library ms of None: no library has the operation."""
    out = []
    for name, (shape, err, ms, plain_ms, lib_ms, bms, by) in rows:
        where = ("not on a served path" if launches is None
                 else f"launches on the main path {launches[name]}")
        lib = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
        print(f"[{ph}] {name + suffix:16s} {shape}: kernel {ms:.5f} ms | bound {bms:.5f} ms ({by}) | "
              f"plain {plain_ms:.5f} ms | library {lib} | max_abs_err {err:.4e} | "
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
    rows, worst, worst_state = [], 0.0, 0.0
    for req, res in zip(reqs, served):
        S, T = len(req.prompt), req.max_new_tokens
        Tb = _bucket(T, base=be.decode_bucket)
        cache_len = _bucket(S + Tb, base=be.decode_bucket)
        batch, tok, filled = request_inputs(be, req)
        caches = {"captured": model.static_cache(1, cache_len),
                  "eager": model.init_cache(1, cache_len)}
        toks, times = {}, {}
        for path, cache in caches.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            if path == "captured":
                model.prefill_jit(params, batch, cache)
            else:
                model.prefill(params, batch, cache)
            ev[1].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if path == "captured":
                out = model.decode_tokens(params, cache, tok, Tb)[0]
            else:
                out = eager_decode(model, params, cache, tok, Tb)
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
        diff = max(((a[n][:, :, :, :filled + Tb].float() - b[n][:, :, :, :filled + Tb].float()
                     ).abs().max().item() for n in KV_ROWS if n in a), default=0.0)
        worst = max(worst, diff)
        if diff > tol or not torch.equal(a["lengths"], b["lengths"]):
            raise PhaseError(f"request {req.request_id}: captured K/V rows differ from eager "
                             f"by {diff:.3e}")
        if not all(torch.equal(a[n], b[n]) for n in a if n.startswith("cross_")):
            raise PhaseError(f"request {req.request_id}: captured cross K/V differ from eager")
        # recurrent state (SSD states, conv contexts, mLSTM/sLSTM states),
        # relative to its largest value
        states = [n for n in a if a[n].is_floating_point() and n not in KV_ROWS
                  and not n.startswith("cross_")]
        srel = max(((a[n].float() - b[n].float()).abs().max().item()
                    / max(b[n].float().abs().max().item(), 1e-30) for n in states), default=0.0)
        worst_state = max(worst_state, srel)
        if srel > tol:
            raise PhaseError(f"request {req.request_id}: captured recurrent state differs from "
                             f"eager by {srel:.3e} of its largest value")
        rows.append((req.request_id, S, Tb, times))
    cross = "; cross K/V bitwise equal" if model.cfg.family == "encdec" else ""
    state = (f"; recurrent state max |diff| / max |value| {worst_state:.4e} (tolerance {tol})"
             if states else "")
    kv = (f"; K/V rows max |diff| {worst:.4e} (tolerance {tol}, the bf16 decode tolerance)"
          if any(n in a for n in KV_ROWS) else "")
    print(f"[{ph}] captured vs eager, {len(reqs)} requests: tokens equal (and equal to the served "
          f"ones; the captured requests ran back to back on one static cache, the eager ones "
          f"each on a fresh cache){kv}{state}{cross}")
    return rows


KV_ROWS = ("k", "v", "attn_k", "attn_v")  # caches whose rows prefill and decode write


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (kernels, copies and sets, summed
    device ms, ms from the first device activity's start to the last one's
    end)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return profiled_events(prof)


def profiled_events(prof):
    """``profiled``'s numbers from a finished ``torch.profiler`` trace."""
    from torch.autograd import DeviceType

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
    batch, tok, filled = request_inputs(be, req)
    tok = tok.clone()
    cache = model.init_cache(1, filled + 64)
    model.prefill(params, batch, cache)
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
    runs = {"prefill": lambda: model.prefill_jit(params, batch, static)[0],
            "decode": lambda: model.decode_tokens(params, static, tok, Tb)[0]}
    for name, fn in runs.items():
        walls, spans = [], []
        for i in range(5):
            static["lengths"].fill_(filled)  # back to the end of the prompt
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = fn()
            end.record()
            sampled = clocks() if i == 4 else None
            finish(out)
            walls.append((time.perf_counter() - t0) * 1e3)
            spans.append(start.elapsed_time(end))
        static["lengths"].fill_(filled)
        kernels, copies, busy, trace, dev = profiled(lambda: finish(fn()))
        wall, span = float(np.mean(walls[:4])), float(np.mean(spans[:4]))
        what = f"decode loop (prompt {S}, {Tb} steps)" if name == "decode" else \
            f"prefill (prompt {S})" if "tokens" in batch else \
            f"prefill (encoder over {model.cfg.encoder_frames} frames)"
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
        print(f"[{ph}] {name} arm: {len(g.graphs)} graphs hold {static / 1e6:.3f} MB "
              f"({static / 2**20:.3f} MiB) of static caches ({len(g.caches)}) and "
              f"{pool / 1e6:.3f} MB ({pool / 2**20:.3f} MiB) in their memory pool ({card_str})")


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


def moe_positions_row(S, E, K):
    """The queue-position kernel on one row of ``S`` tokens routed to ``K``
    of ``E`` experts each, drawn on the card as the router gives them (the
    top ``K`` of uniform draws: ``K`` distinct experts a token): (shape text,
    max_abs_err, kernel ms, plain ms, library ms, bound ms, bound by) as
    :func:`flash_row`. The positions must equal the plain cumsum form's bit
    for bit. The bound is the kernel's bytes at 3.35 TB/s: each int64 index
    read once and each int32 position written once. No library has it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_positions import CHUNK, moe_positions

    gen = torch.Generator(device=DEVICE).manual_seed(S * E + K)
    idx = torch.rand(1, S, E, generator=gen, device=DEVICE).topk(K, dim=-1).indices
    got, want = moe_positions(idx, E), ref.moe_positions_ref(idx, E)
    same = torch.equal(got, want)
    text = f"idx(1,{S},{K}) int64 over {E} experts ({-(-S * K // CHUNK)} chunks)"
    print(f"[7e] moe_positions {text}: positions equal to the cumsum form's: {same} (longest "
          f"queue {int(want.max()) + 1} of {S * K} pairs)")
    if not same:
        raise PhaseError(f"moe_positions kernel disagrees with the cumsum form at S {S}, E {E}")
    bms, by = bound(12 * S * K, 0, torch.float32)
    return (text, max_err(got, want), graph_ms(lambda: moe_positions(idx, E)),
            graph_ms(lambda: ref.moe_positions_ref(idx, E)), None, bms, by)


def moe_positions_phase(cfg, launches, card_str):
    """7e: the queue-position kernel alone at granite's longest chat prompt
    (``launches``: phase 7a's) and at granite-4.0-h-small's docs prompts.
    Returns the kernels-line entry of the granite row."""
    rows = report_rows([("moe_positions", moe_positions_row(896, cfg.moe.n_experts,
                                                            cfg.moe.top_k))],
                       launches, card_str, "7e", suffix=f"[{cfg.arch_id} S 896]")
    for S in (2048, 3840):
        report_rows([("moe_positions", moe_positions_row(S, *GRANITE4H_ROUTER))],
                    None, card_str, "7e", suffix=f"[granite-4.0-h S {S}]")
    return rows


def moe_phase(args, card_str):
    """Phase 7: granite-moe-1b-a400m served at full width behind the gate on
    the captured path, held to its exact launches, to the eager path and to
    the plain path; deepseek-moe-16b at full width and reduced depth against
    the plain path; K2 and K3 timed at both archs' shapes. Returns the
    kernels-line entries of the granite path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.backend import ServeRequest, _bucket

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    reqs = make_requests(cfg, args.requests, args.new_tokens, args.seed, ServeRequest)
    longest = max(reqs, key=lambda r: len(r.prompt))
    S, tb = len(longest.prompt), _bucket(args.new_tokens, base=8)
    # 7a. serving, both arms: one K2 launch a layer a request, one K3 launch
    # a layer a decode step, one queue-position call a layer a prefill and a
    # decode step, and nothing else
    expected = kernel_counts(flash_attention=2 * len(reqs) * cfg.n_layers,
                             decode_attention=2 * len(reqs) * cfg.n_layers * tb,
                             moe_positions=2 * len(reqs) * cfg.n_layers * (1 + tb))
    engines, results, launches = serve_and_count(cfg, reqs, args, card_str, expected, "7a")
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
    kernels += moe_positions_phase(cfg, launches, card_str)
    print(f"[7] phase 7 took {time.perf_counter() - t0:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# phase 8: the encoder-decoder family and the ASR→LLM pipeline
# ---------------------------------------------------------------------------


def whisper_requests(n, new_tokens, ServeRequest):
    """The pipeline's ASR requests (``build_asr_llm_pipeline``): the decoder
    starts from token ``1 + i % 7``; the audio window is zero frames."""
    return [ServeRequest(prompt=np.asarray([1 + i % 7], np.int32), max_new_tokens=new_tokens,
                         request_id=i) for i in range(n)]


def whisper_bounds(cfg) -> tuple[float, float, float]:
    """(encoder prefill FLOP, its bound ms, decode step bound ms) at full
    width, batch 1, bf16. Prefill: the encoder's projections, attention and
    SwiGLU over every frame, and each decoder layer's cross K/V projection,
    over the bf16 peak. A decode step: the decoder's and the unembedding's
    weights and the cross cache, each read once, over the memory rate."""
    F, d, ff, hd = cfg.encoder_frames, cfg.d_model, cfg.d_ff, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * F * d * hd * (2 * H + 2 * K)
    layer = proj + 4 * F * F * H * hd + 6 * F * d * ff
    flop = cfg.n_encoder_layers * layer + cfg.n_layers * 4 * F * d * K * hd
    attn = d * hd * (2 * H + 2 * K)
    weights = cfg.n_layers * (2 * attn + 3 * d * ff + 3 * d) + d * cfg.vocab + d
    cross = cfg.n_layers * 2 * K * F * hd
    step_bytes = 2 * (weights + cross)
    return flop, flop / PEAK_FLOPS[torch.bfloat16] * 1e3, step_bytes / HBM_BYTES_PER_S * 1e3


def encdec_f32_kernel_vs_plain(cfg, frames, T, seed, ph="8c"):
    """On ``frames`` (random: served audio is zeros, which makes the
    encoder's output 0), in f32 with fresh weights from ``seed``: the
    encoder output, the cross K/V and ``T`` teacher-forced decode steps'
    logits on the kernel path against the plain path, each within 1e-4 of
    the largest value; greedy tokens equal."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model, greedy_token

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    paths = {"kernel": build_model(cfg32), "plain": build_model(cfg32, use_kernels=False)}
    params = paths["kernel"].init(seed)
    enc, caches = {}, {}
    for name, m in paths.items():
        with ops.plain_path(not m.use_kernels):
            enc[name] = encdec.encode(cfg32, params, frames)
        caches[name] = m.init_cache(1, T)
        m.prefill(params, {"frames": frames}, caches[name])

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    errs = {"encoder": rel(enc["kernel"], enc["plain"])}
    for n in ("cross_k", "cross_v"):
        errs[n] = rel(caches["kernel"][n], caches["plain"][n])
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEVICE)
    toks, worst = {"kernel": [], "plain": []}, 0.0
    for _ in range(T):
        step = {name: m.decode_step(params, caches[name], tok)[0] for name, m in paths.items()}
        worst = max(worst, rel(step["kernel"], step["plain"]))
        for name in paths:
            toks[name].append(greedy_token(step[name]))
        tok = toks["kernel"][-1]  # teacher-forced: both paths see the kernel path's tokens
    errs["decode logits"] = worst
    same = torch.equal(torch.cat(toks["kernel"], 1), torch.cat(toks["plain"], 1))
    print(f"[{ph}] f32 {cfg.arch_id} full width ({cfg.n_encoder_layers} + {cfg.n_layers} layers), "
          f"random frames, {T} decode steps, max |difference| / max |value|, kernel path against "
          f"plain path: " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance 1e-4); greedy tokens equal: {same}")
    if max(errs.values()) > 1e-4 or not same or not torch.isfinite(enc["kernel"]).all():
        raise PhaseError(f"f32 kernel path disagrees with the plain path ({cfg.arch_id})")


def encdec_bf16_kernel_vs_plain(mk, params, frames, T, ph="8c"):
    """The serving weights in bf16 on ``frames``: the encoder output, the
    cross K/V that prefill stores, and ``T`` teacher-forced decode steps'
    logits (the kernel path's greedy tokens) on the kernel path, the plain
    path and a plain f32 copy. Each is held to the rule of
    :func:`bf16_kernel_vs_plain`, relative to its largest value: the kernel
    path within ``BF16_LOGIT_LIMIT`` of the plain path, or within twice the
    plain path's distance from f32 where that is larger."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model, greedy_token

    m32, p32 = f32_copy(mk.cfg, params)
    runs = {"kernel": (mk, params), "plain": (build_model(mk.cfg, use_kernels=False), params),
            "f32": (m32, p32)}
    values = {"encoder": {}, "cross_k": {}, "cross_v": {}, "decode logits": {}}
    caches = {}
    for name, (m, w) in runs.items():
        with ops.plain_path(not m.use_kernels):
            values["encoder"][name] = encdec.encode(m.cfg, w, frames).float()
        caches[name] = m.init_cache(1, T)
        m.prefill(w, {"frames": frames}, caches[name])
        for n in ("cross_k", "cross_v"):
            values[n][name] = caches[name][n].float()
    logits = {name: [] for name in runs}
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEVICE)
    for _ in range(T):
        for name, (m, w) in runs.items():
            logits[name].append(m.decode_step(w, caches[name], tok)[0].float())
        tok = greedy_token(logits["kernel"][-1])
    values["decode logits"] = {name: torch.cat(v, 1) for name, v in logits.items()}
    del m32, p32, runs, caches, logits

    def rel(x, a, b):
        return (x[a] - x[b]).abs().max().item() / x[b].abs().max().item()

    failed, parts = [], []
    for what, x in values.items():
        err, from_f32 = rel(x, "kernel", "plain"), rel(x, "plain", "f32")
        limit = max(BF16_LOGIT_LIMIT, 2 * from_f32)
        parts.append(f"{what} {err:.3e} (limit {limit:.3e}; plain from f32 {from_f32:.3e}, "
                     f"kernel from f32 {rel(x, 'kernel', 'f32'):.3e}; max |value| "
                     f"{x['plain'].abs().max().item():.4f})")
        if not torch.isfinite(x["kernel"]).all().item() or err > limit:
            failed.append(what)
    print(f"[{ph}] bf16 {mk.cfg.arch_id} full width, random frames, {T} decode steps, max "
          f"|difference| / max |value|, kernel against plain path (limit {BF16_LOGIT_LIMIT:.1e}, or "
          f"twice the plain path's distance from f32): " + "; ".join(parts))
    if failed:
        raise PhaseError(f"bf16 kernel path disagrees with the plain path ({mk.cfg.arch_id}): "
                         f"{', '.join(failed)}")


def pipeline_phase(args, card_str, n_items=8):
    """Phase 8d: whisper-small feeding llama3.2-1b, both at full width, as
    ``build_asr_llm_pipeline`` wires them (its request functions, its
    backends' settings from ``PipelineSpec()``), through the three gate arms
    of ``benchmarks/pipeline_sweep.py``; outputs identical across arms and
    launches exact per item."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ModelServingBackend, _bucket
    from repro_torch.serving.pipeline import (
        PIPELINE_ARMS, PipelineSpec, build_asr_llm_pipeline, pipeline_arm_factory,
        pipeline_pricing)
    from repro_torch.sim.variation import VariationModel
    from repro_torch.sim.workflow_dag import WorkflowDAG, WorkflowEngine, run_workflow_batch

    spec = PipelineSpec()
    vm = VariationModel(sigma=spec.speed_sigma)
    # build_asr_llm_pipeline builds smoke-size backends: build it on the CPU,
    # keep its stages' request functions and give them full-width backends
    smoke, _ = build_asr_llm_pipeline(spec, seed=args.seed, variation=vm, device="cpu")
    load_kw = dict(per_instance_concurrency=spec.per_instance_concurrency,
                   load_slowdown_alpha=spec.load_slowdown_alpha,
                   gate_load_aware=spec.gate_load_aware, decode_mode=spec.decode_mode)
    cfgs = {"asr": get_config(spec.asr_arch), "llm": get_config(spec.llm_arch)}
    backends = {
        name: ModelServingBackend(cfgs[name], seed=args.seed + i, variation=vm,
                                  probe_work_ms=spec.probe_work_ms, weight_load_ms=load_ms,
                                  contention_rho=spec.contention_rho, max_pool=spec.max_pool,
                                  name=name, **load_kw)
        for i, (name, load_ms) in enumerate((("asr", spec.asr_weight_load_ms),
                                             ("llm", spec.llm_weight_load_ms)))}
    dag = WorkflowDAG([dataclasses.replace(smoke.stages[n], backend=backends[n]) for n in backends],
                      name=smoke.name)
    outputs = {}
    ops.reset_counters()
    for arm in PIPELINE_ARMS:
        eng = WorkflowEngine(dag, vm, pipeline_arm_factory(arm), pricing=pipeline_pricing(),
                             seed=args.seed)
        t0 = time.perf_counter()
        run = run_workflow_batch(eng, n_items=n_items, inter_arrival_ms=400.0,
                                 payload_fn=lambda i: {"audio_id": i})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run.items.sort(key=lambda it: it.item_id)
        outputs[arm] = [(it.stage_results["asr"].output, it.stage_results["llm"].output)
                        for it in run.items]
        print(f"[8d] {arm:8s}: {run.n_items} items in {wall:.3f} s wall, {wall / run.n_items * 1e3:.3f} "
              f"ms an item | simulated: item latency {run.mean_item_latency_ms:.1f} ms, body "
              f"{run.mean_item_analysis_ms:.1f} ms, cost ${run.cost.total / run.n_items:.6f} an "
              f"item, replicas started {eng.instances_started} terminated "
              f"{eng.instances_terminated} ({card_str})")
    launches, plain = dict(ops.launches), dict(ops.plain)
    print(json.dumps({"counters": {"path": "pipeline", "launches": launches, "plain": plain}}))
    asr, llm = cfgs["asr"], cfgs["llm"]
    tb_asr, tb_llm = _bucket(spec.transcript_tokens, base=8), _bucket(spec.answer_tokens, base=8)
    items = len(PIPELINE_ARMS) * n_items
    expected = kernel_counts(
        flash_attention=items * (asr.n_encoder_layers + llm.n_layers),
        decode_attention=items * (2 * asr.n_layers * tb_asr + llm.n_layers * tb_llm))
    if launches != expected or max(plain.values()) != 0:
        raise PhaseError(f"pipeline launches {launches}, plain {plain}; expected {expected} "
                         f"launches and no plain call")
    for arm in PIPELINE_ARMS[1:]:
        for (a_asr, a_llm), (b_asr, b_llm) in zip(outputs[PIPELINE_ARMS[0]], outputs[arm]):
            if not (np.array_equal(a_asr, b_asr) and np.array_equal(a_llm, b_llm)):
                raise PhaseError(f"pipeline outputs differ between arms disabled and {arm}")
    first = outputs[PIPELINE_ARMS[0]][0]
    print(f"[8d] launches exactly as the path needs: {expected} ({items} items: ASR "
          f"{asr.n_encoder_layers} K2 + {2 * asr.n_layers} x {tb_asr} K3, LLM {llm.n_layers} K2 + "
          f"{llm.n_layers} x {tb_llm} K3 each); no plain call; outputs identical across "
          f"{list(PIPELINE_ARMS)}; item 0: transcript {first[0].tolist()}, answer {first[1].tolist()}")
    del dag, backends, smoke


def encdec_phase(args, card_str):
    """Phase 8: whisper-small served at full width behind the gate on the
    captured path (8a), held to eager serving (8b) and, on random frames, to
    the plain path (8c); the full-width ASR→LLM pipeline (8d); then times
    (8e). Returns the kernels-line entries of the served whisper path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.backend import ServeRequest, _bucket

    t0 = time.perf_counter()
    cfg = get_config(WHISPER)
    reqs = whisper_requests(args.requests, args.new_tokens, ServeRequest)
    tb = _bucket(args.new_tokens, base=8)
    # 8a. serving, both arms: one K2 launch an encoder layer a request, two
    # K3 launches (self and cross) a decoder layer a decode step
    expected = kernel_counts(flash_attention=2 * len(reqs) * cfg.n_encoder_layers,
                             decode_attention=2 * len(reqs) * 2 * cfg.n_layers * tb)
    engines, results, launches = serve_and_count(cfg, reqs, args, card_str, expected, "8a")
    # 8b. captured against eager
    rows = captured_vs_eager(engines["baseline"], reqs, results["baseline"], ph="8b")
    # 8c. kernel path against plain path on random frames: f32, then bf16
    frames = rand((1, cfg.encoder_frames, cfg.d_model), torch.float32, args.seed)
    encdec_f32_kernel_vs_plain(cfg, frames, args.new_tokens, args.seed)
    be = engines["baseline"].backend
    encdec_bf16_kernel_vs_plain(be.model, be.params, frames, args.new_tokens)
    # 8e. times: requests, captures, profiled steps, memory, and the kernels
    # at whisper's shapes
    flop, prefill_bound, step_bound = whisper_bounds(cfg)
    print(f"[8e] bounds at full width, batch 1, bf16: encoder prefill {flop / 1e9:.1f} GFLOP, "
          f"{prefill_bound:.4f} ms (operations); decode step {step_bound:.4f} ms (bytes: the "
          f"decoder's and unembedding's weights and the cross cache)")
    time_requests(engines, reqs, rows, card_str, ph="8e")
    graph_memory(engines, card_str, ph="8e")
    H, K, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.encoder_frames
    kernels = report_rows(
        [("flash_attention", flash_row((1, H, K, F, hd), causal=False)),
         ("decode_attention", decode_row((1, H, K, F, hd), F))],
        launches, card_str, "8e", suffix=f"[{WHISPER}]")
    del engines, results, be
    torch.cuda.empty_cache()
    # 8d. the pipeline, whisper-small into llama3.2-1b
    t1 = time.perf_counter()
    pipeline_phase(args, card_str)
    print(f"[8d] pipeline took {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    print(f"[8] phase 8 took {time.perf_counter() - t0:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# phase 9: the vectorized Monte-Carlo path (simulate_arms, simulate_open_arms)
# ---------------------------------------------------------------------------
# The sweeps' settings, rebuilt from the port: benchmarks/grid_sweep.py:51-102
# (SPEC, _profiles, analytic_threshold, build_grid) and its --smoke / --quick /
# default grids, loadaware_sweep's, and benchmarks/openloop_sweep.py:66-90 and
# _vec_leg (:144-160). One arm = one seeded run of n_steps requests.

VEC_THINK_MS = 500.0
VEC_SEEDS = range(4)
GRIDS = {  # fracs, sigmas, number of profiles, gates, n_steps
    "smoke": (np.linspace(0.2, 0.8, 4), np.linspace(0.08, 0.2, 3), 1, ("fixed",), 200),
    "quick": (np.linspace(0.1, 0.9, 8), np.linspace(0.05, 0.25, 8), 2, ("fixed", "adaptive"), 300),
    "full": (np.linspace(0.06, 0.94, 23), np.linspace(0.04, 0.26, 15), 3, ("fixed",), 400),
}
LOADAWARE = {  # fracs, alphas, n_steps, seeds; four streams
    "smoke": (np.linspace(0.2, 0.8, 6), (0.2, 0.5, 0.8), 200, range(4)),
    "quick": (np.linspace(0.1, 0.9, 8), (0.2, 0.5, 0.8), 300, range(6)),
}
OPENLOOP = {  # max_retries, seeds, n_steps, rate per s; four servers
    "smoke": (3, range(4), 150, 1.2),
    "quick": (5, range(8), 300, 0.6),
}


def vec_spec(name="weather-linreg-grid"):
    from repro_torch.sim import FunctionSpec

    return FunctionSpec(name=name, prepare_ms=600.0, body_ms=1500.0, benchmark_ms=300.0,
                        cold_start_ms=250.0, recycle_lifetime_ms=8_000.0, contention_rho=0.95,
                        benchmark_noise=0.08)


def vec_profiles(n=3, loaded_alpha=None):
    """The sweeps' churny platform presets (recycle as in the spec, paper
    pricing); ``loaded_alpha``: gcf-gen2-loaded at that alpha instead."""
    from repro_torch.sim import PlatformProfile
    from repro_torch.sim.experiment import PAPER_PRICING

    if loaded_alpha is not None:
        presets = [PlatformProfile.gcf_gen2_loaded(alpha=float(loaded_alpha))]
    else:
        presets = [PlatformProfile.gcf_gen1(), PlatformProfile.gcf_gen2(),
                   PlatformProfile.aws_lambda()][:n]
    return [dataclasses.replace(p, recycle_lifetime_ms=8_000.0, pricing=PAPER_PRICING)
            for p in presets]


def analytic_threshold(pass_fraction: float, sigma: float) -> float:
    from scipy import stats

    spread = (sigma ** 2 + 0.08 ** 2) ** 0.5
    return 300.0 * float(np.exp(stats.norm.ppf(pass_fraction) * spread))


def build_grid(name):
    """grid_sweep's arms: per (platform, sigma) one gate-off baseline, then
    one arm per (pass fraction, gate). Returns (arms, n_steps)."""
    from repro_torch.sim import VariationModel
    from repro_torch.sim.vectorized import arm_from_spec, stack_arms

    fracs, sigmas, n_prof, gates, n_steps = GRIDS[name]
    spec, arms = vec_spec(), []
    for prof in vec_profiles(n_prof):
        for s in sigmas:
            vm = VariationModel(sigma=float(s))
            arms.append(arm_from_spec(spec, vm, profile=prof, gate="off",
                                      think_time_ms=VEC_THINK_MS))
            for f in fracs:
                for gate in gates:
                    arms.append(arm_from_spec(spec, vm, profile=prof, gate=gate,
                                              threshold=analytic_threshold(float(f), float(s)),
                                              pass_fraction=float(f), think_time_ms=VEC_THINK_MS))
    return stack_arms(arms), n_steps


def build_loadaware(name):
    from repro_torch.sim import VariationModel
    from repro_torch.sim.vectorized import arm_from_spec, stack_arms

    fracs, alphas, n_steps, seeds = LOADAWARE[name]
    spec, vm, arms = vec_spec(), VariationModel(sigma=0.15), []
    for a in alphas:
        prof = vec_profiles(loaded_alpha=a)[0]
        arms.append(arm_from_spec(spec, vm, profile=prof, gate="off", think_time_ms=VEC_THINK_MS))
        for f in fracs:
            arms.append(arm_from_spec(spec, vm, profile=prof, gate="fixed",
                                      threshold=analytic_threshold(float(f), 0.15),
                                      pass_fraction=float(f), think_time_ms=VEC_THINK_MS))
    return stack_arms(arms), n_steps, seeds


def build_open(name):
    """openloop_sweep._vec_leg's arms and per-seed Poisson arrivals."""
    from repro_torch.sim import PoissonProcess, VariationModel
    from repro_torch.sim.vectorized import arm_from_spec, stack_arms

    max_retries, seeds, n_steps, rate = OPENLOOP[name]
    spec, vm = vec_spec("weather-linreg-open"), VariationModel(sigma=0.15)
    arms = stack_arms([
        arm_from_spec(spec, vm, profile=prof, gate=gate, threshold=analytic_threshold(0.4, 0.15),
                      max_retries=max_retries, think_time_ms=0.0)
        for prof in vec_profiles(3)[::2] for gate in ("off", "fixed")])
    proc = PoissonProcess(rate)
    iats = np.stack([proc.iats_ms(np.random.RandomState(9_000 + i), n_steps) for i in seeds])
    return arms, seeds, iats, dict(n_servers=4, max_attempts=max_retries + 1)


def vec_settings(size):
    """The four settings of phase 9 at one size ("smoke" or "quick"), each
    (label, run), ``run(**kw)`` calling the private entry point with the
    given device keywords."""
    from repro_torch.sim import vectorized as TV

    grid, n_grid = build_grid(size)
    la, n_la, la_seeds = build_loadaware(size)
    op, op_seeds, iats, op_kw = build_open(size)
    return [
        (f"grid --{size}", grid, lambda **kw: TV._simulate_arms(
            grid, seeds=VEC_SEEDS, n_steps=n_grid, **kw)),
        (f"loadaware --{size}", la, lambda **kw: TV._simulate_arms(
            la, seeds=la_seeds, n_steps=n_la, n_streams=4, **kw)),
        (f"openloop --{size}", op, lambda **kw: TV._simulate_open_arms(
            op, seeds=op_seeds, iats_ms=iats, **op_kw, **kw)),
    ]


VEC_INTS = ("n_requests", "n_completed", "n_started", "n_terminated", "n_probes", "n_dropped",
            "n_deferred", "n_parked_end", "bill_n")
VEC_RTOL = 1e-4  # float summaries and rows, card against CPU (as the CPU tests hold the port)
# a float row may also differ by up to this many f32 ulps of its lane's
# horizon: waits and latencies are differences of two absolute times near it
VEC_ULPS = 4


def row_atol(res, shape):
    """VEC_ULPS f32 ulps of each lane's horizon, broadcast to a row's shape."""
    ulp = np.spacing(np.abs(np.asarray(res.summary["horizon_ms"], np.float32)))
    return (VEC_ULPS * ulp).reshape(ulp.shape + (1,) * (len(shape) - 2))


def vec_compare(got, want, what, exact=False) -> float:
    """Integer summaries and int/bool rows equal; float summaries within
    VEC_RTOL, float rows within VEC_RTOL or VEC_ULPS ulps of the lane's
    horizon; or all bitwise when ``exact``. Returns the largest relative
    error of a float summary and the largest excess of a float row over
    rtol, in ulps of its lane's horizon."""
    worst = [0.0, 0.0]
    for part in ("summary", "requests"):
        g, w = getattr(got, part) or {}, getattr(want, part) or {}
        if sorted(g) != sorted(w):
            raise PhaseError(f"{what}: {part} keys differ")
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            if a.dtype != b.dtype or a.shape != b.shape:
                raise PhaseError(f"{what}: {part}[{k}] {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
            if exact or b.dtype.kind in "biu" or k in VEC_INTS:
                if not np.array_equal(a, b):
                    raise PhaseError(f"{what}: {part}[{k}] not equal "
                                     f"({int((a != b).sum())} of {a.size} differ)")
                continue
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)) or not np.array_equal(a[~fin], b[~fin]):
                raise PhaseError(f"{what}: {part}[{k}] non-finite entries differ")
            with np.errstate(invalid="ignore"):
                diff = np.abs(a - b)
            floor = row_atol(want, b.shape) if part == "requests" else 0.0
            ok = ~fin | (diff <= VEC_RTOL * np.abs(b) + floor)
            if not ok.all():
                i = np.unravel_index(int(np.argmin(ok)), ok.shape)
                raise PhaseError(f"{what}: {part}[{k}] at {i}: {a[i]!r} vs {b[i]!r}, beyond rtol "
                                 f"{VEC_RTOL} and {VEC_ULPS} ulps of the lane's horizon")
            if part == "summary":
                rel = diff[fin] / np.maximum(np.abs(b[fin]), np.finfo(np.float32).tiny)
                worst[0] = max(worst[0], float(rel.max()) if rel.size else 0.0)
            else:  # beyond rtol, in ulps of the horizon
                over = np.maximum(diff - VEC_RTOL * np.abs(b), 0.0)[fin] / np.broadcast_to(floor / VEC_ULPS, b.shape)[fin]
                # (a horizon's ulp is never 0: horizons are positive)
                worst[1] = max(worst[1], float(over.max()) if over.size else 0.0)
    return worst


def vec_runner(TV, arms, n_seeds, n_steps):
    """The captured runner that the cache holds for this batch shape."""
    n_arms = len(np.atleast_1d(arms.sigma))
    hits = [r for (cfg, shape, dev), r in TV._JIT_CACHE.items()
            if shape == (n_arms, n_seeds) and cfg.n_steps == n_steps and dev.startswith("cuda")
            and not cfg.collect_requests]
    if len(hits) != 1:
        raise PhaseError(f"expected one cached runner for {(n_arms, n_seeds, n_steps)}, got {len(hits)}")
    return hits[0]


def event_per_arm(kind, n_steps, n_arms=3, repeats=2, rate=None) -> float:
    """Host seconds per arm of the copied event engine on the same scenario,
    best of ``repeats`` (grid_sweep._event_reference and
    _event_reference_loaded; open loop: run_open_loop over n_steps / rate)."""
    from repro_torch.core.policy import MinosPolicy
    from repro_torch.sim import FaaSPlatform, PoissonProcess, VariationModel, run_open_loop
    from repro_torch.sim.vectorized import run_event_chain

    vm, thr = VariationModel(sigma=0.15), analytic_threshold(0.4, 0.15)
    prof = vec_profiles(loaded_alpha=0.6)[0] if kind == "loaded" else vec_profiles(1)[0]
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for seed in range(n_arms):
            pol = MinosPolicy(elysium_threshold=thr, max_retries=5)
            if kind == "open":
                knobs = dataclasses.replace(prof.knobs(), max_instances=4)
                plat = FaaSPlatform(vec_spec("weather-linreg-open"), vm, pol, seed=seed,
                                    profile=prof, knobs=knobs)
                run_open_loop(plat, PoissonProcess(rate), rng=np.random.RandomState(7_000 + seed),
                              duration_ms=n_steps / rate * 1e3, drain_limit_ms=120_000.0)
            else:
                plat = FaaSPlatform(vec_spec(), vm, pol, seed=seed, profile=prof)
                run_event_chain(plat, n_steps, VEC_THINK_MS, n_vus=4 if kind == "loaded" else 1)
        best = min(best, (time.perf_counter() - t0) / n_arms)
    return best


def vec_parity(card_str):
    """9a: the card against the CPU on shared draws (the port's CPU
    generator), for the grid's smoke and quick (adaptive) arms and the
    load-aware and open-loop smoke settings; 9b: captured against eager on
    the card, bitwise, a second call capturing nothing, and one lane run
    alone equal to the same lane in a batch."""
    from repro_torch.sim import vectorized as TV

    quick, n_quick = build_grid("quick")
    settings = vec_settings("smoke") + [("grid --quick arms (adaptive)", quick, lambda **kw: TV._simulate_arms(
        quick, seeds=VEC_SEEDS, n_steps=n_quick, **kw))]
    for label, arms, run in settings:
        t0 = time.perf_counter()
        cpu = run(device="cpu", collect_requests=True)
        t_cpu = time.perf_counter() - t0
        gpu = run(device="cuda", draw_device="cpu", collect_requests=True)
        err, ulps = vec_compare(gpu, cpu, f"[9a] {label}")
        ints = {k: int(np.asarray(cpu.summary[k]).sum()) for k in VEC_INTS[2:]
                if k in cpu.summary and k not in ("n_parked_end",)}
        print(f"[9a] {label}: {cpu.n_arms} arms x {cpu.n_seeds} seeds x {cpu.n_steps} steps, card "
              f"vs CPU on the CPU generator's draws: integer summaries and rows equal {ints}; float "
              f"summaries max rel err {err:.3e} (limit {VEC_RTOL}); float rows at most {ulps:.2f} "
              f"horizon ulps beyond rtol {VEC_RTOL} (limit {VEC_ULPS}); CPU run {t_cpu:.2f} s")
    for label, arms, run in vec_settings("smoke")[::2]:
        before = TV.jit_stats["compiles"]
        cap = run(device="cuda", collect_requests=True)
        again = run(device="cuda", collect_requests=True)
        eager = run(device="cuda", collect_requests=True, eager=True)
        if TV.jit_stats["compiles"] != before:
            raise PhaseError(f"[9b] {label}: a call of a captured shape captured again")
        vec_compare(cap, eager, f"[9b] {label} captured vs eager", exact=True)
        vec_compare(again, cap, f"[9b] {label} second call", exact=True)
        print(f"[9b] {label}: captured equals eager bitwise (summaries and rows); the second "
              f"call of the shape captured nothing")
    grid, n_grid = build_grid("smoke")
    # a lane's draws depend on (seed, arm index), so the lone arm keeps index 0
    lane_arm, lane_seed = 0, 2
    alone = TV.stack_arms([TV.ArmParams(*[np.asarray(x)[lane_arm] for x in grid])])
    one = TV.simulate_arms(alone, seeds=[VEC_SEEDS[lane_seed]], n_steps=n_grid)
    batch = TV.simulate_arms(grid, seeds=VEC_SEEDS, n_steps=n_grid)
    for k in one.summary:
        if not np.array_equal(one.summary[k][0, 0], batch.summary[k][lane_arm, lane_seed]):
            raise PhaseError(f"[9b] lane (arm {lane_arm}, seed {lane_seed}) alone differs in {k}")
    print(f"[9b] lane (arm {lane_arm}, seed {lane_seed}) run alone equals the same lane in the "
          f"15 x 4 batch, every summary bitwise")


VEC_EVENT_SEEDS = 60  # event-engine seeds of 9c (the reference's test uses 10; see the docstring)


def vec_statistics(card_str):
    """9c: the closed loop on gcf-gen1, gate off and fixed, on the card's own
    draws (20 seeds x 600 requests, the reference test's) against the copied
    event engine, at the reference's bounds (tests/test_vectorized_parity.py
    :143,170,183: KS D < 0.05, pass rate within 2pp, speedup within 1pp).

    The event side runs VEC_EVENT_SEEDS seeds, not the test's 10: the event
    engine's own speedup varies by about 1pp between disjoint 10-seed sets
    (printed: the six sets of these 60 seeds), so at 10 seeds the 1pp bound
    holds the event sample's noise as much as the port (PERF.md §6). The
    comparison with seeds 0-9 is printed beside it and not held."""
    from scipy.stats import ks_2samp

    from repro_torch.core.policy import MinosPolicy
    from repro_torch.sim import FaaSPlatform, PlatformProfile, VariationModel
    from repro_torch.sim import vectorized as TV

    spec, vm = vec_spec("parity"), VariationModel(sigma=0.15)
    prof = dataclasses.replace(PlatformProfile.gcf_gen1(), recycle_lifetime_ms=8_000.0)
    thr, n_req = analytic_threshold(0.4, 0.15), 600
    event, vec, by_set = {}, {}, {}
    for gate in ("off", "fixed"):
        pol = (MinosPolicy(elysium_threshold=float("inf"), enabled=False) if gate == "off"
               else MinosPolicy(elysium_threshold=thr, max_retries=5))
        an, lat, nterm, nprobe = [], [], 0, 0
        for seed in range(VEC_EVENT_SEEDS):
            plat = FaaSPlatform(spec, vm, pol, seed=seed, profile=prof)
            rs = TV.run_event_chain(plat, n_req, VEC_THINK_MS)
            an += [r.analysis_ms for r in rs]
            lat += [r.latency_ms for r in rs]
            nterm += plat.instances_terminated
            nprobe += len(plat.benchmark_observations)
            if seed % 10 == 9:  # mean analysis ms of each 10-seed set
                by_set.setdefault(gate, []).append(np.mean(an[-10 * n_req:]))
        event[gate] = (np.asarray(an), np.asarray(lat), 1.0 - nterm / max(nprobe, 1))
    arms = TV.stack_arms([TV.arm_from_spec(spec, vm, profile=prof, gate=g, threshold=thr,
                                           think_time_ms=VEC_THINK_MS) for g in ("off", "fixed")])
    res = TV.simulate_arms(arms, seeds=range(20), n_steps=n_req, collect_requests=True)
    for i, gate in enumerate(("off", "fixed")):
        vec[gate] = (res.requests["analysis_ms"][i].ravel(), res.requests["latency_ms"][i].ravel(),
                     float(res.summary["pass_rate"][i].mean()))
    parts = []
    for gate in ("off", "fixed"):
        for j, field in enumerate(("analysis", "latency")):
            d = ks_2samp(event[gate][j], vec[gate][j]).statistic
            parts.append(f"KS D {gate} {field} {d:.4f}")
            if not d < 0.05:
                raise PhaseError(f"[9c] KS D {d:.4f} >= 0.05 ({gate}, {field})")
    dp = abs(event["fixed"][2] - vec["fixed"][2])
    imp_ev = 1.0 - event["fixed"][0].mean() / event["off"][0].mean()
    imp_v = 1.0 - vec["fixed"][0].mean() / vec["off"][0].mean()
    imp_sets = [1.0 - f / o for f, o in zip(by_set["fixed"], by_set["off"])]
    if not dp < 0.02 or not abs(imp_ev - imp_v) < 0.01:
        raise PhaseError(f"[9c] pass rate {vec['fixed'][2]:.4f} vs {event['fixed'][2]:.4f}, "
                         f"speedup {imp_v:.4f} vs {imp_ev:.4f}: outside 2pp / 1pp")
    print(f"[9c] gcf-gen1 on the card's draws (20 seeds x {n_req}) vs the event engine "
          f"({VEC_EVENT_SEEDS} seeds x {n_req}): {'; '.join(parts)} (< 0.05); pass rate "
          f"{vec['fixed'][2]:.4f} vs {event['fixed'][2]:.4f} (within 2pp); speedup {imp_v:.4f} vs "
          f"{imp_ev:.4f} (within 1pp). The event speedup by 10-seed set (not held): "
          f"{', '.join(f'{x:.4f}' for x in imp_sets)}; the test's seeds 0-9 give "
          f"{(imp_v - imp_sets[0]) * 100:+.2f}pp")


def tree_bytes(TV, tree) -> int:
    leaves = []
    TV._tree_map(lambda t: leaves.append(t) or t, tree)
    return sum(t.nbytes for t in leaves)


def vec_time(label, TV, arms, n_seeds, n_steps, run, event_s, card_str, profile=True):
    """9d: one setting's capture, cached wall time, throughput, kernels a
    captured step, idle share of one profiled replay, the step's byte bound
    and the speedup per arm over the event engine. Returns the speedup."""
    n_arms = len(np.atleast_1d(arms.sigma))
    lanes = n_arms * n_seeds
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    runner = vec_runner(TV, arms, n_seeds, n_steps)
    held_mb = (torch.cuda.memory_allocated() - mem0) / 2**20
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    t_cached = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t_cached = min(t_cached, time.perf_counter() - t0)

    def replay():
        runner.step_t.zero_()  # as run() does: the step index restarts at 0
        for g in runner.plan:
            g.replay()

    replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    # one chunk's graph under the profiler (a whole run is 10^5-10^6 events)
    steps_p = min(TV._CHUNK, n_steps)

    def replay_chunk():
        runner.step_t.zero_()
        runner.plan[0].replay()

    replay_chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay_chunk()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    prof_txt = "not profiled"
    if profile:
        kernels, copies, busy, span, _ = profiled(replay_chunk)
        prof_txt = (f"one {steps_p}-step graph profiled: {kernels / steps_p:.1f} kernels a step "
                    f"({copies} copies/sets), {busy / steps_p:.4f} ms of kernels a step, idle "
                    f"{1 - busy / chunk_ms:.3f} of its unprofiled replay ({chunk_ms:.3f} ms; "
                    f"{1 - busy / span:.3f} of the profiled span)")
    # lane state read and written, the arm parameters and constants read, and
    # the step's draws read, once a step; request rows are off in timing runs
    state_b, fixed_b = tree_bytes(TV, runner.state), tree_bytes(TV, runner.fixed)
    draw_b = sum(x.nbytes for x in runner.xs) / n_steps
    step_bytes = 2 * state_b + fixed_b + draw_b
    bound_step_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    speedup = event_s / (t_cached / lanes)
    print(f"[9d] {label}: {n_arms} arms x {n_seeds} seeds = {lanes} lanes x {n_steps} steps | first "
          f"call {t_first:.3f} s, capture {runner.capture_ms:.1f} ms ({runner.graphs} graph(s), "
          f"{len(runner.plan)} replays of at most {TV._CHUNK} steps), {held_mb:.1f} MB held after "
          f"it (static buffers), {peak_mb:.1f} MB at its peak | "
          f"cached {t_cached * 1e3:.3f} ms (best of 2): {lanes * n_steps / t_cached:.4e} "
          f"lanes.steps/s, {t_cached / lanes * 1e3:.6f} ms a lane | replays alone {replay_ms:.3f} ms "
          f"wall, {replay_ms / n_steps:.4f} ms a step; {prof_txt} | byte bound {bound_step_ms * 1e3:.3f} us a step ({step_bytes / 2**20:.3f} "
          f"MB: state {state_b / 2**20:.3f} MB read+written) | event engine {event_s * 1e3:.3f} ms an "
          f"arm on the host: {speedup:.1f}x per arm ({card_str})")
    return speedup


def vec_phase(card_str):
    """Phase 9: the vectorized Monte-Carlo path; launches no kernel of
    K1-K3 (checked on the counters)."""
    from repro_torch.kernels import ops
    from repro_torch.sim import vectorized as TV

    t_phase = time.perf_counter()
    ops.reset_counters()
    vec_parity(card_str)
    print(f"[9] 9a-9b took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    vec_statistics(card_str)
    print(f"[9] 9c took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # 9d: times. The full grid is the size the sweep's users run.
    full, n_full = build_grid("full")
    quick, n_quick = build_grid("quick")
    speed = {}
    speed["full"] = vec_time("grid (full)", TV, full, len(VEC_SEEDS), n_full, lambda: TV.simulate_arms(
        full, seeds=VEC_SEEDS, n_steps=n_full), event_per_arm("closed", n_full), card_str)
    vec_time("grid --quick (adaptive)", TV, quick, len(VEC_SEEDS), n_quick, lambda: TV.simulate_arms(
        quick, seeds=VEC_SEEDS, n_steps=n_quick), event_per_arm("closed", n_quick), card_str)
    la, n_la, la_seeds = build_loadaware("quick")
    vec_time("loadaware --quick (4 streams)", TV, la, len(la_seeds), n_la, lambda: TV.simulate_arms(
        la, seeds=la_seeds, n_steps=n_la, n_streams=4), event_per_arm("loaded", n_la), card_str)
    op, op_seeds, iats, op_kw = build_open("quick")
    rate = OPENLOOP["quick"][3]
    vec_time("openloop --quick", TV, op, len(op_seeds), iats.shape[1], lambda: TV.simulate_open_arms(
        op, seeds=op_seeds, iats_ms=iats, **op_kw), event_per_arm("open", iats.shape[1], rate=rate),
        card_str)

    # the eager path on the smoke grid, for scale
    smoke, n_smoke = build_grid("smoke")

    def eager():
        TV._simulate_arms(smoke, seeds=VEC_SEEDS, n_steps=n_smoke, device="cuda", eager=True)
        torch.cuda.synchronize()

    eager()
    t_eager = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        eager()
        t_eager = min(t_eager, time.perf_counter() - t0)
    kernels, _, busy, _, _ = profiled(eager)
    print(f"[9d] eager, grid --smoke (15 arms x 4 seeds x {n_smoke} steps): {t_eager * 1e3:.1f} ms "
          f"(best of 2), {t_eager / n_smoke * 1e3:.3f} ms a step, {kernels / n_smoke:.1f} device "
          f"activities a step (draws and set-up included), idle {1 - busy / (t_eager * 1e3):.3f} "
          f"({card_str})")

    print(f"[9] 9d took {time.perf_counter() - t0:.1f} s")
    # whole-scan capture of the full grid, against the chunked one above
    chunk = TV._CHUNK
    TV._JIT_CACHE.clear()
    TV._CHUNK = n_full
    try:
        vec_time(f"grid (full), whole scan in one graph", TV, full, len(VEC_SEEDS), n_full,
                 lambda: TV.simulate_arms(full, seeds=VEC_SEEDS, n_steps=n_full),
                 event_per_arm("closed", n_full), card_str, profile=False)
    finally:
        TV._CHUNK = chunk
        TV._JIT_CACHE.clear()
    torch.cuda.empty_cache()

    # 9e: the full grid at least 20x per arm over the event engine
    if not speed["full"] >= 20.0:
        raise PhaseError(f"[9e] full grid {speed['full']:.1f}x per arm < 20x")
    print(f"[9e] full grid {speed['full']:.1f}x per arm over the event engine (bar 20x)")
    launches, plain = dict(ops.launches), dict(ops.plain)
    if max(launches.values()) != 0 or max(plain.values()) != 0:
        raise PhaseError(f"phase 9 launched {launches}, plain {plain}; expected none")
    print(json.dumps({"counters": {"path": "vectorized", "launches": launches, "plain": plain}}))
    print(f"[9] no kernel of K1-K3 launched; phase 9 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the recurrent families (zamba2-1.2b, xlstm-1.3b)
# ---------------------------------------------------------------------------


def recurrent_bounds(cfg, params, state_bytes) -> float:
    """The least time of a decode step at batch 1: every weight read once
    (the embedding only its one row), and the recurrent state read and
    written once, over the memory rate. ms."""
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    weights -= params.embed.numel() * params.embed.element_size()
    return (weights + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3


def zamba_phase(args, card_str):
    """10a/10c-d for zamba2-1.2b: served in both arms on the captured path
    (K2 once an application of the shared block a request, K3 once an
    application a decode step, the SSD kernel once a Mamba2 layer a
    request), captured against eager, the f32 and bf16 kernel paths against
    the plain path, then times. Returns the served path's kernels-line
    entries."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.backend import ServeRequest, _bucket

    t0 = time.perf_counter()
    cfg = get_config(ZAMBA)
    reqs = make_requests(cfg, args.requests, args.new_tokens, args.seed, ServeRequest)
    longest = max(reqs, key=lambda r: len(r.prompt))
    S, tb = len(longest.prompt), _bucket(args.new_tokens, base=8)
    n_attn = cfg.n_layers // cfg.hybrid_attn_every
    expected = kernel_counts(flash_attention=2 * len(reqs) * n_attn,
                             decode_attention=2 * len(reqs) * n_attn * tb,
                             ssd_chunked=2 * len(reqs) * cfg.n_layers)  # once a layer a prefill
    engines, results, launches = serve_and_count(cfg, reqs, args, card_str, expected, "10a")
    rows = captured_vs_eager(engines["baseline"], reqs, results["baseline"], ph="10a")
    # f32 over three SSD chunks, the last ragged, so the state carried between
    # chunks reaches the logits (the served prompts fit one chunk)
    long = np.random.RandomState(args.seed).randint(0, cfg.vocab, size=2 * cfg.ssm.chunk + 88)
    f32_kernel_vs_plain(cfg, torch.tensor(long, dtype=torch.int32, device=DEVICE)[None],
                        args.new_tokens, args.seed, ph="10a")
    be = engines["baseline"].backend
    bf16_kernel_vs_plain(be.model, be.params, prompt_of(longest), ph="10a")
    # 10d. times
    state = be.model.init_cache(1, 1)
    state_bytes = sum(state[n].numel() * state[n].element_size() for n in ("h", "conv"))
    print(f"[10d] {ZAMBA} decode step bound at batch 1, bf16: "
          f"{recurrent_bounds(cfg, be.params, state_bytes):.4f} ms (bytes: the weights, "
          f"{sum(p.numel() for p in be.params.parameters()) / 1e9:.3f} B params, read once; "
          f"the SSD states and conv contexts, {state_bytes / 1e6:.1f} MB, read and written once)")
    time_requests(engines, reqs, rows, card_str, ph="10d")
    graph_memory(engines, card_str, ph="10d")
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ssd_heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.d_state  # SSD heads of d_state
    cache_len = _bucket(S + tb, base=8)
    kernels = report_rows(
        [("flash_attention", flash_row((1, H, K, S, hd), window=cfg.sliding_window)),
         ("decode_attention", decode_row((1, H, K, cache_len, hd), S + tb // 2)),
         ("ssd_chunked", ssd_row(2048, ssd_heads, cfg.ssm.d_state, cfg.ssm.chunk))],
        launches, card_str, "10d", suffix=f"[{ZAMBA}]")
    # the SSD kernel at the longest prompt of the documents' traffic
    report_rows([("ssd_chunked", ssd_row(3840, ssd_heads, cfg.ssm.d_state, cfg.ssm.chunk))],
                None, card_str, "10d", suffix="[S 3840]")
    # K2 where the window masks: a 1,024-token prompt, window 256
    report_rows([("flash_attention", flash_row((1, H, K, 1024, hd), window=256))],
                None, card_str, "10d", suffix="[window 256]")
    # the SSD kernel at granite-4.0-h's shape (128 heads of 64, d_state 128,
    # chunk 256), the documents' shortest and longest prompts
    for S_g in (2048, 3840):
        report_rows([("ssd_chunked", ssd_row(S_g, 128, 128, 256, P=64))],
                    None, card_str, "10d", suffix=f"[granite-4.0-h S {S_g}]")
    del engines, results, be
    torch.cuda.empty_cache()
    print(f"[10] {ZAMBA} took {time.perf_counter() - t0:.1f} s")
    return kernels


def xlstm_card_vs_cpu(cfg, prompt, seed, ph="10b"):
    """xlstm-1.3b at full width and ``XLSTM_CPU_LAYERS`` layers in f32, the
    card against the CPU on the same weights: prefill logits and
    ``XLSTM_CPU_STEPS`` teacher-forced decode steps' logits within 1e-4 of
    the largest value, greedy tokens equal. xLSTM has no kernel path to hold
    against a plain one; this holds the card's arithmetic."""
    from repro_torch.models.model import build_model, greedy_token

    cfg8 = dataclasses.replace(cfg, n_layers=XLSTM_CPU_LAYERS, dtype="float32")
    card_m = build_model(cfg8)
    card_p = card_m.init(seed)
    cpu_m, cpu_p = f32_copy(cfg8, card_p, device="cpu")
    runs = {"card": (card_m, card_p, prompt), "cpu": (cpu_m, cpu_p, prompt.cpu())}
    caches, logits = {}, {}
    t0 = time.perf_counter()
    for name, (m, p, x) in runs.items():
        caches[name] = m.init_cache(1, 1)
        logits[name] = [m.prefill(p, {"tokens": x}, caches[name])[0].cpu()]
    tok = greedy_token(logits["card"][0])
    toks = {"card": [], "cpu": []}
    for _ in range(XLSTM_CPU_STEPS):
        for name, (m, p, _) in runs.items():
            step = m.decode_step(p, caches[name], tok.to(m.device))[0].cpu()
            logits[name].append(step)
            toks[name].append(greedy_token(step))
        tok = toks["card"][-1]  # teacher-forced: both see the card's tokens
    errs = [(a - b).abs().max().item() / b.abs().max().item()
            for a, b in zip(logits["card"], logits["cpu"])]
    same = torch.equal(torch.cat(toks["card"], 1), torch.cat(toks["cpu"], 1))
    print(f"[{ph}] f32 {XLSTM} full width, {XLSTM_CPU_LAYERS} layers, card against CPU, one "
          f"{prompt.shape[1]}-token prompt and {XLSTM_CPU_STEPS} decode steps: max |logit "
          f"difference| / max |logit| prefill {errs[0]:.3e}, decode {max(errs[1:]):.3e} "
          f"(tolerance 1e-4); greedy tokens equal: {same} ({time.perf_counter() - t0:.1f} s)")
    if max(errs) > 1e-4 or not same or not all(torch.isfinite(x).all() for x in logits["card"]):
        raise PhaseError(f"{XLSTM}: the card disagrees with the CPU in f32")
    del runs, caches, card_p, cpu_p


def xlstm_phase(args, card_str):
    """10b and 10d for xlstm-1.3b: served in both arms on the captured path
    (no kernel launched, no plain call), captured against eager (the
    captured requests back to back on one static cache, the eager ones each
    on a fresh cache), the card against the CPU in f32, then times."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.backend import ServeRequest

    t0 = time.perf_counter()
    cfg = get_config(XLSTM)
    reqs = make_requests(cfg, args.requests, args.new_tokens, args.seed, ServeRequest)
    expected = kernel_counts()
    engines, results, _ = serve_and_count(cfg, reqs, args, card_str, expected, "10b")
    be = engines["baseline"].backend
    if list(be.model.graphs.caches) != [(1, None)]:
        raise PhaseError(f"{XLSTM}: static caches {list(be.model.graphs.caches)}; expected one "
                         f"a batch size, (1, None)")
    rows = captured_vs_eager(engines["baseline"], reqs, results["baseline"], ph="10b")
    xlstm_card_vs_cpu(cfg, prompt_of(reqs[0]), args.seed)
    state = be.model.init_cache(1, 1)
    state_bytes = sum(t.numel() * t.element_size() for n, t in state.items() if n != "lengths")
    print(f"[10d] {XLSTM} decode step bound at batch 1, bf16: "
          f"{recurrent_bounds(cfg, be.params, state_bytes):.4f} ms (bytes: the weights, "
          f"{sum(p.numel() for p in be.params.parameters()) / 1e9:.3f} B params, read once; "
          f"the mLSTM and sLSTM states, {state_bytes / 1e6:.1f} MB, read and written once)")
    time_requests(engines, reqs, rows, card_str, ph="10d")
    graph_memory(engines, card_str, ph="10d")
    del engines, results, be
    torch.cuda.empty_cache()
    print(f"[10] {XLSTM} took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: training (M10)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "llama3.2-1b"      # 11a: full width and depth, bf16, remat on
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_TIMED = 3                 # 11f: instrumented steps after the 20
PLAIN_LAYERS, PLAIN_BATCH, PLAIN_SEQ = 4, 2, 512  # 11b: f32, kernel path against plain
BF16_TRAIN_LAYERS = 4           # 11b: bf16, kernel path against plain, at 11a's batch
# 11d: each other family at full width, depth cut (layers, and for whisper
# encoder layers), f32, batch x tokens
TRAIN_FAMILIES = {
    MOE_ARCH: dict(n_layers=2, batch=2, seq=512),
    WHISPER: dict(n_layers=2, n_encoder_layers=2, batch=2, seq=256),
    # one Mamba group and one application of the shared block; 4,352 tokens so
    # that the window (4,096) masks keys
    ZAMBA: dict(n_layers=6, batch=1, seq=4352),
    # one mLSTM group and the sLSTM; the card against the CPU
    XLSTM: dict(n_layers=8, batch=1, seq=256),
}
CKPT_LAYERS, CKPT_BATCH, CKPT_SEQ = 2, 2, 256  # 11e: llama3.2-1b at full width, bf16


def train_batch(cfg, batch, seq, seed, device=None):
    """A ``TokenStream`` batch on ``device`` (the card); encdec adds random
    frames."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.loop import to_device

    device = device or DEVICE
    b = to_device(next(TokenStream(vocab=cfg.vocab, batch=batch, seq_len=seq, seed=seed)),
                  torch.device(device))
    if cfg.family == "encdec":
        b["frames"] = rand((batch, cfg.encoder_frames, cfg.d_model), torch.float32, seed + 1,
                           device=device)
    return b


def loss_and_grads(model, params, batch):
    """``Model.loss`` (remat on) and its gradients: (loss, metrics, {name:
    grad}), the gradients copied out."""
    params.requires_grad_(True)
    params.zero_grad(set_to_none=True)
    loss, met = model.loss(params, batch, remat=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, grads


def grad_shares(got, want, scale=1e-4):
    """{name: max |got - want| over ``scale`` times the largest |want|}."""
    out = {}
    for n, w in want.items():
        top = w.float().abs().max().item()
        err = (got[n].float().to(w.device) - w.float()).abs().max().item()
        out[n] = err / (scale * top) if top > 0 else (0.0 if err == 0 else float("inf"))
    return out


def hold_grads(tag, got, want, loss_got, loss_want, ph):
    """Loss within 1e-5 relative; each gradient within 1e-4 of its largest
    |grad| in ``want``. Prints the worst shares of both limits and returns
    every gradient's share."""
    loss_rel = abs(loss_got.item() - loss_want.item()) / abs(loss_want.item())
    shares = grad_shares(got, want)
    worst_name = max(shares, key=shares.get)
    worst = shares[worst_name]
    finite = torch.isfinite(loss_got).item() and all(torch.isfinite(g).all() for g in got.values())
    print(f"[{ph}] {tag}: loss {loss_got.item():.6f} against {loss_want.item():.6f}, relative "
          f"{loss_rel:.3e} (limit 1e-5); {len(want)} gradients, the worst at {worst:.3f} of its "
          f"limit (1e-4 of its largest |grad|): {worst_name}")
    if loss_rel > 1e-5 or worst > 1 or not finite:
        raise PhaseError(f"{tag}: the kernel path's loss or gradients are outside the limits")
    return shares


def kernel_vs_plain_step(cfg, batch, seed, expected, ph, tag):
    """One f32 loss and its gradients on the kernel path and on the plain
    path, on the same weights and batch; the kernel path launches exactly
    ``expected`` (K2 forward and recompute; plain recomputations in the
    backward) and calls no plain version."""
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    params = model.init(seed)
    _build.reset_counters()
    loss, met, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    counts = {"launches": dict(_build.launches), "backward": dict(_build.backward),
              "plain": dict(_build.plain)}
    if counts != expected:
        raise PhaseError(f"{tag}: counts {counts}; expected {expected}")
    plain_model = build_model(cfg, use_kernels=False)
    ploss, pmet, pgrads = loss_and_grads(plain_model, params, batch)
    print(f"[{ph}] {tag}: kernel path launches exactly {counts['launches']}, plain "
          f"recomputations in the backward {counts['backward']}, no plain call; aux "
          f"{met['aux'].item():.6e} (plain path {pmet['aux'].item():.6e})")
    shares = hold_grads(f"{tag} f32, kernel path against plain path", grads, pgrads, loss, ploss,
                        ph)
    del params, grads, pgrads
    torch.cuda.empty_cache()
    return shares


def bf16_train_step(cfg, batch, seed, tag):
    """11b, bf16: one loss and its gradients with K2's bf16 body, the one 11a
    runs, at 11a's batch, the kernel path against the plain path on the same
    weights. A plain f32 run of the same weights measures how far the plain
    bf16 path is from the arithmetic both bf16 paths round: the loss and
    each gradient (its max |difference| over its largest |grad|) may differ
    from the plain path's by twice the plain path's own distance from f32,
    as phase 5 holds the bf16 logits. The kernel path launches K2 twice a
    layer and recomputes the plain version once a layer, and calls no plain
    version."""
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    L = cfg.n_layers
    model = build_model(cfg)
    params = model.init(seed)
    _build.reset_counters()
    loss, _, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    counts = {"launches": dict(_build.launches), "backward": dict(_build.backward),
              "plain": dict(_build.plain)}
    expected = {"launches": kernel_counts(flash_attention=2 * L),
                "backward": kernel_counts(flash_attention=L),
                "plain": kernel_counts()}
    if counts != expected:
        raise PhaseError(f"{tag}: counts {counts}; expected {expected}")
    ploss, _, pgrads = loss_and_grads(build_model(cfg, use_kernels=False), params, batch)
    m32, p32 = f32_copy(cfg, params, device=model.device)
    floss, _, fgrads = loss_and_grads(m32, p32, batch)
    del m32, p32

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()

    rows = {"loss": (loss, ploss, floss), **{n: (grads[n], pgrads[n], fgrads[n]) for n in pgrads}}
    shares = {}
    for n, (k, p, f) in rows.items():
        err, floor = rel(k, p), rel(p, f)
        shares[n] = (err / (2 * floor) if floor > 0 else (0.0 if err == 0 else float("inf")),
                     err, floor, rel(k, f))
    worst = max(shares, key=lambda n: shares[n][0])
    finite = torch.isfinite(loss).item() and all(torch.isfinite(g).all() for g in grads.values())
    share, err, floor, from_f32 = shares[worst]
    ls, le, lf, lk = shares["loss"]
    print(f"[11b] {tag} bf16, kernel path against plain path ({time.perf_counter() - t0:.1f} s): "
          f"launches exactly {counts['launches']['flash_attention']} K2 and "
          f"{counts['backward']['flash_attention']} plain recomputations in the backward, no plain "
          f"call; loss {loss.item():.6f} against {ploss.item():.6f} (f32 {floss.item():.6f}): "
          f"relative {le:.3e}, the plain path from f32 {lf:.3e}, the kernel path from f32 "
          f"{lk:.3e}, {ls:.3f} of its limit; {len(grads)} gradients (max |difference| / largest "
          f"|grad|), the worst at {share:.3f} of its limit: {worst}, kernel against plain "
          f"{err:.3e}, plain from f32 {floor:.3e}, kernel from f32 {from_f32:.3e} (limit: twice "
          f"the plain path's distance from f32)")
    if share > 1 or not finite:
        raise PhaseError(f"{tag}: the bf16 kernel path's loss or gradients are outside the limits")
    del params, grads, pgrads, fgrads
    torch.cuda.empty_cache()


def rounding_readings(cfg, batch_n, seq, seed, expected, tag, shares):
    """11d, zamba2: how near its gradients come to their limit, read
    against their own f32 rounding. The kernel path against the plain path
    again at ``seed + 1`` (held as the first seed is), and the plain path
    against itself on the batch doubled (each row twice: the same loss and
    gradients, the f32 sums over tokens taken in another order; printed,
    not held), for the leaf nearest its limit at ``seed`` and the worst
    leaf of each reading."""
    from repro_torch.models.model import build_model

    leaf = max(shares, key=shares.get)
    again = kernel_vs_plain_step(cfg, train_batch(cfg, batch_n, seq, seed + 1), seed + 1,
                                 expected, "11d", f"{tag}, seed {seed + 1}")
    model = build_model(cfg, use_kernels=False)
    params = model.init(seed)
    batch = train_batch(cfg, batch_n, seq, seed)
    loss, _, grads = loss_and_grads(model, params, batch)
    dloss, _, dgrads = loss_and_grads(model, params, {k: torch.cat([v, v]) for k, v in batch.items()})
    floor = grad_shares(dgrads, grads)
    fworst = max(floor, key=floor.get)
    aworst = max(again, key=again.get)
    print(f"[11d] {cfg.arch_id} rounding readings, as shares of the 1e-4 limit: {leaf} kernel "
          f"against plain {shares[leaf]:.3f} at seed {seed}, {again[leaf]:.3f} at seed {seed + 1} "
          f"(worst there {aworst} {again[aworst]:.3f}); the plain path against itself on the batch "
          f"doubled (loss relative {abs(dloss.item() - loss.item()) / abs(loss.item()):.3e}): "
          f"{leaf} {floor[leaf]:.3f}, worst {fworst} {floor[fworst]:.3f}")
    del params, grads, dgrads
    torch.cuda.empty_cache()


def flash_autograd_cases(failures, train_shape) -> int:
    """11c: ``FlashAttention`` (the kernel's forward, the plain version's
    gradient) against autograd through the plain version. First the bf16
    kernel at 11a's shape ``train_shape`` (batch, q heads, kv heads, S, d;
    causal), the body and the count of kv tiles that carry every launch of
    11a; then wiring cases at phase 2's shapes in f32 and bf16: causal,
    non-causal and window 256 (where it masks); GQA group 1 and 4; fewer
    queries than keys. The output per row as phase 2 holds it; dq, dk and dv
    in f32 within 1e-4 of the largest value, in bf16 within phase 2's per-row
    limits. Each case launches K2 once and recomputes the plain version
    once."""
    from repro_torch.kernels import _build, ops, ref

    worst: dict[str, float] = {}  # the largest share of its limit, per dtype and tensor
    n = 0
    b_, qh, kvh, s, d = train_shape
    wiring = [((2, 8, 2, 200, 200, 64), [(True, None), (False, None)]),
              ((1, 4, 4, 77, 77, 128), [(True, None)]),
              ((1, 32, 8, 65, 250, 64), [(True, None), (False, None)]),
              ((1, 12, 12, 9, 1500, 64), [(False, None)]),
              ((1, 32, 32, 1024, 1024, 64), [(True, 256)])]
    cases = [(torch.bfloat16, (b_, qh, kvh, s, s, d), True, None)] + [
        (dtype, shape, causal, window) for dtype in (torch.float32, torch.bfloat16)
        for shape, modes in wiring for causal, window in modes]
    for dtype, (b_, qh, kvh, sq, skv, d), causal, window in cases:
        tol = TOL["flash_attention"][dtype]
        q = rand((b_, qh, sq, d), dtype, 2)
        k, v = rand((b_, kvh, skv, d), dtype, 3), rand((b_, kvh, skv, d), dtype, 4)
        w = rand((b_, qh, sq, d), torch.float32, 5)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        pins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        _build.reset_counters()
        out = ops.flash_attention(*ins, causal=causal, window=window)
        (out.float() * w).sum().backward()
        want = ref.attention_ref(*pins, causal=causal, window=window)
        (want.float() * w).sum().backward()
        name = (f"{dtype} {(b_, qh, kvh, sq, skv, d)} causal={causal} "
                f"window={window}").replace("torch.", "")
        counts = (_build.launches["flash_attention"], _build.backward["flash_attention"],
                  sum(_build.plain.values()))
        if counts != (1, 1, 0):
            failures.append(f"{name}: launches, backward, plain {counts}")
        pairs = [("out", out.detach(), want.detach())] + [
            (g, t.grad, pt.grad) for g, t, pt in zip(("dq", "dk", "dv"), ins, pins)]
        for what, got, ref_ in pairs:
            diff = (got.float() - ref_.float()).abs()
            if what != "out" and dtype == torch.float32:
                allowed = 1e-4 * ref_.abs().max()
            else:
                lim = row_limits(ref_, dtype, tol)
                allowed = lim + lim * ref_.float().abs()
            share = (diff / allowed).nan_to_num(nan=0.0, posinf=float("inf")).max().item()
            key = f"{'11a shape ' if n == 0 else ''}{str(dtype).replace('torch.', '')} {what}"
            worst[key] = max(worst.get(key, 0.0), share)
            if share > 1 or got.dtype != dtype or not torch.isfinite(got).all():
                failures.append(f"{name} {what}: {diff.max().item():.3e}, {share:.2f} "
                                f"of its limit, dtype {got.dtype}")
        n += 1
        del ins, pins, out, want, pairs
    _build.reset_counters()
    print(f"[11c] FlashAttention against autograd through the plain version: {n} cases, "
          f"{len(failures)} failures (gradients: f32 1e-4 of the largest value, bf16 phase 2's "
          f"per-row limits; outputs as phase 2); the largest share of a limit: "
          + "; ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items())))
    return n


def held_flash_row(shape, failures) -> None:
    """11c: the bf16 kernel at 11a's ``shape`` (batch, q heads, kv heads, S,
    d; causal) on the inputs :func:`flash_row` times for the kernels line,
    held per row against the plain version as phase 2 holds it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    bq, qh, kvh, s, d = shape
    q, k, v = rand((bq, qh, s, d), torch.bfloat16, 5), rand((bq, kvh, s, d), torch.bfloat16, 6), rand((bq, kvh, s, d), torch.bfloat16, 7)
    worst = {}
    compare(f"flash_attention bf16 q({bq},{qh},{s},{d}) kv({bq},{kvh},{s},{d}) causal",
            lambda: flash_attention(q, k, v, causal=True), ref.attention_ref(q, k, v, causal=True),
            failures, worst, tol=TOL["flash_attention"][torch.bfloat16], per_row=True)
    err, at, share = worst["flash_attention bf16"]
    print(f"[11c] flash_attention bf16 q({bq},{qh},{s},{d}) kv({bq},{kvh},{s},{d}) causal, the "
          f"kernels line's inputs, against the plain version: max_abs_err {err:.4e} at |want| "
          f"{at:.4f}, {share:.3f} of its per-row limit; two calls equal")


def train_profile(step, params, state, batch, wall_ms, card_str):
    """One training step under ``torch.profiler``: kernels, device busy time
    and idle share against ``wall_ms``; K2's forward and the plain attention
    backward (the kernels under its profiler range) as shares of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import BACKWARD_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name != BACKWARD_RANGE]
    if not dev:
        raise PhaseError("torch.profiler recorded no device activity in a training step")
    copies = sum(1 for e in dev if e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    k2 = sum(e.time_range.elapsed_us() for e in dev if "flash_tc_kernel" in e.name
             or "flash_kernel" in e.name) / 1e3
    k2_n = sum(1 for e in dev if "flash_tc_kernel" in e.name or "flash_kernel" in e.name)
    ranges = [e for e in events if e.name == BACKWARD_RANGE and e.device_type == DeviceType.CPU]
    bwd = sum(e.device_time_total for e in ranges) / 1e3
    print(f"[11f] profiled step: {len(dev) - copies} kernels and {copies} copies/sets, "
          f"{busy:.3f} ms of device time against {wall_ms:.3f} ms of unprofiled wall: idle share "
          f"{1 - busy / wall_ms:.3f}; K2 forward {k2_n} launches, {k2:.3f} ms ({k2 / wall_ms:.4f} of "
          f"the step); the plain attention backward in {len(ranges)} ranges, {bwd:.3f} ms of "
          f"kernels ({bwd / wall_ms:.4f} of the step){'' if bwd > 0 else ' (not measured: the profiler gave the ranges no device time)'} ({card_str})")
    print(f"[11f] heaviest kernels of the step (share of kernel time): {heaviest(dev)}")
    return bwd


def train_phase(args, card_str):
    """11a-f: llama3.2-1b takes ``TRAIN_STEPS`` AdamW steps at full width and
    depth on the card with K2 carrying attention's forward; the kernel path
    against the plain path; FlashAttention alone; the other families; a
    checkpoint round trip; times. Returns the kernels-line entry of K2 at the
    training shape."""
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import TrainConfig, make_optimizer, make_train_step, to_device

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=2)

    # 11a. the main path: TRAIN_STEPS steps through make_train_step
    model = build_model(cfg)
    params = model.init(args.seed)
    opt = make_optimizer(tc)
    state = opt.init(params)
    step = make_train_step(model, opt, remat=True)
    data = TokenStream(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=args.seed)
    batches = [to_device(next(data), model.device) for _ in range(TRAIN_STEPS + TRAIN_TIMED + 1)]
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # parameters, optimizer state, batches, earlier phases
    ops.reset_counters()
    walls, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, met = step(params, state, batches[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(met["loss"].item())
    counts = {"launches": dict(ops.launches), "backward": dict(ops.backward),
              "plain": dict(ops.plain)}
    peak = torch.cuda.max_memory_allocated()
    expected = {"launches": kernel_counts(flash_attention=TRAIN_STEPS * 2 * L),
                "backward": kernel_counts(flash_attention=TRAIN_STEPS * L),
                "plain": kernel_counts()}
    print(json.dumps({"train_counters": counts}))
    print(f"[11a] {TRAIN_ARCH} full width and depth ({L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}, tied; "
          f"{n_params / 1e9:.4f} B params, {cfg.dtype}, f32 master/mu/nu), remat on, {TRAIN_STEPS} "
          f"steps at batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          + " ".join(f"{x:.4f}" for x in losses))
    if counts != expected:
        raise PhaseError(f"training launches {counts}; expected {expected}")
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last5 < first:
        raise PhaseError(f"training loss not finite or not falling: first {first}, "
                         f"mean of the last 5 {last5}")
    print(f"[11a] launches exactly 2 x {L} K2 a step (forward and remat recompute), {L} plain "
          f"backward recomputations a step, no plain call, no K1 or K3; loss finite, first "
          f"{first:.4f}, mean of the last 5 {last5:.4f}")

    # 11f. times (the main path's walls; then instrumented steps and a profile)
    wall = float(np.mean(walls[2:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops = 6 * n_params * tokens
    attn_flops = 6 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ**2 * cfg.head_dim * L  # causal: half of 12
    # the gradient read twice (the global-norm clip needs every gradient
    # before any update), the parameter written, master/mu/nu read and written
    opt_bytes = sum(p.numel() * (3 * p.element_size() + 3 * 2 * 4) for p in params.parameters())
    parts = []
    for i in range(TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        params.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = model.loss(params, batches[TRAIN_STEPS + i], remat=True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.update({n: p.grad for n, p in params.named_parameters()}, state, params)
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    parts = np.asarray(parts)
    print(f"[11f] step wall (host clock around torch.cuda.synchronize), steps 3-{TRAIN_STEPS}: "
          f"{' '.join(f'{w:.2f}' for w in walls[2:])} ms; mean {wall:.3f} ms, min "
          f"{min(walls[2:]):.3f}, max {max(walls[2:]):.3f} (steps 1-2: {walls[0]:.1f}, "
          f"{walls[1]:.1f} ms) ({card_str})")
    print(f"[11f] CUDA events, {TRAIN_TIMED} instrumented steps: forward "
          f"{' '.join(f'{x:.3f}' for x in parts[:, 0])} ms, backward (with the remat "
          f"recompute) {' '.join(f'{x:.3f}' for x in parts[:, 1])} ms, optimizer "
          f"{' '.join(f'{x:.3f}' for x in parts[:, 2])} ms ({card_str})")
    print(f"[11f] {tokens / (wall / 1e3):.1f} tokens/s; MFU {(model_flops + attn_flops) / (wall / 1e3) / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"= (6 N T + 6 B H S^2 d L) / step time / 989 TFLOP/s, with N = {n_params} params, "
          f"T = {tokens} tokens: 6 N T = {model_flops / 1e12:.3f} TFLOP, causal attention "
          f"(forward and backward, half the S^2 pairs) {attn_flops / 1e12:.3f} TFLOP; the remat "
          f"recompute is not counted ({card_str})")
    print(f"[11f] optimizer byte bound: {opt_bytes / 1e9:.2f} GB (the gradient read twice in "
          f"bf16, once for the global-norm clip and once for the update; the parameter written "
          f"once in bf16; master/mu/nu read and written in f32) / 3.35 TB/s = "
          f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, against {parts[:, 2].mean():.3f} ms "
          f"measured; max_memory_allocated over the {TRAIN_STEPS} steps {peak / 1e9:.3f} GB "
          f"({peak / 2**30:.3f} GiB), {held / 1e9:.3f} GB of it allocated before the first step "
          f"(parameters, optimizer state, batches, and what earlier phases hold) ({card_str})")
    train_profile(step, params, state, batches[-1], wall, card_str)
    del model, params, state, opt, batches, step
    torch.cuda.empty_cache()
    print(f"[11a] took {time.perf_counter() - t0:.1f} s")

    # 11b. kernel path against plain path, f32, full width, PLAIN_LAYERS layers
    cfg32 = dataclasses.replace(cfg, n_layers=PLAIN_LAYERS, dtype="float32")
    kernel_vs_plain_step(
        cfg32, train_batch(cfg32, PLAIN_BATCH, PLAIN_SEQ, args.seed), args.seed,
        {"launches": kernel_counts(flash_attention=2 * PLAIN_LAYERS),
         "backward": kernel_counts(flash_attention=PLAIN_LAYERS),
         "plain": kernel_counts()},
        "11b", f"{TRAIN_ARCH} full width, {PLAIN_LAYERS} layers, batch {PLAIN_BATCH} x {PLAIN_SEQ}")
    cfg16 = dataclasses.replace(cfg, n_layers=BF16_TRAIN_LAYERS)
    bf16_train_step(cfg16, train_batch(cfg16, TRAIN_BATCH, TRAIN_SEQ, args.seed), args.seed,
                    f"{TRAIN_ARCH} full width, {BF16_TRAIN_LAYERS} layers, batch {TRAIN_BATCH} x "
                    f"{TRAIN_SEQ}")

    # 11c. FlashAttention alone: under autograd, then the kernels line's inputs
    shape = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, cfg.head_dim)
    failures: list[str] = []
    flash_autograd_cases(failures, shape)
    held_flash_row(shape, failures)
    for f in failures:
        print(f"    FAIL {f}")
    if failures:
        raise PhaseError(f"{len(failures)} FlashAttention checks outside the limits")

    # 11d. the other families
    t1 = time.perf_counter()
    for arch, cut in TRAIN_FAMILIES.items():
        cut = dict(cut)
        batch_n, seq = cut.pop("batch"), cut.pop("seq")
        c = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        batch = train_batch(c, batch_n, seq, args.seed)
        tag = f"{arch} full width, " + ", ".join(f"{k} {v}" for k, v in cut.items()) + \
            f", batch {batch_n} x {seq}"
        if c.family == "xlstm":
            xlstm_train_card_vs_cpu(c, batch, args.seed, tag)
            continue
        if c.family == "encdec":  # K2 once an encoder layer, twice a decoder layer (self, cross)
            bwd = c.n_encoder_layers + 2 * c.n_layers
            fwd = 2 * bwd  # and again in each layer's recomputation
        elif c.family == "hybrid":  # the shared block is not recomputed
            fwd = bwd = c.n_layers // c.hybrid_attn_every
        else:
            fwd, bwd = 2 * c.n_layers, c.n_layers
        # under autograd the SSD scan is the plain one: each Mamba2 block and its recompute
        ssd = 2 * c.n_layers if c.family == "hybrid" else 0
        # the queue positions go to their kernel: each MoE layer and its recompute
        moe = 2 * c.n_layers if c.moe is not None else 0
        expected = {"launches": kernel_counts(flash_attention=fwd, moe_positions=moe),
                    "backward": kernel_counts(flash_attention=bwd),
                    "plain": kernel_counts(ssd_chunked=ssd)}
        shares = kernel_vs_plain_step(c, batch, args.seed, expected, "11d", tag)
        if c.family == "hybrid":
            rounding_readings(c, batch_n, seq, args.seed, expected, tag, shares)
    print(f"[11d] took {time.perf_counter() - t1:.1f} s")

    # 11e. checkpoint round trip
    checkpoint_round_trip(cfg, args.seed, save, restore)

    # K2 at the training shape, for the kernels line (launches: 11a's; the
    # same inputs held per row in 11c)
    rows = report_rows(
        [("flash_attention", flash_row(shape))],
        {"flash_attention": counts["launches"]["flash_attention"]}, card_str, "11f",
        suffix=f"[train {TRAIN_ARCH}]")
    print(f"[11] phase 11 took {time.perf_counter() - t0:.1f} s")
    return rows


def xlstm_train_card_vs_cpu(cfg, batch, seed, tag):
    """11d for xlstm: no kernel on its path, so the card's f32 loss and
    gradients are held against the CPU's on the same weights and batch."""
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    card_m = build_model(cfg)
    card_p = card_m.init(seed)
    cpu_m, cpu_p = f32_copy(cfg, card_p, device="cpu")
    _build.reset_counters()
    loss, _, grads = loss_and_grads(card_m, card_p, batch)
    if sum(_build.launches.values()) + sum(_build.plain.values()) + sum(_build.backward.values()):
        raise PhaseError(f"{XLSTM}: a kernel or plain version ran in training")
    closs, _, cgrads = loss_and_grads(cpu_m, cpu_p, {k: v.cpu() for k, v in batch.items()})
    hold_grads(f"{tag} f32, card against CPU (no kernel; {time.perf_counter() - t0:.1f} s)",
               grads, cgrads, loss.cpu(), closs, "11d")
    del card_p, cpu_p, grads, cgrads
    torch.cuda.empty_cache()


def checkpoint_round_trip(cfg, seed, save, restore):
    """11e: train CKPT_LAYERS layers of ``cfg`` (bf16, full width) 3 steps,
    save, take a 4th step; restore into fresh modules and state and take the
    4th step again: the loss and every parameter bitwise equal."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import TrainConfig, make_optimizer, make_train_step, to_device

    t0 = time.perf_counter()
    c = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
    model = build_model(c)
    opt = make_optimizer(TrainConfig(peak_lr=1e-3, warmup_steps=2))
    step = make_train_step(model, opt)
    data = TokenStream(vocab=c.vocab, batch=CKPT_BATCH, seq_len=CKPT_SEQ, seed=seed)
    batches = [to_device(next(data), model.device) for _ in range(4)]
    params = model.init(seed)
    state = opt.init(params)
    for b in batches[:3]:
        step(params, state, b)
    path = ROOT / "build" / "chip_smoke_ckpt.npz"
    try:
        save(path, {"params": params, "opt": state})
        size = path.stat().st_size
        _, _, met = step(params, state, batches[3])
        fresh = model.init(seed + 1)
        fstate = opt.init(fresh)
        restore(path, {"params": fresh, "opt": fstate})
    finally:
        path.unlink(missing_ok=True)
    _, _, fmet = step(fresh, fstate, batches[3])
    same = torch.equal(met["loss"], fmet["loss"]) and all(
        torch.equal(a, b) for a, b in zip(params.parameters(), fresh.parameters())) and all(
        torch.equal(state.master[n], fstate.master[n]) for n in state.master)
    print(f"[11e] checkpoint round trip, {TRAIN_ARCH} full width, {CKPT_LAYERS} layers, bf16, "
          f"batch {CKPT_BATCH} x {CKPT_SEQ}: saved after 3 steps ({size / 1e9:.3f} GB .npz), "
          f"restored into fresh modules and state; step 4 loss {fmet['loss'].item():.6f} against "
          f"{met['loss'].item():.6f} uninterrupted; loss, parameters and master bitwise equal: "
          f"{same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise PhaseError("checkpoint round trip: step 4 differs from the uninterrupted run")
    del params, fresh, state, fstate
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: multi-device and launch (M11)
# ---------------------------------------------------------------------------
SHARD_SLICES = (4, 8)   # 12c: slices of one cache, each with its global offset
DRYRUN_ARCH = "llama3.2-1b"
# 12d: (shape, --decode-attn, the hillclimb knobs) on the 16x16 fake mesh
DRYRUN_COMBOS = [("train_4k", "local", {}), ("prefill_32k", "local", {}),
                 ("decode_32k", "local", {}), ("long_500k", "local", {}),
                 ("decode_32k", "shard_map", {}),
                 ("train_4k", "local", {"dp_only": True}), ("train_4k", "local", {"fsdp": True}),
                 ("train_4k", "local", {"accum_steps": 2}),
                 ("train_4k", "local", {"seq_parallel": True})]


def launcher_phase(card_str):
    """12a: ``repro_torch.launch.serve`` at its defaults, on the card."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main([])
    line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue().strip() else ""
    print(f"[12a] python -m repro_torch.launch.serve (defaults: qwen3-0.6b smoke, 16 requests, "
          f"on the card): {line!r} ({time.perf_counter() - t0:.1f} s, {card_str})")
    if not line.startswith("served 16 requests"):
        raise PhaseError("the serving launcher printed no summary line")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def lse_slices_phase(main_shapes, card_str):
    """12c: the port's flash-decode (``models/attention.py``:
    ``flash_decode_slice`` on each of 4 and 8 slices of one full-width cache
    (phase 2's main decode case), each at its global offset, the new row
    written by the slice that holds its slot, one slice past the prefix and
    one straddling it; then ``merge_slices`` with a reduction over the
    stacked slices in place of the all-reduces), against unsharded K3 and
    the plain version on the cache with the row written, per row as phase 2,
    in bf16 and f32; each slice's log-sum-exp against the plain one's, and
    the slices' caches against the written cache, bitwise. Returns the
    largest error of the merged output against the plain version (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import attention

    bq, qh, kvh, rows, d = main_shapes["decode"]
    valid = main_shapes["decode_valid"]

    def stacked(t, op):  # the all-reduce over the model axis, on stacked slices
        return t.amax(0) if op == "max" else t.sum(0)

    failures, worst, errs = [], {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        q = rand((bq, qh, 1, d), dtype, 9)
        kc, vc = rand((bq, kvh, rows, d), dtype, 10), rand((bq, kvh, rows, d), dtype, 11)
        k_new, v_new = rand((bq, kvh, 1, d), dtype, 12), rand((bq, kvh, 1, d), dtype, 13)
        slot = torch.full((bq,), valid - 1, dtype=torch.int32, device=DEVICE)
        lens = torch.full((bq,), valid, dtype=torch.int32, device=DEVICE)
        kw, vw = kc.clone(), vc.clone()
        kw[:, :, valid - 1], vw[:, :, valid - 1] = k_new[:, :, 0], v_new[:, :, 0]
        whole = decode_attention(q, kw, vw, lens)
        plain = ref.decode_attention_ref(q, kw, vw, lens)
        tol = TOL["decode_attention"][dtype]
        for n in SHARD_SLICES:
            size = rows // n
            outs, lses, kinds, ks_all, vs_all = [], [], [], [], []
            for i in range(n):
                start = i * size
                ks = kc[:, :, start:start + size].contiguous()
                vs = vc[:, :, start:start + size].contiguous()
                o, lse = attention.flash_decode_slice(q, ks, vs, k_new, v_new, slot, lens, start,
                                                      sm_scale=d ** -0.5)
                local = min(max(valid - start, 0), size)
                _, want_lse = ref.decode_attention_ref(
                    q, ks, vs, torch.full((bq,), local, dtype=torch.int32, device=DEVICE),
                    return_lse=True)
                if local == 0:
                    kinds.append("empty")
                    if not torch.all(lse == float("-inf")):
                        failures.append(f"{n} slices: slice {i} has no valid row, lse not -inf")
                else:
                    kinds.append("full" if local == size else f"straddling ({local})")
                    e = (lse - want_lse).abs().max().item()
                    errs[f"lse {dtype}"] = max(errs.get(f"lse {dtype}", 0.0), e)
                    if e > 1e-4:
                        failures.append(f"{n} slices: slice {i} lse off by {e:.3e} (limit 1e-4)")
                outs.append(o)
                lses.append(lse)
                ks_all.append(ks)
                vs_all.append(vs)
            if not (torch.equal(torch.cat(ks_all, 2), kw) and torch.equal(torch.cat(vs_all, 2), vw)):
                failures.append(f"{n} slices: the new row was not written by its slice alone")
            merged = attention.merge_slices(torch.stack(outs), torch.stack(lses), stacked)
            name = f"decode_attention {dtype} {n} slices"
            errs[f"plain {dtype} {n}"] = compare(name + " vs plain", lambda: merged, plain,
                                                 failures, worst, tol=tol, per_row=True)
            errs[f"k3 {dtype} {n}"] = compare(name + " vs unsharded K3", lambda: merged, whole,
                                              failures, worst, tol=tol, per_row=True)
            print(f"[12c] the port's flash-decode (K3 log-sum-exp form), {n} slices of {size} "
                  f"rows of cache ({bq},{kvh},{rows},{d}) {str(dtype)[6:]}, valid {valid}, row "
                  f"{valid - 1} written by its slice: slices {', '.join(kinds)}; caches bitwise "
                  f"the written one; merged against plain {errs[f'plain {dtype} {n}']:.3e}, "
                  f"against unsharded K3 {errs[f'k3 {dtype} {n}']:.3e} (per-row limits, tol "
                  f"{tol}); slice lse against plain at most {errs.get(f'lse {dtype}', 0.0):.3e} "
                  f"({card_str})")
    if failures:
        raise PhaseError("; ".join(failures))
    return max(errs[f"plain {torch.bfloat16} {n}"] for n in SHARD_SLICES)


def sharded_serving_phase(args, card_str, ServeRequest):
    """12b and 12e's step times: full-width llama3.2-1b on a (1, 1)
    ("data", "model") NCCL mesh with ``DECODE_ATTN_MODE = "shard_map"`` and
    the cache placed along its length: 8 ragged prompts, 32 greedy steps
    each, eagerly; against the unsharded eager path on the same weights."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import _build
    from repro_torch.launch import shardings
    from repro_torch.models import attention
    from repro_torch.models.layers import gather_logits
    from repro_torch.models.model import build_model, greedy_token
    from repro_torch.serving.backend import _bucket

    cfg = get_config("llama3.2-1b")
    steps, L = args.new_tokens, cfg.n_layers
    reqs = make_requests(cfg, args.requests, steps, args.seed, ServeRequest)
    model = build_model(cfg)
    params = model.init(args.seed)

    def run(req, sharded):
        prompt = prompt_of(req)
        cache = model.init_cache(1, prompt.shape[1] + steps)
        if sharded:
            cache, _ = shardings.place_cache(cache, cfg, mesh)
        logits, _ = model.prefill(params, {"tokens": prompt}, cache)
        logits = gather_logits(params, logits)
        out, seen = [], [logits[:, -1:]]
        tok = greedy_token(logits[:, -1:])
        for _ in range(steps):
            out.append(tok)
            logits, _ = model.decode_step(params, cache, tok)
            logits = gather_logits(params, logits)
            seen.append(logits)
            tok = greedy_token(logits)
        return torch.cat(out, 1), torch.cat(seen, 1)

    # 12f's bucket: every request's cache of ``rows`` rows, so that one
    # decode graph serves them all
    rows = _bucket(max(len(r.prompt) for r in reqs) + steps, base=8)

    def run_captured(req, cache):
        """``prefill_jit`` and ``decode_tokens`` (CUDA graphs): the first
        token and ``steps`` more."""
        logits, _ = model.prefill_jit(params, {"tokens": prompt_of(req)}, cache)
        tok = greedy_token(gather_logits(params, logits))
        out, _ = model.decode_tokens(params, cache, tok, steps)
        return torch.cat([tok, out], 1)

    t0 = time.perf_counter()
    want = [run(r, False) for r in reqs]
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    want_graph = [run_captured(r, model.static_cache(1, rows)) for r in reqs]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    knobs = (attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = "shard_map", True
        with sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)):
            shardings.place_params(params, cfg, mesh)
            _build.reset_counters()
            sh.reset_comm_counters()
            t0 = time.perf_counter()
            got = [run(r, True) for r in reqs]
            torch.cuda.synchronize()
            t_sharded = time.perf_counter() - t0
            counts = {"launches": dict(_build.launches), "plain": dict(_build.plain),
                      "form_launches": dict(_build.form_launches),
                      "collectives": dict(sh.comm_counts)}
            print(json.dumps({"counters": {"path": "sharded llama3.2-1b", **counts}}))
            n = len(reqs)
            expected = {"launches": kernel_counts(flash_attention=L * n),
                        "plain": kernel_counts(),
                        "form_launches": {"decode_attention_lse": L * steps * n},
                        "collectives": 0}
            if (counts["launches"] != expected["launches"] or counts["plain"] != expected["plain"]
                    or counts["form_launches"] != expected["form_launches"]
                    or sum(counts["collectives"].values()) != expected["collectives"]):
                raise PhaseError(f"sharded serving counts {counts}; expected {expected}")
            same = all(torch.equal(a[0], b[0]) for a, b in zip(got, want))
            err = max(((a[1].float() - b[1].float()).abs().max() / b[1].float().abs().max()).item()
                      for a, b in zip(got, want))
            print(f"[12b] llama3.2-1b full width ({L} layers, bf16) on a (1, 1) (data, model) "
                  f"NCCL mesh, DECODE_ATTN_MODE shard_map, cache along its length: {n} ragged "
                  f"prompts ({min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)} "
                  f"tokens) x {steps} greedy steps eagerly; K2 {counts['launches']['flash_attention']}, "
                  f"K3 log-sum-exp form {counts['form_launches']['decode_attention_lse']} "
                  f"(= {L} x {steps} x {n}: one a layer a step, each merged by merge_slices), K3 0, "
                  f"plain 0; collectives {sum(counts['collectives'].values())} (every one skipped "
                  f"at size 1; the merge's 3 all-reduces a call are held on gloo groups); "
                  f"tokens identical to the unsharded eager path: {same}; max |logit difference| / "
                  f"max |logit| {err:.3e} (limit {BF16_LOGIT_LIMIT:.1e}); wall {t_sharded:.2f} s "
                  f"sharded, {t_plain:.2f} s unsharded ({card_str})")
            if not same or err > BF16_LOGIT_LIMIT:
                raise PhaseError("the sharded decode disagrees with the unsharded path")

            captured_sharded(model, params, reqs, steps, rows, want, want_graph, run_captured,
                             card_str)

            # 12e: one request's eager decode step, unsharded and sharded in turns
            req = max(reqs, key=lambda r: len(r.prompt))
            prompt = prompt_of(req)

            def step_ms(sharded, profile=False):
                """One eager step's ms, or with ``profile`` its host profile."""
                cache = model.init_cache(1, prompt.shape[1] + steps)
                placed = {m: m.tp for m in params.modules() if "tp" in vars(m)}
                if sharded:
                    cache, _ = shardings.place_cache(cache, cfg, mesh)
                else:  # the unsharded path: no module placed
                    for m in placed:
                        m.tp = None
                attention.DECODE_ATTN_MODE = "shard_map" if sharded else "local"
                try:
                    logits, _ = model.prefill(params, {"tokens": prompt}, cache)
                    tok = greedy_token(logits[:, -1:])
                    for _ in range(3):
                        model.decode_step(params, cache, tok)
                    cache["lengths"].fill_(prompt.shape[1])

                    def run_steps():
                        tok_ = tok
                        for _ in range(steps):
                            logits, _ = model.decode_step(params, cache, tok_)
                            tok_ = greedy_token(gather_logits(params, logits))

                    if profile:
                        return host_profile(run_steps, steps)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    run_steps()
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t) * 1e3 / steps
                finally:
                    for m, tp in placed.items():
                        m.tp = tp

            turns = [("unsharded", step_ms(False)), ("sharded", step_ms(True)),
                     ("sharded", step_ms(True)), ("unsharded", step_ms(False))]
            print(f"[12e] eager decode step of one {prompt.shape[1]}-token request, host clock "
                  f"over {steps} steps with a device synchronize, in turns: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in turns) + f" ({card_str})")
            for sharded in (False, True):
                print(f"[12e] {'sharded' if sharded else 'unsharded'} step under torch.profiler: "
                      f"{step_ms(sharded, profile=True)} ({card_str})")
            captured_step_turns(model, params, cfg, mesh, prompt, steps, rows, turns, card_str)
        return counts["form_launches"]["decode_attention_lse"]
    finally:
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = knobs
        for m in params.modules():
            if hasattr(m, "tp") and "tp" in vars(m):
                del m.tp
        dist.destroy_process_group()


def captured_sharded(model, params, reqs, steps, rows, want, want_graph, run_captured,
                     card_str):
    """12f: the requests of 12b through ``prefill_jit`` and ``decode_tokens``
    on the mesh (CUDA graphs of the placed model, on its placed static
    cache), against the unsharded captured path (``want_graph``, captured
    before the mesh existed): tokens bitwise, launches exact and counted by
    replays, no collective, and the sharded decode graph captured under a
    key of its own (at size 1 the placement keeps every weight tensor)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import _build

    L, n = model.cfg.n_layers, len(reqs)
    before = dict(model.graph_stats)
    decode_before = [k for k in model.graphs.graphs if k[0] == "decode"]
    static = model.static_cache(1, rows, params)
    _build.reset_counters()
    sh.reset_comm_counters()
    t0 = time.perf_counter()
    got = [run_captured(r, static) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"launches": dict(_build.launches), "plain": dict(_build.plain),
              "form_launches": dict(_build.form_launches), "form_plain": dict(_build.form_plain),
              "collectives": dict(sh.comm_counts)}
    print(json.dumps({"counters": {"path": "captured sharded llama3.2-1b", **counts}}))
    decode_keys = [k for k in model.graphs.graphs if k[0] == "decode"]
    new = {k: v - before[k] for k, v in model.graph_stats.items()}
    same = all(torch.equal(a, b) for a, b in zip(got, want_graph))
    eager_same = sum(torch.equal(a[:, :steps], b[0]) for a, b in zip(want_graph, want))
    expected = {"launches": kernel_counts(flash_attention=L * n),
                "plain": kernel_counts(),
                "form_launches": {"decode_attention_lse": L * steps * n},
                "form_plain": {"decode_attention_lse": 0}}
    print(f"[12f] llama3.2-1b full width ({L} layers, bf16) on the (1, 1) mesh, DECODE_ATTN_MODE "
          f"shard_map, captured: {n} requests through prefill_jit and decode_tokens ({steps} "
          f"greedy steps, one {rows}-row placed static cache); tokens identical to the "
          f"unsharded captured path: {same} (unsharded captured against unsharded eager: "
          f"{eager_same} of {n}); K2 {counts['launches']['flash_attention']}, K3 log-sum-exp "
          f"form {counts['form_launches']['decode_attention_lse']} (= {L} x {steps} x {n}, "
          f"counted by replays), K3 {counts['launches']['decode_attention']}, plain "
          f"{sum(counts['plain'].values()) + sum(counts['form_plain'].values())}, collectives "
          f"{sum(counts['collectives'].values())}; graphs: {new['captures']} captured, "
          f"{new['replays']} replayed, {new['dropped']} dropped; decode graphs {len(decode_keys)} "
          f"(unsharded bucket {decode_before[0][:4] if decode_before else None}, sharded "
          f"{[k for k in decode_keys if k not in decode_before]}); wall {wall:.2f} s "
          f"({card_str})")
    if not same:
        raise PhaseError("the captured sharded decode disagrees with the unsharded captured path")
    if ({k: counts[k] for k in expected} != expected
            or sum(counts["collectives"].values()) != 0):
        raise PhaseError(f"captured sharded counts {counts}; expected {expected}, no collective")
    if (len(decode_before) != 1 or len(decode_keys) != 2 or new["dropped"] != 0
            or len({k[:4] for k in decode_keys}) != 1):
        raise PhaseError(f"expected one decode graph for each of the unsharded and the sharded "
                         f"bucket, none dropped: before {decode_before}, after {decode_keys}, "
                         f"stats {new}")


def captured_step_turns(model, params, cfg, mesh, prompt, steps, rows, eager_turns, card_str):
    """12e: one request's captured decode step, unsharded and sharded in
    turns (the unsharded program is the placed model with its ``tp``
    taken off, in the mesh: a graph of its own): ms a step between CUDA
    events around the replayed loop, and under ``torch.profiler`` kernels a
    step and their time; the idle share is phase 6's, 1 - that kernel time
    / the unprofiled wall. Tracing lengthens the kernels a little and
    spreads a replay's launches much more, so a graph whose kernels run back
    to back reads a little below 0, and one taken from the profiled span
    alone would read gaps the tracing made. Printed beside 12e's eager
    steps."""
    from repro_torch.launch import shardings
    from repro_torch.models import attention
    from repro_torch.models.layers import gather_logits
    from repro_torch.models.model import greedy_token

    placed = {m: m.tp for m in params.modules() if "tp" in vars(m)}

    def turn(sharded):
        if not sharded:
            for m in placed:
                m.tp = None
        attention.DECODE_ATTN_MODE = "shard_map" if sharded else "local"
        try:
            cache = model.static_cache(1, rows, params)
            logits, _ = model.prefill_jit(params, {"tokens": prompt}, cache)
            tok = greedy_token(gather_logits(params, logits))
            filled = prompt.shape[1]
            model.decode_tokens(params, cache, tok, steps)  # captured here at a first turn
            out = {}
            for label in ("timed", "profiled"):
                cache["lengths"].fill_(filled)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                if label == "timed":
                    model.decode_tokens(params, cache, tok, steps)
                    end.record()
                    end.synchronize()
                    out["wall"] = (time.perf_counter() - t0) * 1e3 / steps
                    out["ms"] = start.elapsed_time(end) / steps
                else:
                    kernels, _, busy, _, _ = profiled(
                        lambda: model.decode_tokens(params, cache, tok, steps))
                    out["kernels"], out["busy"] = kernels / steps, busy / steps
            return out
        finally:
            for m, tp in placed.items():
                m.tp = tp
            attention.DECODE_ATTN_MODE = "shard_map"

    turns = [("unsharded", turn(False)), ("sharded", turn(True)), ("sharded", turn(True)),
             ("unsharded", turn(False))]
    print(f"[12e] captured decode step of one {prompt.shape[1]}-token request ({steps}-step "
          f"graph, {rows}-row cache), in turns: " + "; ".join(
              f"{k} {t['ms']:.4f} ms a step between CUDA events ({t['wall']:.4f} ms host wall), "
              f"{t['kernels']:.1f} kernels and {t['busy']:.4f} ms of kernels a step, idle share "
              f"{1 - t['busy'] / t['wall']:.3f}" for k, t in turns)
          + " | eager, 12e above: " + ", ".join(f"{k} {v:.3f} ms" for k, v in eager_turns)
          + f" ({card_str})")


def host_profile(fn, n_steps: int, top: int = 8) -> str:
    """``fn()`` (``n_steps`` eager decode steps) under ``torch.profiler``:
    per step the device's busy ms, the host self time (the profiler's own
    cost inflates it), that of the collectives (``record_param_comms`` and
    the c10d/NCCL ops) and the ``top`` host ops by self time, with their
    calls a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _, _, busy, _, _ = profiled_events(prof)
    avg = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    coll = sum(e.self_cpu_time_total for e in avg if any(
        k in e.key.lower() for k in ("nccl", "c10d", "allreduce", "all_reduce", "param_comms")))
    host = sum(e.self_cpu_time_total for e in avg)
    heavy = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:top]
    return (f"device busy {busy / n_steps:.3f} ms a step, host self time "
            f"{host / 1e3 / n_steps:.3f} ms of which collectives {coll / 1e3 / n_steps:.3f} ms; "
            "heaviest host ops a step: " + "; ".join(
                f"{e.key[:48]} {e.self_cpu_time_total / 1e3 / n_steps:.3f} ms in "
                f"{e.count / n_steps:g}" for e in heavy))


_DRYRUN = r"""
import json, sys
from repro_torch.launch.dryrun import run_one
combos = json.loads(sys.argv[1])
out = [run_one(sys.argv[2], s, decode_attn=a, tag="_".join(([] if a == "local" else [a])
                                                            + sorted(k)), **k)
       for s, a, k in combos]
print(json.dumps(out))
"""


def dryrun_phase(card_str):
    """12d: the port's dry-run of llama3.2-1b at its four shapes on the 16x16
    fake mesh, decode_32k with the length-sharded flash-decode, and train_4k
    under each of ``repro``'s hillclimb knobs (``--dp-only``, ``--fsdp``,
    ``--accum-steps 2``, ``--seq-parallel``) beside the baseline: host work
    in a child process (a fake process group is process-global)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _DRYRUN, json.dumps(DRYRUN_COMBOS), DRYRUN_ARCH],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    if res.returncode != 0:
        raise PhaseError(f"dry-run failed: {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        if line.startswith(("OK", "SKIP", "FAIL")):
            print(f"[12d] {line}")
    results = json.loads(res.stdout.strip().splitlines()[-1])
    failed = [f"{r['arch']} x {r['shape']} [{r.get('tag', '')}]: {r.get('error', r['status'])}"
              for r in results if r["status"] != "ok"]
    if failed:
        raise PhaseError("dry-run failed: " + "; ".join(failed))
    base = None
    for r in results:
        f = r["roofline"]
        knob = r["tag"] if r["tag"] not in ("", "shard_map") else r["opts"]["decode_attn"]
        coll = ", ".join(f"{k} {f['collective_counts'][k]} ({v / 1e6:.3f} MB)"
                         for k, v in f["collective_bytes_by_kind"].items() if f["collective_counts"][k])
        if r["shape"] == "train_4k":
            m = r["memory"]
            row = (m["argument_bytes"], m["temp_bytes"], f["collective_bytes_per_dev"])
            base = base or row
            print(f"[12d] {r['arch']} x train_4k [{knob}] per device: argument "
                  f"{row[0] / 2**30:.3f} GiB, temp {row[1] / 2**30:.3f} GiB, wire "
                  f"{row[2] / 1e9:.4f} GB; against the baseline x{row[0] / base[0]:.3f}, "
                  f"x{row[1] / base[1]:.3f}, x{row[2] / base[2]:.3f}")
        print(f"[12d] {r['arch']} x {r['shape']} [{knob}] per device: "
              f"{f['flops_per_dev']:.4e} FLOP, {f['hbm_bytes_per_dev']:.4e} HBM bytes "
              f"(estimate), {f['collective_bytes_per_dev']:.4e} wire bytes ({coll or 'none'}); "
              f"H100 SXM5 data-sheet terms compute {f['t_compute_s']:.4e} s, memory "
              f"{f['t_memory_s']:.4e} s, collective {f['t_collective_s']:.4e} s -> "
              f"{f['bottleneck']}; args {r['memory']['argument_bytes'] / 2**30:.3f} GiB, temp "
              f"{r['memory']['temp_bytes'] / 2**30:.3f} GiB a device")
    print(f"[12d] dry-run of {len(results)} combos took {time.perf_counter() - t0:.1f} s on the "
          f"host (no device; {card_str} idle)")


def lse_time_row(main_shapes, launches, err, card_str):
    """12e: K3 with and without its log-sum-exp at 12c's shape, the plain
    version's pair, and aten's efficient attention with its log-sum-exp over
    the valid keys (kv heads repeated outside the timing) as the library
    call; the kernels line's entry for the form."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    bq, qh, kvh, rows, d = main_shapes["decode"]
    valid = main_shapes["decode_valid"]
    q = rand((bq, qh, 1, d), torch.bfloat16, 9)
    kc, vc = rand((bq, kvh, rows, d), torch.bfloat16, 10), rand((bq, kvh, rows, d), torch.bfloat16, 11)
    lens = torch.full((bq,), valid, dtype=torch.int32, device=DEVICE)
    bms, by = bound(2 * (2 * bq * kvh * valid * d + 2 * bq * qh * d) + 4 * bq + 4 * bq * qh,
                    4 * d * bq * qh * valid, torch.bfloat16)
    ms = graph_ms(lambda: decode_attention(q, kc, vc, lens, return_lse=True))
    ms_plain_k3 = graph_ms(lambda: decode_attention(q, kc, vc, lens))
    plain_ms = graph_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens, return_lse=True))
    kx = kc[:, :, :valid].repeat_interleave(qh // kvh, dim=1)
    vx = vc[:, :, :valid].repeat_interleave(qh // kvh, dim=1)
    lib_ms = graph_ms(
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q, kx, vx, None, True))
    print(f"[12e] decode_attention_lse q({bq},{qh},1,{d}) cache({bq},{kvh},{rows},{d}) valid "
          f"{valid} bf16: kernel with log-sum-exp {ms:.5f} ms, without {ms_plain_k3:.5f} ms | "
          f"bound {bms:.5f} ms ({by}) | plain {plain_ms:.5f} ms | library (efficient attention "
          f"with log-sum-exp) {lib_ms:.5f} ms | launches on the sharded path {launches} ({card_str})")
    src, replaces = SOURCES["decode_attention"]
    return [{"name": "decode_attention_lse", "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}]


def multidevice_phase(args, card_str, main_shapes):
    """Phase 12: the serving launcher, the sharded decode on a (1, 1) mesh,
    K3's log-sum-exp form over slices of one cache, the dry-run, and times."""
    from repro_torch.serving.backend import ServeRequest

    t0 = time.perf_counter()
    launcher_phase(card_str)
    launches = sharded_serving_phase(args, card_str, ServeRequest)
    err = lse_slices_phase(main_shapes, card_str)
    dryrun_phase(card_str)
    rows = lse_time_row(main_shapes, launches, err, card_str)
    torch.cuda.empty_cache()
    print(f"[12] phase 12 took {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 13: the recurrent families placed (M11b-4)
# ---------------------------------------------------------------------------


def placed_recurrent(arch, args, card_str, mesh, ServeRequest):
    """13a/13b: ``arch`` at full width served captured, unsharded (outside
    the mesh, before placement) and then placed on ``mesh``, phase 10a's
    requests; holds tokens bitwise, launches equal, no plain call, no
    collective and one decode graph a bucket; then the captured step's ms in
    turns. Returns (the placed run's launches, the longest prompt)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import _build
    from repro_torch.launch import shardings
    from repro_torch.models.layers import gather_logits
    from repro_torch.models.model import build_model, greedy_token
    from repro_torch.serving.backend import _bucket

    ph = "13a" if arch == ZAMBA else "13b"
    t0 = time.perf_counter()
    cfg = get_config(arch)
    steps = args.new_tokens
    reqs = make_requests(cfg, args.requests, steps, args.seed, ServeRequest)
    rows = _bucket(max(len(r.prompt) for r in reqs) + steps, base=8)
    model = build_model(cfg)
    params = model.init(args.seed)

    def run_captured(req, cache):
        logits, _ = model.prefill_jit(params, {"tokens": prompt_of(req)}, cache)
        tok = greedy_token(gather_logits(params, logits))
        out, _ = model.decode_tokens(params, cache, tok, steps)
        return torch.cat([tok, out], 1)

    def counted(fn):
        _build.reset_counters()
        sh.reset_comm_counters()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            "launches": dict(_build.launches), "plain": dict(_build.plain),
            "form_launches": dict(_build.form_launches), "form_plain": dict(_build.form_plain),
            "collectives": dict(sh.comm_counts)}

    want, wall_plain, base = counted(lambda: [run_captured(r, model.static_cache(1, rows))
                                              for r in reqs])
    # zamba2: K2 once an application of the shared block a request, K3 once
    # an application a decode step, the SSD kernel once a Mamba2 layer a
    # request; xlstm: no kernel
    n_attn = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    expected = kernel_counts(flash_attention=n_attn * len(reqs),
                             decode_attention=n_attn * len(reqs) * steps,
                             ssd_chunked=cfg.n_layers * len(reqs) if n_attn else 0)
    if base["launches"] != expected or sum(base["plain"].values()):
        raise PhaseError(f"{arch}: unsharded captured counts {base}; expected {expected}")
    decode_before = [k for k in model.graphs.graphs if k[0] == "decode"]
    with sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)):
        shardings.place_params(params, cfg, mesh)
        before = dict(model.graph_stats)
        static = model.static_cache(1, rows, params)
        got, wall, counts = counted(lambda: [run_captured(r, static) for r in reqs])
        new = {k: v - before[k] for k, v in model.graph_stats.items()}
        decode_keys = [k for k in model.graphs.graphs if k[0] == "decode"]
        print(json.dumps({"counters": {"path": f"captured placed {arch}", **counts}}))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        plain = sum(counts["plain"].values()) + sum(counts["form_plain"].values())
        split = sum(m.tp is not None and (m.tp.heads or m.tp.inner) for m in params.modules()
                    if "tp" in vars(m))
        print(f"[{ph}] {arch} full width ({cfg.n_layers} layers, bf16) placed on the (1, 1) "
              f"mesh ({split} blocks marked split), captured: {len(reqs)} requests through "
              f"prefill_jit and decode_tokens ({steps} greedy steps, one {rows}-row placed "
              f"static cache); tokens identical to the unsharded captured path: {same}; "
              f"launches {counts['launches']} against unsharded {base['launches']}, plain "
              f"{plain}, collectives {sum(counts['collectives'].values())}; graphs: "
              f"{new['captures']} captured, {new['replays']} replayed, {new['dropped']} dropped; "
              f"decode graphs {len(decode_keys)}; wall {wall:.2f} s placed, {wall_plain:.2f} s "
              f"unsharded (captures included) ({card_str})")
        if not same or not all(torch.isfinite(t.float()).all() for t in got):
            raise PhaseError(f"{arch}: the placed captured path disagrees with the unsharded one")
        if (counts["launches"] != base["launches"] or plain or counts["form_launches"] !=
                base["form_launches"] or sum(counts["collectives"].values())):
            raise PhaseError(f"{arch}: placed counts {counts}; expected the unsharded path's "
                             f"launches {base}, no plain call, no collective")
        if (len(decode_before) != 1 or len(decode_keys) != 2 or new["dropped"]
                or len({k[:4] for k in decode_keys}) != 1):
            raise PhaseError(f"{arch}: expected one decode graph for each of the unsharded and "
                             f"the placed bucket: before {decode_before}, after {decode_keys}")
    # 13c: one request's captured decode step, unsharded (the graphs captured
    # before placement: at one rank the placed weights are the same tensors)
    # and placed (in the mesh) in turns
    placed = {m: m.tp for m in params.modules() if "tp" in vars(m)}
    prompt = prompt_of(max(reqs, key=lambda r: len(r.prompt)))

    def turn(sharded):
        for m, tp in placed.items():
            m.tp = tp if sharded else None
        with (sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)) if sharded
              else contextlib.nullcontext()):
            cache = model.static_cache(1, rows, params if sharded else None)
            logits, _ = model.prefill_jit(params, {"tokens": prompt}, cache)
            tok = greedy_token(gather_logits(params, logits))
            model.decode_tokens(params, cache, tok, steps)
            cache["lengths"].fill_(prompt.shape[1])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.decode_tokens(params, cache, tok, steps)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / steps

    captures = model.graph_stats["captures"]
    turns = [("unsharded", turn(False)), ("placed", turn(True)), ("placed", turn(True)),
             ("unsharded", turn(False))]
    print(f"[13c] {arch} captured decode step of one {prompt.shape[1]}-token request "
          f"({steps}-step graph, {rows}-row cache), CUDA events around the replay, in "
          f"turns: " + ", ".join(f"{k} {v:.4f} ms" for k, v in turns) + f"; graphs captured "
          f"for the turns {model.graph_stats['captures'] - captures} ({card_str})")
    for m in params.modules():
        if "tp" in vars(m):
            del m.tp
    print(f"[{ph}] {arch} took {time.perf_counter() - t0:.1f} s")
    del model, params, static, got, want
    torch.cuda.empty_cache()
    return counts["launches"], prompt.shape[1]


def placed_phase(args, card_str):
    """Phase 13: zamba2-1.2b and xlstm-1.3b placed on a (1, 1) NCCL mesh,
    captured, against their unsharded captured paths; the kernels line's
    entries for zamba2's placed K2 and K3."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_config
    from repro_torch.serving.backend import ServeRequest, _bucket

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        launches, S = placed_recurrent(ZAMBA, args, card_str, mesh, ServeRequest)
        xlstm_launches, _ = placed_recurrent(XLSTM, args, card_str, mesh, ServeRequest)
    finally:
        dist.destroy_process_group()
    if any(xlstm_launches.values()):
        raise PhaseError(f"{XLSTM} launched kernels {xlstm_launches}; its path has none")
    cfg = get_config(ZAMBA)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tb = _bucket(args.new_tokens, base=8)
    kernels = report_rows(
        [("flash_attention", flash_row((1, H, K, S, hd), window=cfg.sliding_window)),
         ("decode_attention", decode_row((1, H, K, _bucket(S + tb, base=8), hd), S + tb // 2))],
        launches, card_str, "13d", suffix=f"[{ZAMBA}, placed]")
    torch.cuda.empty_cache()
    print(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s")
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

    # 3-4. the main path: the probe, then serving in both arms. CUDA events
    # recorded around the probe's launches, inside its run(), give the same
    # work's device time beside the host time that run() returns.
    probe = MatmulProbe(n=512, repeats=8)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    compute = probe._compute

    def timed_compute():
        start.record()
        out = compute()
        end.record()
        return out

    probe._compute = timed_compute
    ops.reset_counters()
    probe_ms = probe.run()
    probe._compute = compute
    print(f"[3] MatmulProbe(n=512, repeats=8).run(): {probe_ms:.4f} ms of host time (clock "
          f"around the launches and a device synchronize, as repro's run(); the same work "
          f"between CUDA events {start.elapsed_time(end):.4f} ms) beside "
          f"work_ms_at_unit_speed() {probe.work_ms_at_unit_speed():.4f} ms (simulated time "
          f"anchor, {probe.flops:.0f} FLOP) ({card_str})")
    engines, results = serve_arms(cfg, reqs, args.seed, card_str)
    launches, plain = dict(ops.launches), dict(ops.plain)
    print(json.dumps({"counters": {"launches": launches, "plain": plain}}))
    # the probe's repeats; per request and arm, one K2 launch a layer and one
    # K3 launch a layer a decode step (the bucket's steps)
    expected = kernel_counts(matmul=probe.repeats, flash_attention=2 * len(reqs) * cfg.n_layers,
                             decode_attention=2 * len(reqs) * cfg.n_layers * tb)
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

    # 8. the encoder-decoder family and the ASR→LLM pipeline
    kernels += encdec_phase(args, card_str)

    # 9. the vectorized Monte-Carlo path (no kernel of K1-K3)
    vec_phase(card_str)

    # 10. the recurrent families
    t0 = time.perf_counter()
    kernels += zamba_phase(args, card_str)
    xlstm_phase(args, card_str)
    print(f"[10] phase 10 took {time.perf_counter() - t0:.1f} s")

    # 11. training
    kernels += train_phase(args, card_str)

    # 12. multi-device and launch
    kernels += multidevice_phase(args, card_str, main_shapes)

    # 13. the recurrent families placed
    kernels += placed_phase(args, card_str)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
