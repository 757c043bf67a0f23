"""Model-serving backend for the shared execution substrate (DESIGN.md §9).

A *replica* is a substrate instance whose body work is REAL PyTorch
prefill/decode of the configured architecture instead of a sampled duration;
on the card, prefill attention runs on the flash-attention kernel and every
decode step on the decode-attention kernel. Everything else — the warm
replica pool, the elysium gate, the simulated clock, requeue semantics,
platform profiles, contention drift — comes from the substrate, identical to
``repro.serving.backend`` draw for draw, so the gate makes the same
decisions on the same seed.

Shapes are padded to buckets exactly as in ``repro`` (``decode_mode="jit"``):

* decode steps and cache length round up to power-of-two buckets — extra
  decode steps only append tokens past the requested prefix, so outputs are
  unchanged (the caller slices the first ``max_new_tokens``);
* the batch dimension rounds the replica's in-flight stream count (the
  ``load`` the engine passes to :meth:`body`) up to a bucket, so
  ``per_instance_concurrency > 1`` is real batched compute;
* prompt lengths are NOT padded: causal prefill without per-row length
  masking would change the last-token logits, and the flash-attention kernel
  masks ragged lengths itself.

An encoder-decoder arch (whisper-small) is fed zero audio frames, the stub
frontend's output, exactly as ``repro`` feeds it, and decodes from the
prompt's first token (:meth:`ModelServingBackend.prefill_inputs`). The
recurrent archs (zamba2-1.2b, xlstm-1.3b) are served as the transformers are.

The bucketed path runs ``Model.prefill_jit`` and ``Model.decode_tokens`` on
the model's static cache of the bucket, as ``repro`` runs its jitted pair: on
the card each is a CUDA graph captured at the first call of its shape and
replayed after it (``Model.graph_stats`` counts them). ``jit_stats`` keeps
``repro``'s keys and counts: ``jit_calls`` counts bucketed runs,
``bucket_compiles`` the distinct buckets seen, ``eager_calls`` runs of the
per-step baseline loop (``decode_mode="eager"``, one host read per token).

Work units: prefill = S tokens × c_prefill, decode = steps × c_decode ms at
unit speed; observed duration = work / replica speed — the engine then
applies the platform's load-slowdown curve on top
(``SubstrateKnobs.load_slowdown_alpha``; :meth:`calibrate_load_slowdown`
fits that curve from the real batched compute). ``requeue_penalty_ms``
accounts for the family asymmetry when an in-flight stream migrates to a new
replica: full-attention archs must re-prefill their KV cache (enc-dec archs
re-encode the audio window), SSM archs just replay O(d_state) state
(DESIGN.md §4).

With the tracer on (:mod:`repro_torch.trace`), :meth:`body` opens
``backend.body``, and :meth:`run_model` inside it ``backend.h2d`` (the prompt
to the device) and ``backend.readback`` (the host waiting for the tokens),
after which it records a device anchor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.core.lifecycle import FunctionInstance
from repro_torch.core.substrate import SubstrateKnobs, ar1_drift, sample_jitter
from repro_torch.models.model import Model, build_model, greedy_token
from repro_torch.sim.variation import VariationModel


@dataclasses.dataclass
class ServeRequest:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    request_id: int = 0


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: np.ndarray
    sim_duration_ms: float
    replica_speed: float
    retries: int
    latency_ms: float = 0.0     # end-to-end simulated latency (queue + cold + body)


def _bucket(n: int, base: int = 1) -> int:
    """Round ``n`` up to the next power-of-two bucket, floored at ``base``."""
    if n < 1:
        raise ValueError("bucket size must be >= 1")
    b = base
    while b < n:
        b <<= 1
    return b


class ModelServingBackend:
    """Substrate backend whose body is real model compute.

    Replica speed heterogeneity (co-tenant hosts, thermal variation,
    degraded links) comes from a :class:`VariationModel` — the same
    distribution family the simulator uses, so serving runs can exercise
    diurnal cycles and day drift too. ``contention_rho`` < 1 adds the
    per-serve AR(1) drift of a replica's certified speed (1.0 = frozen,
    the idealized model).

    ``per_instance_concurrency`` / ``load_slowdown_alpha`` /
    ``gate_load_aware`` feed :meth:`default_knobs`, making replica load a
    hosting property of this backend (DESIGN.md §9 load model).

    ``device=None`` means the card; pass ``device="cpu"`` for the CPU.
    Fresh weights come from ``model.init(seed)``; ``params`` passes others.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        seed: int = 0,
        variation: Optional[VariationModel] = None,
        speed_sigma: float = 0.15,
        probe_work_ms: float = 200.0,
        probe_noise: float = 0.0,
        weight_load_ms: float = 400.0,   # the 'prepare' phase that hides the probe
        c_prefill_ms_per_tok: float = 0.5,
        c_decode_ms_per_tok: float = 5.0,
        contention_rho: float = 1.0,
        max_pool: Optional[int] = 8,
        name: Optional[str] = None,
        model: Optional[Model] = None,
        params: Any = None,
        per_instance_concurrency: int = 1,
        load_slowdown_alpha: float = 0.0,
        gate_load_aware: bool = False,
        decode_mode: str = "jit",        # "jit" (bucketed) | "eager" (baseline)
        decode_bucket: int = 8,          # decode-step bucket floor
        max_decode_batch: int = 8,       # cap on the batched-stream bucket
        device=None,
    ) -> None:
        if decode_mode not in ("jit", "eager"):
            raise ValueError(f"decode_mode must be 'jit' or 'eager', got {decode_mode!r}")
        self.cfg = cfg
        self.model = model if model is not None else build_model(cfg, device=device)
        self.device = self.model.device
        self.params = params if params is not None else self.model.init(seed)
        self.variation = variation if variation is not None else VariationModel(sigma=speed_sigma)
        self.probe_work_ms = probe_work_ms
        self.probe_noise = probe_noise
        self.weight_load_ms = weight_load_ms
        self.c_prefill = c_prefill_ms_per_tok
        self.c_decode = c_decode_ms_per_tok
        self.contention_rho = contention_rho
        self.max_pool = max_pool
        self.name = name if name is not None else f"serve-{cfg.arch_id}"
        self.per_instance_concurrency = per_instance_concurrency
        self.load_slowdown_alpha = load_slowdown_alpha
        self.gate_load_aware = gate_load_aware
        self.decode_mode = decode_mode
        self.decode_bucket = decode_bucket
        self.max_decode_batch = max_decode_batch
        self._compiled_buckets: set[tuple] = set()
        self.jit_stats = {"jit_calls": 0, "eager_calls": 0, "bucket_compiles": 0}

    # -- substrate hooks -----------------------------------------------
    def sample_speed(self, rng: np.random.RandomState, t_ms: float) -> float:
        return self.variation.sample_speed(rng, t_ms=t_ms)

    def reuse_drift(self, inst: FunctionInstance, rng: np.random.RandomState, t_ms: float) -> None:
        ar1_drift(
            inst, rng,
            day_mean=self.variation.day_factor * self.variation.diurnal(t_ms),
            sigma=self.variation.sigma,
            rho=self.contention_rho,
        )

    def prepare_ms(self, rng: np.random.RandomState) -> float:
        return self.weight_load_ms

    def probe(self, inst: FunctionInstance, rng: np.random.RandomState) -> float:
        obs = inst.run_benchmark(self.probe_work_ms) * sample_jitter(rng, self.probe_noise)
        inst.benchmark_result = obs
        return obs

    def reprobe(self, inst: FunctionInstance, rng: np.random.RandomState) -> float:
        """Warm re-benchmark of a pooled replica (control plane,
        ReuseDecision.REPROBE): the same matmul probe, measured at the
        replica's current (contention-drifted) speed, no lifecycle
        transition. Cheap by construction — probe work, not model work —
        and it hides under the prepare phase like the cold probe does."""
        return (self.probe_work_ms / inst.speed_factor) * sample_jitter(
            rng, self.probe_noise)

    def body(
        self,
        payload: Any,
        inst: FunctionInstance,
        rng: np.random.RandomState,
        *,
        load: int = 1,
    ) -> tuple[float, Any]:
        req: ServeRequest = payload
        with trace.span("backend.body"):
            tokens = self.run_model(req, load=load)
        work = self.c_prefill * len(req.prompt) + self.c_decode * req.max_new_tokens
        return work / inst.speed_factor, tokens

    def requeue_penalty_ms(self, payload: Any) -> float:
        """Cost of moving an in-flight stream to another replica."""
        if self.cfg.family in ("xlstm", "hybrid", "hybrid_moe"):
            return 5.0  # O(d_state) state transfer
        if self.cfg.family == "encdec":
            # the new replica re-encodes the audio window (cross-attention
            # KV is a function of the encoder output, not the prompt)
            return self.c_prefill * self.cfg.encoder_frames
        return self.c_prefill * len(payload.prompt)  # re-prefill the KV cache

    # -- model compute --------------------------------------------------
    def run_model(
        self, req: ServeRequest, *, load: int = 1, mode: Optional[str] = None,
    ) -> np.ndarray:
        """Greedy-decode ``req`` and return its tokens ((T,) int32).

        ``load`` >= 2 batches the decode across the replica's concurrent
        streams (batch bucket; row 0 is this request — rows are computed
        independently, so the tokens do not depend on the padding).
        ``mode`` overrides ``self.decode_mode`` for measurement.
        """
        mode = mode if mode is not None else self.decode_mode
        model = self.model
        T = req.max_new_tokens
        with trace.span("backend.h2d"):
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)[None]
        S = int(prompt.shape[1])

        if mode == "eager":
            self.jit_stats["eager_calls"] += 1
            batch, tok = self.prefill_inputs(prompt)
            _, cache = model.prefill(self.params, batch, model.init_cache(1, S + T))
            out = []
            for _ in range(T):
                logits, cache = model.decode_step(self.params, cache, tok)
                tok = greedy_token(logits)
                out.append(int(tok[0, 0]))
            return np.asarray(out, np.int32)

        B = min(_bucket(max(1, load)), self.max_decode_batch)
        Tb = _bucket(T, base=self.decode_bucket)
        # cache length is bucketed too, so one captured decode loop and one
        # static cache serve every prompt length in the bucket (decode
        # attention masks by `lengths`, so the padded tail and an earlier
        # request's rows are never read; prefill starts every recurrent state
        # afresh, and xlstm's state has one cache a batch size whatever the
        # bucket)
        cache_len = _bucket(S + Tb, base=self.decode_bucket)
        key = (self.cfg.family, B, S, Tb, cache_len)
        if key not in self._compiled_buckets:
            self._compiled_buckets.add(key)
            self.jit_stats["bucket_compiles"] += 1
        if B > 1:
            prompt = prompt.expand(B, S).contiguous()
        batch, tok = self.prefill_inputs(prompt)
        _, cache = model.prefill_jit(self.params, batch, model.static_cache(B, cache_len))
        toks, _ = model.decode_tokens(self.params, cache, tok, Tb)
        self.jit_stats["jit_calls"] += 1
        with trace.span("backend.readback"):
            out = toks[0, :T].cpu().numpy().astype(np.int32)
        trace.anchor(self.device)
        return out

    def prefill_inputs(self, prompt: torch.Tensor) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """(prefill batch, first decode token) for ``prompt`` (B, S) on the
        device: the prompt and its last token; for an encoder-decoder, zero
        audio frames (B, encoder_frames, d_model) f32, the stub frontend's
        output, and the prompt's first token, as ``repro`` feeds them."""
        cfg = self.cfg
        if cfg.family == "encdec":
            frames = torch.zeros((prompt.shape[0], cfg.encoder_frames, cfg.d_model),
                                 dtype=torch.float32, device=self.device)
            return {"frames": frames}, prompt[:, :1]
        return {"tokens": prompt}, prompt[:, -1:]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_model_ms(
        self, req: ServeRequest, *, mode: str, load: int = 1, repeats: int = 1,
    ) -> float:
        """Mean wall-clock ms per ``run_model`` call (one un-timed warmup
        first, which also builds the kernels on first use — steady-state
        serving cost). The device is synchronized before each clock read."""
        self.run_model(req, load=load, mode=mode)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            self.run_model(req, load=load, mode=mode)
        self._sync()
        return (time.perf_counter() - t0) * 1e3 / max(1, repeats)

    def calibrate_load_slowdown(
        self,
        loads: tuple[int, ...] = (1, 2, 4),
        *,
        max_new_tokens: int = 8,
        repeats: int = 3,
    ) -> float:
        """Fit the load-slowdown exponent from the REAL batched compute:
        time the bucketed decode at several stream counts and least-squares
        ``log time = alpha * log load + c``. The result calibrates
        ``SubstrateKnobs.load_slowdown_alpha`` (alpha 0: batching is free,
        1: perfect serialization; hardware lands in between)."""
        req = ServeRequest(prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=max_new_tokens)
        ts = [self.time_model_ms(req, mode="jit", load=b, repeats=repeats)
              for b in loads]
        logs_b = np.log(np.asarray(loads, np.float64))
        logs_t = np.log(np.asarray(ts, np.float64))
        alpha = float(np.polyfit(logs_b, logs_t, 1)[0])
        return max(0.0, alpha)

    # -- hosting defaults ----------------------------------------------
    def default_knobs(self, max_pool: Optional[int] = None) -> SubstrateKnobs:
        """Serving replica hosting: spin-up latency IS the weight load
        (prepare), replicas never idle out or get recycled by default, and
        occupancy is billed from spin-up (chip-seconds). Load behavior
        (stream concurrency, slowdown curve, load-aware gating) comes from
        this backend's own knobs."""
        return SubstrateKnobs(
            cold_start_ms=0.0,
            cold_start_jitter=0.0,
            idle_timeout_ms=float("inf"),
            recycle_lifetime_ms=None,
            bill_cold_start=True,
            requeue_overhead_ms=0.0,
            warm_pool_order="lifo",
            per_instance_concurrency=self.per_instance_concurrency,
            max_pool=max_pool if max_pool is not None else self.max_pool,
            load_slowdown_alpha=self.load_slowdown_alpha,
            gate_load_aware=self.gate_load_aware,
        )

    def pretest_threshold(self, pass_fraction: float = 0.4) -> float:
        """Analytic §III-A threshold: the probe duration the fastest
        ``pass_fraction`` of replicas beat under this backend's variation
        model (durations: P(probe ≤ thr) = pass_fraction ⇒ thr =
        probe_work / speed-quantile(1 − pass_fraction))."""
        return self.probe_work_ms / self.variation.speed_quantile(1.0 - pass_fraction)
