"""Model-serving engine with Minos replica selection — a thin wrapper over
the shared execution substrate (DESIGN.md §9).

The FaaS→serving adaptation (DESIGN.md §2): a *replica* is one
card's worth of serving capacity hosting the model; the platform's worker
heterogeneity becomes per-replica speed factors. The Minos layer is the
paper's algorithm verbatim: on replica spin-up a matmul probe runs during
the *prepare* phase (weight load), the replica judges itself against the
elysium threshold, and either joins the pool or re-queues its request and
despawns.

All execution machinery (replica pool, gate, clock, queue, billing) is the
:class:`~repro_torch.core.substrate.SubstrateEngine`; this module only adapts the
request/result types and exposes the historical serving API. Because both
this engine and the simulator are backends of the same substrate, the
serving path supports platform-profile hosting knobs (any object with the
``knobs(max_pool=)`` of ``repro.sim.platform.PlatformProfile``), contention
drift, LIFO/FIFO pools, and idle/recycle reclaim — and an
:class:`~repro_torch.core.policy.AdaptiveMinosPolicy` gets its probe stream wired
automatically.

The model compute is REAL (PyTorch prefill/decode of the configured arch,
attention on the hand-written kernels on the card); time is simulated as
work/speed so the selection dynamics are measurable without a fleet. The
gate therefore makes exactly ``repro``'s decisions on the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost import Pricing
from repro_torch.core.lifecycle import FunctionInstance
from repro_torch.core.substrate import RequestResult, SubstrateEngine
from repro_torch.serving.backend import ModelServingBackend, ServeRequest, ServeResult

__all__ = ["MinosServingEngine", "Replica", "ServeRequest", "ServeResult"]


@dataclasses.dataclass
class Replica:
    """View of one pooled serving instance (weights are shared on one host;
    they would be per-host copies on a fleet)."""

    instance: FunctionInstance
    params: Any
    model: Any

    @property
    def speed(self) -> float:
        return self.instance.speed_factor


class MinosServingEngine(SubstrateEngine):
    """Single-host engine over a :class:`ModelServingBackend`.

    ``serve`` keeps the historical synchronous semantics: requests are
    processed in order, each driven to completion on the shared simulated
    clock (so replica reuse compounds across the batch exactly as before).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        policy,
        pricing: Pricing,
        *,
        seed: int = 0,
        speed_sigma: float = 0.15,
        probe_work_ms: float = 200.0,
        weight_load_ms: float = 400.0,
        c_prefill_ms_per_tok: float = 0.5,
        c_decode_ms_per_tok: float = 5.0,
        max_pool: int = 8,
        contention_rho: float = 1.0,
        variation=None,
        profile: Any = None,
        online_controller=None,
        per_instance_concurrency: int = 1,
        load_slowdown_alpha: float = 0.0,
        gate_load_aware: bool = False,
        decode_mode: str = "jit",
        controller=None,
        device=None,
    ) -> None:
        backend = ModelServingBackend(
            cfg,
            seed=seed,
            variation=variation,
            speed_sigma=speed_sigma,
            probe_work_ms=probe_work_ms,
            weight_load_ms=weight_load_ms,
            c_prefill_ms_per_tok=c_prefill_ms_per_tok,
            c_decode_ms_per_tok=c_decode_ms_per_tok,
            contention_rho=contention_rho,
            max_pool=max_pool,
            per_instance_concurrency=per_instance_concurrency,
            load_slowdown_alpha=load_slowdown_alpha,
            gate_load_aware=gate_load_aware,
            decode_mode=decode_mode,
            device=device,
        )
        knobs = (
            profile.knobs(max_pool=max_pool)
            if profile is not None
            else backend.default_knobs(max_pool=max_pool)
        )
        super().__init__(
            backend, policy, pricing,
            knobs=knobs, seed=seed, online_controller=online_controller,
            controller=controller,
        )
        self.cfg = cfg
        self.model = backend.model
        self.params = backend.params
        self.max_pool = max_pool

    # ---- serving ------------------------------------------------------
    def serve(self, requests: list[ServeRequest]) -> list[ServeResult]:
        results: list[ServeResult] = []
        for req in requests:
            done: list[RequestResult] = []
            self.submit(req, done.append)
            self.loop.run_all()
            assert done, "request did not complete"
            res = done[0]
            results.append(ServeResult(
                request_id=req.request_id,
                tokens=res.output,
                sim_duration_ms=res.analysis_ms,
                replica_speed=res.instance_speed,
                retries=res.retries,
                latency_ms=res.latency_ms,
            ))
        return results

    def requeue_penalty_ms(self, req: ServeRequest) -> float:
        return self.backend.requeue_penalty_ms(req)

    # ---- historical views --------------------------------------------
    @property
    def now_ms(self) -> float:
        return self.loop.now

    @property
    def replicas(self) -> list[Replica]:
        return [Replica(instance=i, params=self.params, model=self.model)
                for i in self.pool.available]

    @property
    def replicas_started(self) -> int:
        return self.instances_started

    @property
    def replicas_terminated(self) -> int:
        return self.instances_terminated

    @property
    def probe_observations(self) -> list[float]:
        return self.gate.observations

    @property
    def jit_stats(self) -> dict:
        """Call counters of the backend's bucketed decode path."""
        return self.backend.jit_stats

    @property
    def pool_mean_speed(self) -> float:
        speeds = self.pool.speeds_view()  # cached: no per-read rebuild
        if not speeds:
            return float("nan")
        return float(np.mean(speeds))
