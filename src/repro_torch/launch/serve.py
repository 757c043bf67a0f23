"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
— batched requests through the Minos-gated serving engine, the port of
``repro.launch.serve`` with its flags and defaults, plus ``--device``
(default: the card; ``--device cpu`` for the CPU). The gate is simulated, so
the summary line is the reference's under the same arguments.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs.registry import ARCH_IDS, get_smoke_config
from ..core.cost import Pricing
from ..core.elysium import pretest_threshold
from ..core.policy import MinosPolicy
from ..serving.engine import MinosServingEngine, ServeRequest


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--pass-fraction", type=float, default=0.4)
    ap.add_argument("--no-minos", action="store_true")
    ap.add_argument("--speed-sigma", type=float, default=0.15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    rs = np.random.RandomState(0)
    probe_work = 200.0
    thr = pretest_threshold(
        probe_work / np.exp(rs.normal(0, args.speed_sigma, 128)),
        pass_fraction=args.pass_fraction,
    )
    policy = (
        MinosPolicy(elysium_threshold=0.0, enabled=False)
        if args.no_minos
        else MinosPolicy(elysium_threshold=thr, max_retries=5)
    )
    eng = MinosServingEngine(cfg, policy, Pricing.tpu_chip_seconds(4), seed=1,
                             speed_sigma=args.speed_sigma,
                             probe_work_ms=probe_work, device=args.device)
    reqs = [
        ServeRequest(prompt=rs.randint(0, cfg.vocab, 16).astype(np.int32),
                     max_new_tokens=args.max_new_tokens, request_id=i)
        for i in range(args.requests)
    ]
    res = eng.serve(reqs)
    lat = [r.sim_duration_ms for r in res]
    print(f"served {len(res)} requests | replicas started {eng.replicas_started}, "
          f"terminated {eng.replicas_terminated} | pool speed "
          f"{eng.pool_mean_speed:.3f} | mean latency {np.mean(lat):.0f}ms | "
          f"cost ${eng.cost.total:.4f}")


if __name__ == "__main__":
    main()
