"""The readings that a cell's limit is set from, in one process:

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 20

builds the cell's program once, then for each seed writes the seed's
weights into it in place (the graphs stay valid), serves a window of the
seed's traffic exactly as a run does, and compares a sample of what it
served with the reference (``gap_mean`` and the rest of
``harness.check``'s numbers: the lower readings over the seeds) and, on the
same positions, the token that the float8 control puts first
(``control_...``: the upper readings) and the one that the reference in
bfloat16 puts first (``bf16_...``: a witness in the served precision). One
JSON line a seed. Not part of a run: the benchmark's own runs never compute
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seeds: list[int], seconds: float, device="cuda",
             control: bool = True):
    """Yield one dict of readings a seed."""
    import torch

    from portbench import harness, weights

    cell = harness.load_cell(root, workload)
    device = torch.device(device)
    engine = harness.build_engine(cell.config, seeds[0], device)
    for i, seed in enumerate(seeds):
        specs = weights.write(engine.params, cell.config["init"], seed)
        if i == 0:
            harness.warm_up(engine, cell, seed)
        done, window_s, _ = harness.timed_window(engine, cell, seed, seconds, False, device)
        numbers = harness.check(cell, done, seed, specs, device, control=control)
        yield {"seed": seed, "window_s": window_s, "attempted": len(done), **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    for r in readings(ROOT, args.workload, seeds, args.seconds, control=not args.no_control):
        print(json.dumps({"workload": args.workload, **r,
                          "elapsed_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
