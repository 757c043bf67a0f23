"""``control.py``'s readings for a configuration whose second copy of the
weights does not fit on the card beside the program (granite-4.0-h-small:
64.4 GB of 80):

    python3 portbench/control_shared.py --workload <name> --seeds 1,2,3 --seconds 12

The program's parameters hold exactly the seed's draws (``weights.write``
copied them in), so the reference reads them in place of a second draw; the
program's graphs and static caches are dropped before each check to make
room for the reference's activations (the next seed captures them again,
inside its window, which these readings do not time). One JSON line a seed,
as ``control.py`` prints, with the card's peak memory so far.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import control, harness, weights

    held = {}
    build, make = harness.build_engine, weights.make

    def build_engine(cfg, seed, device):
        held["engine"] = build(cfg, seed, device)
        return held["engine"]

    def shared_make(specs, rules, seed, device, put=None):
        if put is not None:  # weights.write drawing into the program
            return make(specs, rules, seed, device, put=put)
        engine = held["engine"]
        harness.free(engine)
        harness.release()
        params = dict(engine.params.named_parameters())
        if [n for n, _, _ in specs] != list(params):
            raise RuntimeError("the program's parameters are not the specs drawn")
        return params

    harness.build_engine, weights.make = build_engine, shared_make
    t0 = time.perf_counter()
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in control.readings(ROOT, args.workload, seeds, args.seconds):
        print(json.dumps({"workload": args.workload, **r, "elapsed_s": time.perf_counter() - t0,
                          "memory_peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
