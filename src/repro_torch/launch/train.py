"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, with its flags and defaults: it trains
the reduced (smoke) variant of the chosen architecture on the synthetic token
stream, or with ``--full`` the full config. It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: the reduced smoke variant)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("use examples/ for encoder-decoder training demos")
    data = iter(TokenStream(vocab=cfg.vocab, batch=args.batch,
                            seq_len=args.seq_len, seed=0))
    tc = TrainConfig(peak_lr=args.peak_lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  nll {m['nll']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}  ({m['wall_s']:.0f}s)", flush=True)

    train(cfg, data, tc, steps=args.steps, log_every=10, log_fn=log, device=args.device)


if __name__ == "__main__":
    main()
