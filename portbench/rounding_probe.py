"""Where the served program's distance from the float32 reference comes
from: its bfloat16 roundings, or a fault of its own.

    python3 portbench/rounding_probe.py --config granite-4.0-h-small --layers 12 \\
        --seeds 1,2 --prompts 4 --new 16

At the configuration's widths and its first ``--layers`` layers, on seeded
weights, each prompt (the length of the cell's document traffic, 2,048 to
3,840 tokens) is served greedily twice, eagerly through the program's own
kernels: by the program in bfloat16 (``program_bf16``) and by the program
in float32 on the same weights widened (``program_f32``). The reference's
float32 logits at each side's served positions are compared with that
side's own decode logits and, on the bfloat16 side's positions, with the
logits of the reference with more and more of the program's roundings:

* ``witness_bf16``: each weight product's operands in bfloat16 (the
  harness's ``bf16_`` control);
* ``+router_in``: and each norm's output rounded to bfloat16, as the
  program holds it, so the router (float32 on both sides) reads it rounded;
* ``+stream``: and the embedding and the residual stream held in bfloat16;
* ``+products``: and each weight product's output rounded to bfloat16;
* ``+elementwise``: and the outputs of the conv, of each SiLU and of the
  scan rounded to bfloat16, as the program's are.

One JSON line a variant, over every served token: ``rel_err``, the mean
over the tokens of the logit row's error over the row's norm; ``gap_mean``
and ``flip_share`` of the variant's best token, as the harness's check
reads them (in standard deviations of the reference's row); ``tokens``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("witness_bf16", "+router_in", "+stream", "+products", "+elementwise")


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def witness_logits(cfg: dict, W: dict, tokens: torch.Tensor, prefill_len: int,
                   stage: str) -> torch.Tensor:
    """``reference.granite_hybrid.logits`` in bfloat16 weight products, with
    the program's roundings up to ``stage`` (see the module's docstring)."""
    from portbench.reference import common, granite, granite_hybrid as gh
    from portbench.reference.common import Precision

    level = STAGES.index(stage)
    functional = gh.F

    class RoundedF:
        def __getattr__(self, name):
            return getattr(functional, name)

        @staticmethod
        def silu(t):
            return _bf(functional.silu(_bf(t)))

    class Rounded(Precision):
        def mm(self, a, w):
            return _bf(super().mm(a, w))

    prec = Rounded("bf16") if level >= 3 else Precision("bf16")
    keep = _bf if level >= 2 else (lambda t: t)
    norm, scan = gh.rms_norm, gh.ssd
    if level >= 1:
        gh.rms_norm = lambda x, w, eps: _bf(norm(x, w, eps))
    if level >= 4:
        gh.F = granite.F = common.F = RoundedF()
        gh.ssd = lambda *a: _bf(scan(*(_bf(t) if i in (0, 3, 4) else t for i, t in enumerate(a))))
    try:
        eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
        x = keep(W["embed"][tokens.long()].float() * cfg["embedding_multiplier"])
        for i, kind in enumerate(cfg["layer_types"][:cfg["n_layers"]]):
            pre = f"layers.{i}."
            if kind == "mamba":
                y = gh.mamba(prec, cfg, W, pre + "mamba.",
                             gh.rms_norm(x, W[pre + "mamba.ln"], eps))
            else:
                y = gh.attention(prec, cfg, W, pre + "attn.", gh.rms_norm(x, W[pre + "ln1"], eps))
            x = keep(x + keep(r * y))
            h = gh.rms_norm(x, W[pre + "ln2"], eps)
            sh = pre + "mlp.shared."
            y = gh.moe(prec, cfg, W, pre + "mlp.", h, prefill_len) + gh.swiglu(
                prec, h, W[sh + "w_gate"], W[sh + "w_up"], W[sh + "w_down"])
            x = keep(x + keep(r * y))
        x = gh.rms_norm(x, W["final_norm"], eps)
        return prec.mm(x, W["embed"].T) / cfg["logits_scaling"]
    finally:
        gh.rms_norm, gh.ssd = norm, scan
        gh.F = granite.F = common.F = functional


@torch.no_grad()
def serve(model, params, prompt: torch.Tensor, new: int):
    """Greedy tokens (T,) and their decode logits (T, V) f32: a prefill,
    then decode steps from the prompt's last token, as the server runs."""
    cache = model.init_cache(1, prompt.shape[1] + new + 1)
    _, cache = model.prefill(params, {"tokens": prompt}, cache)
    tok, tokens, rows = prompt[:, -1:], [], []
    for _ in range(new):
        lg, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        tokens.append(int(tok[0, 0]))
        rows.append(lg[0, 0].float())
    return torch.tensor(tokens, device=prompt.device), torch.stack(rows)


def _reading(ref: torch.Tensor, got: torch.Tensor) -> dict:
    from portbench.harness import gaps

    g = gaps(ref, got.argmax(dim=-1))
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    return {"rel_err": err, "gap": g}


def probe(cfg: dict, seeds: list, prompts: int, new: int, device, lengths=None) -> dict:
    """The readings of every variant, over the seeds' prompts: {variant:
    {"rel_err", "gap_mean", "flip_share", "tokens"}}."""
    from portbench import harness, weights
    from portbench.reference import granite_hybrid
    from portbench.reference.common import no_tf32, served_sequence
    from repro_torch.models.model import build_model

    no_tf32()
    lengths = lengths or list(range(2048, 3841, 256))
    parts: dict = {}
    for seed in seeds:
        model = build_model(harness.arch_config(cfg), device=device)
        params = model.init(0)
        weights.write(params, cfg["init"], seed)
        rng = np.random.default_rng(seed)
        asked = [torch.as_tensor(rng.integers(0, cfg["vocab"], int(rng.choice(lengths))),
                                 dtype=torch.int32, device=device)[None] for _ in range(prompts)]
        served16 = [serve(model, params, p, new) for p in asked]
        wide = build_model(harness.arch_config(dict(cfg, dtype="float32")), device=device)
        params32 = wide.init(0)
        with torch.no_grad():
            for p32, p in zip(params32.parameters(), params.parameters()):
                p32.copy_(p)
        del model, params
        harness.release()
        served32 = [serve(wide, params32, p, new) for p in asked]
        W = dict(params32.named_parameters())
        for p, (t16, lg16), (t32, lg32) in zip(asked, served16, served32):
            S = p.shape[1]
            for name, toks, lg in (("program_bf16", t16, lg16), ("program_f32", t32, lg32)):
                seq = served_sequence(p[0], toks)
                ref = granite_hybrid.logits(cfg, W, seq, S)[S:S + new]
                parts.setdefault(name, []).append(_reading(ref, lg))
                if name == "program_bf16":
                    for stage in STAGES:
                        got = witness_logits(cfg, W, seq, S, stage)[S:S + new]
                        parts.setdefault(stage, []).append(_reading(ref, got))
        del wide, params32, W
        harness.release()
    out = {}
    for name, rs in parts.items():
        err = torch.cat([r["rel_err"] for r in rs])
        g = torch.cat([r["gap"] for r in rs])
        out[name] = {"rel_err": float(err.mean()), "gap_mean": float(g.mean()),
                     "flip_share": float((g > 0).float().mean()), "tokens": int(g.numel())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="granite-4.0-h-small")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seeds", default="1,2", help="comma-separated")
    ap.add_argument("--prompts", type=int, default=4, help="prompts a seed")
    ap.add_argument("--new", type=int, default=16, help="tokens served a prompt")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{args.config}.json").read_text())
    cfg["n_layers"] = args.layers
    seeds = [int(s) for s in args.seeds.split(",")]
    out = probe(cfg, seeds, args.prompts, args.new, "cuda")
    for name, r in out.items():
        print(json.dumps({"config": args.config, "layers": args.layers, "seeds": seeds,
                          "variant": name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
