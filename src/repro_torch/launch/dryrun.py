"""Multi-pod dry-run of the port: trace rank 0's local program of every
(architecture x input-shape) combination on the production meshes, and
print its memory and its roofline terms on one H100.

It starts a ``"fake"`` process group of 256 (or 512) ranks, which moves no
data, binds the reference's 16x16 (or 2x16x16) mesh, places the model's
parameters, optimizer state, batch and cache as rank 0's blocks of ``meta``
tensors (allocation-free), and runs the step once under the counters of
:mod:`repro_torch.roofline.count`. So it needs no device and no JAX, and
``--device`` does not apply. Argument bytes are exact (the blocks' sizes);
temp bytes are the peak of the step's op results alive at once. Every
family runs its tensor-parallel local program on its placed blocks, and no
block split over the model axis is gathered. ``train_4k`` runs the port's
one sharded train step (``train.loop.make_train_step``): the gradients
averaged over the batch axes, the loss averaged and the norm global, each
collective counted. The sLSTM's per-token loop is counted as one token's
step times the number of tokens (``count(..., scan_once=True)``), as
``repro``'s counter counts a while loop's body times its trip count.

``repro``'s hillclimb knobs, all off by default (the paper-faithful
baseline), each as the local program its SPMD program implies:

- ``--dp-only``: batch over every mesh axis it divides
  (``shardings.dp_only_rules``), parameters and optimizer state replicated
  (``place_params(replicate=True)``): no tensor-parallel collective; the
  gradients averaged over the batch axes.
- ``--fsdp``: parameters and optimizer state split over the data axes too
  (``add_fsdp_axes``); the step all-gathers each such block over them where
  a layer reads it (again in the remat recompute) and the all-gather's
  backward reduce-scatters its gradient; the update runs on the blocks.
  With ``--dp-only`` the parameters stay whole and only the optimizer state
  is split (ZeRO-1, as ``repro`` places it): each rank updates its blocks
  from the averaged gradients and all-gathers the new parameters.
- ``--accum-steps N``: the batch cut into N micro-batches, the gradients
  summed in f32 and divided by N, the loss their mean; the batch-axis
  all-reduce runs once a step, after the sum.
- ``--seq-parallel``: ``rules["seq"] = "model"``: the transformer's and the
  encoder-decoder's residual stream is the rank's block of the sequence,
  each activation all-reduce after ``wo``/``w_down`` (and the embedding's)
  a reduce-scatter over it, each split region's entry an all-gather
  (Korthikanti et al.). The recurrent families (hybrid, xlstm) keep their
  whole sequence; zamba2's shared block reads it whole as well.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --fsdp
  python -m repro_torch.launch.dryrun --all                 # 10 x 4, single pod
  python -m repro_torch.launch.dryrun --all --multi-pod     # the 2-pod mesh

Results go to ``build/dryrun/`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..configs.registry import ARCH_IDS, get_config
from ..distributed import sharding as sh
from ..models import attention as _attn
from ..models.model import _FAMILIES, build_model
from ..optim.adamw import AdamW
from ..roofline.count import Roofline, count
from ..train.loop import make_train_step
from . import shardings as _sh
from .mesh import make_production_mesh
from .specs import INPUT_SHAPES, applicable, config_for_shape, input_specs

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")


def _fake_world(n: int) -> None:
    """A ``"fake"`` process group of ``n`` ranks, this process rank 0."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _blocks(tensors: dict, specs: dict, mesh) -> dict:
    """Meta tensors of rank 0's block of each entry."""
    return {k: torch.empty(_sh.local_shape(tuple(t.shape), specs[k], mesh), dtype=t.dtype,
                           device=META) for k, t in tensors.items()}


def _batch_dim(name: str, cache: dict) -> int:
    """The batch dim of a cache entry: 0 for ``lengths`` and an sLSTM's
    state (B, H, P), 1 for the rest (layer- or block-stacked)."""
    if name == "lengths":
        return 0
    if name.startswith("g") and "." in name:
        return 1 if f"{name.split('.')[0]}.C" in cache else 0
    return 1


def build_lowerable(cfg: ArchConfig, shape_name: str, mesh, *, dp_only: bool = False,
                    fsdp: bool = False, accum_steps: int = 1):
    """(step function of no arguments, argument bytes of rank 0): the
    parameters, optimizer state, batch and cache as rank 0's blocks."""
    model = build_model(cfg, device=META)
    params = _FAMILIES[cfg.family][1](cfg, META)
    spec = input_specs(cfg, shape_name)
    specs = _sh.place_params(params, cfg, mesh, replicate=dp_only, fsdp=fsdp)
    batch_axes = sh.logical_to_spec("batch")[0]
    batch = _blocks(spec["batch"], {k: _sh.batch_spec(k, tuple(t.shape), mesh, batch_axes)
                                    for k, t in spec["batch"].items()}, mesh)
    cache, cache_specs = None, {}
    if spec["cache"] is not None:
        cache_specs = _sh.cache_specs(spec["cache"], cfg, mesh)
        if dp_only:  # no tensor parallelism: this rank's rows of a whole cache
            cache_specs = {k: _sh._guard(tuple(batch_axes if d == _batch_dim(k, spec["cache"])
                                               else None for d in range(t.dim())),
                                         tuple(t.shape), mesh)
                           for k, t in spec["cache"].items()}
        cache = _blocks(spec["cache"], cache_specs, mesh)
    arg_bytes = _nbytes(params.parameters()) + _nbytes(batch.values())
    arg_bytes += _nbytes(cache.values()) if cache is not None else 0

    if spec["kind"] == "train":
        params.requires_grad_(True)
        opt = AdamW(learning_rate=3e-4)
        # ZeRO-1: whole parameters, the optimizer state split as FSDP splits it
        state_specs = _sh.param_specs(params, cfg, mesh, fsdp=True) if dp_only and fsdp else None
        state = opt.init(params, state_specs)
        arg_bytes += _nbytes([*state.mu.values(), *state.nu.values(), *state.master.values()])
        step = make_train_step(model, opt, remat=True, specs=specs, state_specs=state_specs,
                               accum_steps=accum_steps)

        def train_step():
            return step(params, state, batch)[2]["loss"]

        return train_step, arg_bytes

    def whole_params():
        """The parameters as this rank's program reads them: gathered over
        the data axes where FSDP split them."""
        if fsdp:
            _sh.gather_params(params, specs)

    if spec["kind"] == "prefill":
        def prefill_step():
            whole_params()
            return model.prefill(params, batch, cache)[0]

        return prefill_step, arg_bytes

    def decode_step():
        whole_params()
        return model.decode_step(params, cache, batch["tokens"])[0]

    return decode_step, arg_bytes


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save: bool = True, verbose: bool = True,
            dp_only: bool = False, fsdp: bool = False, accum_steps: int = 1,
            cache_update: str = "onehot", decode_attn: str = "local",
            seq_parallel: bool = False, tag: str = "") -> dict:
    knobs = (_attn.CACHE_UPDATE_MODE, _attn.DECODE_ATTN_MODE, _sh.FORCE_SEQ_SHARD_CACHE)
    _attn.CACHE_UPDATE_MODE = cache_update
    _attn.DECODE_ATTN_MODE = decode_attn
    _sh.FORCE_SEQ_SHARD_CACHE = decode_attn == "shard_map"
    opts = {"dp_only": dp_only, "fsdp": fsdp, "accum_steps": accum_steps,
            "cache_update": cache_update, "decode_attn": decode_attn,
            "seq_parallel": seq_parallel}
    try:
        return _run_one(arch, shape_name, multi_pod=multi_pod, save=save, verbose=verbose,
                        opts=opts, tag=tag)
    finally:
        _attn.CACHE_UPDATE_MODE, _attn.DECODE_ATTN_MODE, _sh.FORCE_SEQ_SHARD_CACHE = knobs


def _run_one(arch, shape_name, *, multi_pod, save, verbose, opts, tag) -> dict:
    cfg = config_for_shape(get_config(arch), shape_name)
    ok, reason = applicable(cfg, shape_name)
    label = f"{arch} x {shape_name} x {'2pod' if multi_pod else '1pod'}"
    if tag:
        label += f" [{tag}]"
    if not ok:
        if verbose:
            print(f"SKIP {label}: {reason}")
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    chips = 512 if multi_pod else 256
    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = _sh.make_rules(cfg, mesh)
    # batch too small to shard over the data axes -> replicate activations
    if INPUT_SHAPES[shape_name].global_batch % _sh._mesh_size(mesh, _sh.data_axes_of(mesh)):
        rules["batch"] = None
    if opts["seq_parallel"]:
        rules["seq"] = _sh.MODEL_AXIS
    if opts["dp_only"]:
        rules = _sh.dp_only_rules(mesh, INPUT_SHAPES[shape_name].global_batch)
    t0 = time.perf_counter()
    try:
        with sh.use_mesh(mesh, rules):
            fn, arg_bytes = build_lowerable(cfg, shape_name, mesh, dp_only=opts["dp_only"],
                                            fsdp=opts["fsdp"], accum_steps=opts["accum_steps"])
            out, stats = count(fn, scan_once=True)
            out_bytes = out.numel() * out.element_size() if out is not None else 0
    except Exception as e:
        if verbose:
            print(f"FAIL {label}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "failed", "error": f"{type(e).__name__}: {e}"}
    t_trace = time.perf_counter() - t0

    shp = INPUT_SHAPES[shape_name]
    tokens = shp.global_batch * (shp.seq_len if shp.kind in ("train", "prefill") else 1)
    mult = 3.0 if shp.kind == "train" else 1.0  # fwd+bwd = 3x fwd FLOPs
    model_flops = 2.0 * cfg.active_param_count() * tokens * mult
    roof = Roofline(flops=stats.flops, hbm_bytes=stats.hbm_bytes,
                    collective_bytes=stats.collective_bytes, chips=chips,
                    model_flops=model_flops, stats=stats)
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "tag": tag,
        "opts": opts,
        "chips": chips, "trace_s": round(t_trace, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": stats.temp_bytes,
                   "peak_bytes": arg_bytes + stats.temp_bytes},
        "roofline": roof.to_dict(),
    }
    if verbose:
        m, r = result["memory"], result["roofline"]
        print(
            f"OK   {label}: trace {t_trace:.0f}s | "
            f"args {m['argument_bytes'] / 2**30:.2f} GiB/dev, "
            f"temp {m['temp_bytes'] / 2**30:.2f} GiB/dev | "
            f"T(comp/mem/coll) = {r['t_compute_s']:.3e}/{r['t_memory_s']:.3e}/"
            f"{r['t_collective_s']:.3e} s -> {r['bottleneck']} | "
            f"useful-FLOPs {r['useful_flops_ratio'] * 100:.0f}%",
            flush=True,
        )
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = f"{arch}_{shape_name}_{'2pod' if multi_pod else '1pod'}{suffix}.json"
        (RESULTS_DIR / fname).write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    # repro's hillclimb knobs (defaults: the paper-faithful baseline)
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--cache-update", choices=("onehot", "scatter"), default="onehot")
    ap.add_argument("--decode-attn", choices=("local", "shard_map"), default="local")
    ap.add_argument("--seq-parallel", action="store_true")
    # repro's knob; the local program already runs the sLSTM on the rank's
    # batch block (its shard_map branch), so here it changes nothing
    ap.add_argument("--slstm-shard-map", action="store_true",
                    help="accepted for repro's flag set; a no-op in the local program")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        combos = [(a, s, mp) for mp in meshes for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    failures = 0
    for a, s, mp in combos:
        res = run_one(a, s, multi_pod=mp, dp_only=args.dp_only, fsdp=args.fsdp,
                      accum_steps=args.accum_steps, cache_update=args.cache_update,
                      decode_attn=args.decode_attn, seq_parallel=args.seq_parallel,
                      tag=args.tag)
        failures += res["status"] == "failed"
    print(f"\n{len(combos)} combos, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
