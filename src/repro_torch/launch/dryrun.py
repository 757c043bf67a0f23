"""Multi-pod dry-run of the port: trace rank 0's local program of every
(architecture x input-shape) combination on the production meshes, and
print its memory and its roofline terms on one H100.

It starts a ``"fake"`` process group of 256 (or 512) ranks, which moves no
data, binds the reference's 16x16 (or 2x16x16) mesh, places the model's
parameters, optimizer state, batch and cache as rank 0's blocks of ``meta``
tensors (allocation-free), and runs the step once under the counters of
:mod:`repro_torch.roofline.count`. So it needs no device and no JAX, and
``--device`` does not apply. Argument bytes are exact (the blocks' sizes);
temp bytes are the peak of the step's op results alive at once. The
transformer and encoder-decoder families run their tensor-parallel local
program; the recurrent families (hybrid, xlstm) have none yet, and their
step all-gathers each model-split block first (and reduce-scatters the
gradients), counted. ``train_4k`` all-reduces the gradients over the data
axes, as SPMD would, and those all-reduces are counted.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
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


def build_lowerable(cfg: ArchConfig, shape_name: str, mesh):
    """(step function of no arguments, argument bytes of rank 0): the
    parameters, optimizer state, batch and cache as rank 0's blocks."""
    model = build_model(cfg, device=META)
    params = _FAMILIES[cfg.family][1](cfg, META)
    specs = _sh.place_params(params, cfg, mesh)
    local = _sh.has_local_program(params)
    spec = input_specs(cfg, shape_name)
    data_axes = _sh.data_axes_of(mesh)
    batch = _blocks(spec["batch"], {k: _sh.batch_spec(k, tuple(t.shape), mesh, data_axes)
                                    for k, t in spec["batch"].items()}, mesh)
    cache, cache_specs = None, {}
    if spec["cache"] is not None:
        cache_specs = _sh.cache_specs(spec["cache"], cfg, mesh)
        cache = _blocks(spec["cache"], cache_specs, mesh)
    arg_bytes = _nbytes(params.parameters()) + _nbytes(batch.values())
    arg_bytes += _nbytes(cache.values()) if cache is not None else 0

    if spec["kind"] == "train":
        params.requires_grad_(True)
        opt = AdamW(learning_rate=3e-4)
        state = opt.init(params)
        arg_bytes += _nbytes([*state.mu.values(), *state.nu.values(), *state.master.values()])
        partial = _sh.partial_grad_names(params)

        def train_step():
            gathered = {} if local else _sh.gather_params(params, specs)
            if gathered:
                params.requires_grad_(True)
            params.zero_grad(set_to_none=True)
            loss, _ = model.loss(params, batch, remat=True)
            loss.backward()
            grads = {}
            for n, p in params.named_parameters():
                g = p.grad
                if n in partial:
                    g = sh.all_reduce(g, _sh.MODEL_AXIS)
                for dim, entry in enumerate(gathered.get(n, ())):
                    if entry == _sh.MODEL_AXIS:
                        g = sh.reduce_scatter(g, dim)
                grads[n] = sh.all_reduce(g, data_axes)
            if gathered:  # the update runs on the blocks
                _sh.place_params(params, cfg, mesh)
            opt.update(grads, state, params)
            return loss

        return train_step, arg_bytes

    def with_cache():
        if local:
            return cache
        # a whole model-split state, and this rank's batch rows of a state
        # whose spec leaves its batch dim whole (the reference's rule for a
        # rank-3 xlstm state assumes (B, H, P); an mLSTM's m is (count, B, H))
        full = _sh.gather_tensors(cache, cache_specs)
        split = sh.logical_to_spec("batch")[0]
        for name, t in full.items():
            dim = _batch_dim(name, full)
            if split is not None and cache_specs[name][dim] is None:
                full[name] = sh.local_block(t, dim, split)
        return full

    if spec["kind"] == "prefill":
        def prefill_step():
            if not local:
                _sh.gather_params(params, specs)
            return model.prefill(params, batch, with_cache())[0]

        return prefill_step, arg_bytes

    def decode_step():
        if not local:
            _sh.gather_params(params, specs)
        return model.decode_step(params, with_cache(), batch["tokens"])[0]

    return decode_step, arg_bytes


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save: bool = True, verbose: bool = True,
            cache_update: str = "onehot", decode_attn: str = "local",
            tag: str = "") -> dict:
    knobs = (_attn.CACHE_UPDATE_MODE, _attn.DECODE_ATTN_MODE, _sh.FORCE_SEQ_SHARD_CACHE)
    _attn.CACHE_UPDATE_MODE = cache_update
    _attn.DECODE_ATTN_MODE = decode_attn
    _sh.FORCE_SEQ_SHARD_CACHE = decode_attn == "shard_map"
    try:
        return _run_one(arch, shape_name, multi_pod=multi_pod, save=save, verbose=verbose,
                        cache_update=cache_update, decode_attn=decode_attn, tag=tag)
    finally:
        _attn.CACHE_UPDATE_MODE, _attn.DECODE_ATTN_MODE, _sh.FORCE_SEQ_SHARD_CACHE = knobs


def _run_one(arch, shape_name, *, multi_pod, save, verbose, cache_update, decode_attn,
             tag) -> dict:
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
    t0 = time.perf_counter()
    try:
        with sh.use_mesh(mesh, rules):
            fn, arg_bytes = build_lowerable(cfg, shape_name, mesh)
            out, stats = count(fn)
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
        "opts": {"cache_update": cache_update, "decode_attn": decode_attn},
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
    ap.add_argument("--cache-update", choices=("onehot", "scatter"), default="onehot")
    ap.add_argument("--decode-attn", choices=("local", "shard_map"), default="local")
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
        res = run_one(a, s, multi_pod=mp, cache_update=args.cache_update,
                      decode_attn=args.decode_attn, tag=args.tag)
        failures += res["status"] == "failed"
    print(f"\n{len(combos)} combos, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
