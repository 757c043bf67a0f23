"""Training loop, the port of ``repro.train.loop``: a train-step factory and a
simple host loop.

A step is eager PyTorch: the gradients are dropped, ``Model.loss`` runs
forward (each layer recomputed in the backward with ``remat``, where
``repro`` uses ``jax.checkpoint``), ``loss.backward()`` takes the gradients,
and :class:`~repro_torch.optim.adamw.AdamW` updates the parameters and its
state in place. On the card attention's forward is the flash-attention
kernel and its backward the plain version's gradient
(:class:`~repro_torch.kernels.flash_attention.FlashAttention`). The metrics
stay 0-dim tensors on the device; :func:`train` reads them on the host only
at its log steps, as ``repro``'s loop does.

On a mesh the same step is one rank's local program of ``repro``'s SPMD
step (the parameters placed by ``launch.shardings.place_params``, the batch
this rank's rows): the gradients that a split region leaves partial are
all-reduced over the model axis, every gradient is averaged over the batch
axes, the metrics are the whole batch's and the clip reads the global norm.
With gradient accumulation the batch-axis all-reduce runs once a step, after
the micro-batches' sum; an FSDP block's reduce-scatter is its all-gather's
backward, in each micro-batch's backward.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..launch import shardings as _sh
from ..models.model import Model, build_model
from ..optim.adamw import AdamW, AdamWState
from ..optim.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    remat: bool = True


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(
        learning_rate=warmup_cosine(tc.peak_lr, tc.warmup_steps, tc.total_steps),
        weight_decay=tc.weight_decay,
        clip_norm=tc.clip_norm,
    )


def make_train_step(model: Model, opt: AdamW, *, remat: bool = True,
                    specs: Optional[dict[str, tuple]] = None,
                    state_specs: Optional[dict[str, tuple]] = None,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with the parameters and the state updated in place; metrics
    ``loss``, ``ce``, ``nll``, ``aux``, ``grad_norm`` and ``lr`` as 0-dim
    tensors. ``batch`` holds tensors on the model's device. After the step
    each parameter's ``grad`` holds the gradient the update read, in the
    parameter's dtype.

    ``accum_steps`` cuts the batch into that many micro-batches of equal
    rows: their gradients are summed in f32 and divided by the count, and
    the loss is their mean (``repro``'s dry-run knob).

    ``specs`` (what ``place_params`` returned for ``params``) makes it the
    rank's program on the current mesh (``sharding.use_mesh``), ``batch``
    this rank's rows of the rules' ``"batch"`` axes:

    - the gradients of ``partial_grad_names`` are all-reduced over the model
      axis;
    - each gradient is summed over the batch axes (all-reduced, where the
      FSDP all-gather's backward has not reduce-scattered it) and divided by
      their size: the mean over the whole batch;
    - the metrics are averaged over the batch axes in one all-reduce, so
      every rank reports the whole batch's loss, and the update's clip reads
      the global norm (``AdamW.update``'s ``specs``).

    ``state_specs`` places the optimizer state apart from whole parameters
    (ZeRO-1: the state made by ``opt.init(params, state_specs)``): the
    update reads this rank's block of each averaged gradient and
    all-gathers the parameters."""

    def train_step(params, opt_state: AdamWState, batch):
        mesh = sh.current_mesh() if specs is not None else None
        params.requires_grad_(True)  # built frozen for serving
        params.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, metrics = model.loss(params, batch, remat=remat)
            loss.backward()
            grads = {n: p.grad for n, p in params.named_parameters()}
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
        else:
            grads, metrics = _accumulate(model, params, batch, remat, accum_steps)
        if mesh is not None:
            seq = batch["tokens"].shape[1] if "tokens" in batch else None
            grads = _reduce_grads(grads, specs, _sh.partial_grad_names(params, seq))
            keys = sorted(metrics)
            mean = sh.data_mean(torch.stack([metrics[k].float() for k in keys]),
                                sh.logical_to_spec("batch")[0])
            metrics = dict(zip(keys, mean.unbind()))
        named = dict(params.named_parameters())
        with torch.no_grad():
            for n, g in grads.items():
                named[n].grad = None if g is None else g.to(named[n].dtype)
        if mesh is not None and state_specs is not None:
            grads = {n: None if g is None else sh.block(g, state_specs[n])
                     for n, g in grads.items()}
        opt_metrics = opt.update(grads, opt_state, params,
                                 specs=(state_specs or specs) if mesh is not None else None)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _accumulate(model: Model, params, batch, remat: bool, n: int):
    """The gradients (f32) and metrics of ``batch`` as the mean over ``n``
    micro-batches of its rows, each a forward and backward of its own."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not cut into {n} micro-batches")
    size = rows // n
    acc: dict[str, Optional[torch.Tensor]] = {}
    sums: dict[str, torch.Tensor] = {}
    for i in range(n):
        micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss(params, micro, remat=remat)
        loss.backward()
        with torch.no_grad():
            for name, p in params.named_parameters():
                if p.grad is not None:
                    acc[name] = p.grad.float() if acc.get(name) is None else acc[name] + p.grad
                else:
                    acc.setdefault(name, None)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
    grads = {name: None if g is None else g / n for name, g in acc.items()}
    return grads, {k: v / n for k, v in sums.items()}


@torch.no_grad()
def _reduce_grads(grads: dict, specs: dict, partial: list[str]) -> dict:
    """Each rank's gradients as the whole batch's mean of the whole
    model's: partial sums all-reduced over the model axis, sums over the
    batch axes divided by their size (an FSDP block's gradient is already
    summed over its data axes, by its all-gather's backward)."""
    mesh = sh.current_mesh()
    batch = sh.logical_to_spec("batch")[0]
    batch_axes = (batch,) if isinstance(batch, str) else tuple(batch or ())
    n = sh.mesh_size(mesh, batch)
    partial = set(partial)
    out = {}
    for name, g in grads.items():
        if g is None:
            out[name] = None
            continue
        if name in partial:
            g = sh.all_reduce(g, sh.MODEL_AXIS)
        summed: set[str] = set()
        for entry in specs[name]:
            if entry is None or entry == sh.MODEL_AXIS:
                continue
            summed.update((entry,) if isinstance(entry, str) else entry)
        rest = tuple(a for a in batch_axes if a not in summed)
        if rest:
            g = sh.all_reduce(g, rest)
        out[name] = (g / n if n > 1 else g).contiguous()
    return out


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays (``TokenStream``'s) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train(
    cfg: ArchConfig,
    data_iter,
    tc: TrainConfig,
    *,
    steps: int,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> tuple[Any, list[dict]]:
    """Host-side loop on one device: the card unless ``device="cpu"``.
    Returns (params, history); weights from ``Model.init(seed)``."""
    model = build_model(cfg, device=device)
    params = model.init(seed)
    opt = make_optimizer(tc)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, remat=tc.remat)
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = to_device(next(data_iter), model.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if log_fn:
                log_fn(step, m)
    return params, history
