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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Union

import torch

from ..configs.base import ArchConfig
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


def make_train_step(model: Model, opt: AdamW, *, remat: bool = True) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with the parameters and the state updated in place; metrics
    ``loss``, ``ce``, ``nll``, ``aux``, ``grad_norm`` and ``lr`` as 0-dim
    tensors. ``batch`` holds tensors on the model's device."""

    def train_step(params, opt_state: AdamWState, batch):
        params.requires_grad_(True)  # built frozen for serving
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss(params, batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        opt_metrics = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


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
