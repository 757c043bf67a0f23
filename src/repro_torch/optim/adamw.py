"""AdamW with decoupled weight decay, global-norm clipping and f32 master
weights, the port of ``repro.optim.adamw``.

The state holds f32 ``mu``, ``nu`` and ``master``, each a dict keyed by the
parameter's name in the model module, and an int32 0-dim ``step``. An update
writes the state and the parameters in place (the new master, cast to the
parameter's dtype), so their tensors never change and a later CUDA-graph
capture of a whole training step stays possible. Everything the update
computes stays on the device; nothing is read back to the host.

A leaf is decayed where its rank in ``repro``'s tree is above 1
(:func:`repro_torch.models.convert.reference_ndim`): ``repro`` stacks the
per-layer weights over the layer axis, so a layer's norm vector is rank 2
there and decayed, where the port holds it as a rank-1 tensor. The set
depends only on the module's structure, so it is computed once per module.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, NamedTuple, Union

import torch
from torch import nn

from ..models.convert import reference_ndim


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32, 0-dim
    mu: dict[str, torch.Tensor]        # first moment (f32)
    nu: dict[str, torch.Tensor]        # second moment (f32)
    master: dict[str, torch.Tensor]    # f32 master copy of the parameters


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # module -> {parameter name: decayed}; weak, so a dropped module leaves
    _decayed: weakref.WeakKeyDictionary = dataclasses.field(
        default_factory=weakref.WeakKeyDictionary, init=False, repr=False, compare=False)

    def decayed(self, params: nn.Module) -> dict[str, bool]:
        """{parameter name: decayed}, by the rank of ``repro``'s leaf."""
        out = self._decayed.get(params)
        if out is None:
            out = self._decayed[params] = {n: r > 1 for n, r in reference_ndim(params).items()}
        return out

    def init(self, params: nn.Module) -> AdamWState:
        named = dict(params.named_parameters())
        device = next(iter(named.values())).device
        with torch.no_grad():
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                mu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in named.items()},
                nu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in named.items()},
                master={n: p.detach().float().clone() for n, p in named.items()},
            )

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: nn.Module) -> dict[str, torch.Tensor]:
        """One step, in place: ``grads`` by parameter name (None counts as
        zeros). Returns {"grad_norm", "lr"}, 0-dim f32 tensors."""
        named = dict(params.named_parameters())
        decayed = self.decayed(params)

        def f32(n):  # widened one at a time: no f32 copy of every gradient at once
            g = grads.get(n)
            return torch.zeros_like(state.master[n]) if g is None else g.float()

        # global-norm clip (f32): each gradient's sum of squares, taken in f32
        # as the reduction reads it
        zero = torch.zeros((), dtype=torch.float32, device=state.step.device)
        gnorm = torch.sqrt(torch.stack([
            zero if grads.get(n) is None
            else torch.square(torch.linalg.vector_norm(grads[n], dtype=torch.float32))
            for n in named]).sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        state.step.add_(1)
        step = state.step.float()
        lr = self._lr(state.step)
        b1c = 1.0 - torch.pow(self.b1, step)
        b2c = 1.0 - torch.pow(self.b2, step)
        for n, p in named.items():
            g = f32(n) * scale
            m, v, master = state.mu[n], state.nu[n], state.master[n]
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if decayed[n]:
                upd = upd + self.weight_decay * master
            master.sub_(lr * upd)
            p.copy_(master)
        return {"grad_norm": gnorm, "lr": lr}
