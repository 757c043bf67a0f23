"""Shared neural building blocks (plain PyTorch ops on tensors, and the
SwiGLU weights that the dense FFN and the MoE's shared experts hold)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def normal_init(shape, scale: float, dtype: torch.dtype, generator: torch.Generator) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``generator`` on its device, then cast
    (the scales of ``repro.models.layers.normal_init``; the values differ from
    ``jax.random``'s)."""
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def parameter(shape, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    """An uninitialised weight, built frozen (``requires_grad=False``):
    serving records no autograd graph; the trainer turns gradients on."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions.float()[..., None] * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.w_gate = param(d_model, d_ff)
        self.w_up = param(d_model, d_ff)
        self.w_down = param(d_ff, d_model)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d_model, d_ff = self.w_gate.shape
        for w, scale in ((self.w_gate, d_model**-0.5), (self.w_up, d_model**-0.5),
                         (self.w_down, d_ff**-0.5)):
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``jax.checkpoint``'s counterpart): non-reentrant
    ``torch.utils.checkpoint``. Without grad mode nothing is kept anyway, and
    ``fn`` simply runs. Nothing in the models draws random numbers, so the
    RNG state is not stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits projection."""
    return x @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_weight: float = 1e-4):
    """Token-mean cross entropy with z-loss, in f32; logits (B, S, V), labels
    (B, S). Returns (ce + z mean, nll mean)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    z = z_weight * (lse**2)
    return torch.mean(nll + z), torch.mean(nll)
