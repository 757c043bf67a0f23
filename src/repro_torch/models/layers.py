"""Shared neural building blocks (plain PyTorch ops on tensors, and the
SwiGLU weights that the dense FFN and the MoE's shared experts hold).

On a mesh a placed SwiGLU holds this rank's ff columns (``w_gate``,
``w_up``) and rows (``w_down``) and all-reduces its partial output; a placed
embedding holds a block of vocab rows (:func:`embed`)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..distributed import sharding as sh
from ..kernels import ops


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


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, eps: float, split: bool) -> torch.Tensor:
    """:func:`rms_norm` of a vector of which ``x`` holds this rank's block
    of the last dim and ``weight`` its block of the weight, where ``split``
    (over the model axis): the mean of squares is the ranks' means averaged,
    one all-reduce of a scalar a row, whose gradient is summed over the
    ranks (each rank's block reads it). Not ``split``, or at model-axis
    size 1: :func:`rms_norm`."""
    m = sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS) if split else 1
    if m == 1:
        return rms_norm(x, weight, eps)
    dt = x.dtype
    x = x.float()
    ms = sh.copy_to(sh.all_reduce(torch.mean(x * x, dim=-1, keepdim=True))) / m
    return (x * torch.rsqrt(ms + eps) * weight.float()).to(dt)


def rms_norm_block(x: torch.Tensor, weight: torch.Tensor, eps: float, split: bool) -> torch.Tensor:
    """:func:`rms_norm` of ``x``, a whole vector that every rank holds the
    same, of which this rank keeps its block of the last dim where
    ``split``, scaled by ``weight`` (its block): the block enters a split
    region there (Megatron's f), so its gradient is summed over the ranks."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if split:
        x = sh.local_block(sh.copy_to(x), x.dim() - 1, sh.MODEL_AXIS)
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
    h = sh.shard(F.silu(x @ w_gate) * (x @ w_up), "batch", None, "ff")
    return h @ w_down


class SwiGLU(nn.Module):
    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

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
        split = self.tp is not None and self.tp.ff
        if not split and not sh.seq_sharded():
            return swiglu(x, self.w_gate, self.w_up, self.w_down)
        return sh.leave(swiglu(sh.enter(x, split), self.w_gate, self.w_up, self.w_down), split)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``jax.checkpoint``'s counterpart): non-reentrant
    ``torch.utils.checkpoint``. Without grad mode nothing is kept anyway, and
    ``fn`` simply runs. Nothing in the models draws random numbers, so the
    RNG state is not stashed. The recompute runs in ``backward()``, after
    the model's ``ops.plain_path`` has closed: it reopens the choice of the
    forward, so it takes the same kernels or plain versions."""
    if not torch.is_grad_enabled():
        return fn(*args)
    plain = ops.plain_only()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), ops.plain_path(plain)))


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits projection (this rank's vocab columns where ``w`` is placed)."""
    return sh.shard(x @ w, "batch", None, "vocab")


def embed(table: torch.Tensor, tokens: torch.Tensor,
          tp: Optional[sh.TensorParallel] = None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. With ``tp.vocab`` the table holds
    this rank's block of vocab rows: a masked lookup, all-reduced (in a
    sequence-parallel region reduce-scattered over the sequence, whose
    rank's block it returns)."""
    if tp is None or not tp.vocab:
        if sh.seq_sharded():  # each rank's block of the rows makes its part of the gradient
            table = sh.copy_to(table)
        return sh.leave(table[tokens.long()], False)
    rows = table.shape[0]
    ids = tokens.long() - sh.coordinate(sh.MODEL_AXIS) * rows
    inside = (ids >= 0) & (ids < rows)
    return sh.leave(table[ids.clamp(0, rows - 1)] * inside[..., None].to(table.dtype))


def unembed_input(x: torch.Tensor, tp: Optional[sh.TensorParallel]) -> torch.Tensor:
    """The final hidden state entering the logits projection: Megatron's f
    where ``tp.out_vocab`` splits the logits; in a sequence-parallel region
    the whole sequence, gathered (its gradient reduce-scattered where the
    vocab is split, else every rank's whole loss gives the same gradient,
    and the gather keeps the rank's block)."""
    out_vocab = tp is not None and tp.out_vocab
    if sh.seq_sharded() and not out_vocab:
        return sh.all_gather(x, 1)
    return sh.enter(x, out_vocab)


def gather_logits(params: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """Every vocab column of logits that a placed model computed on this
    rank's columns (``repro`` leaves them vocab-sharded too); as they are
    otherwise."""
    tp = getattr(params, "tp", None)
    return sh.all_gather(logits, logits.dim() - 1) if tp is not None and tp.out_vocab else logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_weight: float = 1e-4,
                  tp: Optional[sh.TensorParallel] = None):
    """Token-mean cross entropy with z-loss, in f32; logits (B, S, V), labels
    (B, S). Returns (ce + z mean, nll mean). With ``tp.out_vocab`` the logits
    are this rank's vocab columns: the log-sum-exp and the gold logit are
    reduced over the model axis (Megatron's vocab-parallel loss)."""
    logits = logits.float()
    if tp is not None and tp.out_vocab:
        cols = logits.shape[-1]
        m = sh.all_reduce(logits.detach().amax(dim=-1), op="max")
        lse = m + torch.log(sh.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
        ids = labels.long() - sh.coordinate(sh.MODEL_AXIS) * cols
        inside = (ids >= 0) & (ids < cols)
        gold = torch.gather(logits, -1, ids.clamp(0, cols - 1)[..., None])[..., 0]
        gold = sh.all_reduce(gold * inside)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    z = z_weight * (lse**2)
    return torch.mean(nll + z), torch.mean(nll)
