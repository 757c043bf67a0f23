"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-based
dispatch (GShard/Switch style), optional always-on shared experts
(DeepSeekMoE's fine-grained + shared design, arXiv:2401.06066), router
z-loss and load-balance auxiliary loss. What ``repro.models.moe`` computes,
in plain PyTorch ops (the reference runs it outside any Pallas kernel too).

Capacity: each expert processes at most C = max(4, int(S·top_k·cf/E))
tokens per sequence row; overflow tokens fall through (the residual passes
them unchanged): standard token dropping. Queue positions count a row's S·K
(token, choice) pairs in order (``ops.moe_positions``: a hand-written kernel
on the card, the reference's cumsum form elsewhere), so rows never share
capacity and a batch of rows routes each row as it would alone.

The dispatch is the reference's dense one: ``(B, S, E, C)`` dispatch and
combine masks, every expert's GEMM over its C slots. Its shapes depend only
on ``(B, S)``, and it reads no value back to the host, so a CUDA graph can
capture it. One-hot rows are built by comparing with ``arange``, which, like
``jax.nn.one_hot``, gives a zero row for an index out of range (a dropped
token's queue position is ``>= C``); ``F.one_hot`` would raise there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, MoEConfig
from ..distributed import sharding as sh
from ..distributed.sharding import shard
from ..kernels import ops
from .layers import SwiGLU, normal_init, swiglu


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(4, int(tokens * top_k * cf / n_experts))


class MoE(nn.Module):
    """The weights of one MoE FFN (``repro.models.moe.init_moe``'s tree):
    ``router`` (d, E) in f32, ``w_gate``/``w_up`` (E, d, d_e), ``w_down``
    (E, d_e, d), and with ``n_shared > 0`` a ``shared`` SwiGLU of width
    ``n_shared * d_e``. Placed on a mesh, it holds this rank's block of
    experts (and of the shared experts' ff columns): the dispatch keeps the
    rank's experts' slots, and the partial outputs are all-reduced once."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        m = self.m = cfg.moe
        d, de, dt = cfg.d_model, m.d_expert, cfg.torch_dtype

        def param(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.router = param(d, m.n_experts, dtype=torch.float32)
        self.w_gate = param(m.n_experts, d, de)
        self.w_up = param(m.n_experts, d, de)
        self.w_down = param(m.n_experts, de, d)
        self.shared = None
        if m.n_shared:
            self.shared = SwiGLU(d, m.n_shared * de, dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """``init_moe``'s scales: d^-0.5 into the experts, d_e^-0.5 out of
        them (the shared experts' down projection too)."""
        d, de = self.w_gate.shape[1], self.w_gate.shape[2]
        s_in, s_out = d**-0.5, de**-0.5
        ws = [(self.router, s_in), (self.w_gate, s_in), (self.w_up, s_in), (self.w_down, s_out)]
        if self.shared is not None:
            ws += [(self.shared.w_gate, s_in), (self.shared.w_up, s_in),
                   (self.shared.w_down, s_out)]
        for w, scale in ws:
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN's output alone: what a decode step keeps of
        :func:`apply_moe` (``repro`` computes the aux there and drops it)."""
        return _experts(self.m, self, x, router_probs(self, x)[1])


def router_probs(p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(router logits, softmax probabilities), (B, S, E) in f32."""
    logits = x.float() @ p.router
    return logits, torch.softmax(logits, dim=-1)


def router_aux(m: MoEConfig, logits: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch load balance (E · Σ_e f_e · p̄_e, f from the top-1 choice) and
    router z-loss, on the full distribution; a 0-dim f32 tensor. On a mesh
    ``f`` and ``p̄`` are the means over the whole batch (one all-reduce
    over the data axes); the z-loss is this rank's rows' mean."""
    E = m.n_experts
    f = _one_hot(torch.argmax(probs, dim=-1), E).mean(dim=(0, 1))
    pbar = probs.mean(dim=(0, 1))
    # the whole batch's means, where the batch is split over the data ranks
    # (the product is not linear in the batch; the z-loss's mean is)
    f, pbar = sh.data_mean(torch.stack([f, pbar]), sh.logical_to_spec("batch")[0])
    lb = E * torch.sum(f * pbar)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return m.load_balance_weight * lb + m.router_z_weight * z


def gates(m: MoEConfig, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gate values renormalised to sum to 1, and the experts chosen,
    (B, S, K) each, largest first."""
    gate_vals, gate_idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return gate_vals, gate_idx


def dispatch_combine(m: MoEConfig, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, S, E, C) f32 dispatch mask (1 where token s takes slot c of
    expert e) and combine weights (its gate value there)."""
    _, S, E = probs.shape
    C = _capacity(S, m.top_k, E, m.capacity_factor)
    gate_vals, gate_idx = gates(m, probs)
    # position of each (token, k) within its expert queue, per row
    pos = ops.moe_positions(gate_idx, E)       # (B, S, K) int32
    keep = pos < C
    routed = _one_hot(gate_idx, E) * keep[..., None]                   # (B, S, K, E)
    cap_oh = _one_hot(pos, C)                                          # (B, S, K, C), 0 past C
    dispatch = torch.einsum("bske,bskc->bsec", routed, cap_oh)
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, routed, cap_oh)
    return dispatch, combine


def _experts(m: MoEConfig, p: MoE, x: torch.Tensor, probs: torch.Tensor,
             seq_block: bool = False) -> torch.Tensor:
    """The experts' output; on a mesh the rank's experts, their partial sum
    all-reduced (with ``seq_block`` reduce-scattered over the sequence, and
    an unsplit part's block of the sequence kept)."""
    tp = p.tp
    if tp is not None and tp.experts:
        # the combine weights below are split: their gradient is partial
        probs = sh.copy_to(probs)
    dispatch, combine = dispatch_combine(m, probs)
    if tp is not None and tp.experts:
        dispatch = shard(dispatch, "batch", None, "expert", None)
        combine = shard(combine, "batch", None, "expert", None)
        x = sh.copy_to(x)
    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)       # (B, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, p.w_gate)
    u = torch.einsum("becd,edf->becf", xe, p.w_up)
    ye = torch.einsum("becf,efd->becd", F.silu(h) * u, p.w_down)       # (B, E, C, d)
    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)
    if tp is None:
        if p.shared is not None:
            y = y + p.shared(x)
        return y
    # the local program: one all-reduce of the split parts' partial sums
    split = [y] if tp.experts else []
    whole = [] if tp.experts else [y]
    if p.shared is not None:
        s = p.shared
        s_split = s.tp is not None and s.tp.ff
        ys = swiglu(sh.copy_to(x) if s_split and not tp.experts else x, s.w_gate, s.w_up,
                    s.w_down)
        (split if s_split else whole).append(ys)
    if seq_block:
        y = sh.reduce_scatter(sum(split), 1) if split else 0
        whole = [sh.local_block(part, 1, sh.MODEL_AXIS) for part in whole]
    else:
        y = sh.all_reduce(sum(split)) if split else 0
    for part in whole:
        y = y + part
    return shard(y, "batch", None, None)


def apply_moe(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss), as ``repro.models.moe.apply_moe``. In
    a sequence-parallel region ``x`` and ``y`` are the rank's block of the
    sequence: the router's queues read the whole sequence, so it is
    gathered first, and every rank computes the router and aux whole (its
    gradient is whole: the split experts' part is all-reduced)."""
    seq_block = sh.seq_sharded()
    if seq_block:
        x = sh.all_gather(x, 1)
    with sh.sequence_parallel(False):
        logits, probs = router_probs(p, x)
        y = _experts(cfg.moe, p, x, probs, seq_block)
        return y, router_aux(cfg.moe, logits, probs)
