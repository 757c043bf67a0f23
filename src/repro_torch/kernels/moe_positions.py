"""The MoE router's queue positions as a hand-written Hopper kernel.

Replaces no Pallas TPU kernel: ``repro/models/moe.py`` computes the positions
in plain jnp, as a cumsum of the f32 one-hot of every (token, choice) pair.
The CUDA source, ``csrc/moe_positions.cu``, says what bounds it on the H100
and how it counts: per chunk of 1,024 pairs, each expert's pairs counted in
shared memory; then each pair ranked within its warp and its chunk, from the
earlier chunks' counts. One launch for a row of one chunk, two for a longer
one.

:func:`moe_positions` takes the router's choices as ``moe.gates`` returns them,
(B, S, K) int64 on the card, and returns each pair's position in its expert's
queue in its own row, (B, S, K) int32, unclipped. Its plain version is
``ref.moe_positions_ref``. The workspace's size depends on the shapes alone
and nothing is read back, so a call can be captured in a CUDA graph.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["moe_positions"]

CHUNK = 1024       # pairs a block ranks (csrc/moe_positions.cu)
MAX_EXPERTS = 256  # experts the per-warp table in shared memory holds


def moe_positions(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B, S, K) int32 positions of ``gate_idx``'s pairs in their experts' queues."""
    if not gate_idx.is_cuda:
        raise ValueError("moe_positions kernel takes a CUDA tensor")
    if gate_idx.dtype != torch.int64:
        raise TypeError(f"moe_positions kernel takes int64 indices, got {gate_idx.dtype}")
    if gate_idx.dim() != 3:
        raise ValueError(f"gate_idx must be (B, S, K), got {tuple(gate_idx.shape)}")
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_positions kernel takes 1 to {MAX_EXPERTS} experts, got {n_experts}")
    B, S, K = gate_idx.shape
    n = S * K
    if not 1 <= B <= 65535 or n < 1:
        raise ValueError(f"moe_positions kernel takes 1 to 65535 rows of at least one pair, "
                         f"got {tuple(gate_idx.shape)}")
    idx = gate_idx.contiguous()
    pos = torch.empty((B, S, K), dtype=torch.int32, device=idx.device)
    counts = torch.empty((B, -(-n // CHUNK) - 1, n_experts), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = _build.kernel("moe_positions")(
            idx.data_ptr(), pos.data_ptr(), counts.data_ptr() if counts.numel() else None,
            B, n, n_experts, torch.cuda.current_stream().cuda_stream,
        )
    _build.check("moe_positions", err)
    return pos
