"""Plain PyTorch versions of the three kernels.

They compute what ``repro.kernels.ref`` computes: the ground truth the CUDA
kernels are held against (``chip_smoke.py``, ``tests/test_torch_kernels.py``)
and the path :mod:`repro_torch.kernels.ops` takes for a tensor on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B accumulated in f32, returned in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def attention_ref(
    q: torch.Tensor,  # (batch, q_heads, q_seq, d)
    k: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    lengths: Optional[torch.Tensor] = None,  # (batch,) valid kv prefix
    window: Optional[int] = None,  # sliding-window size (None = full)
) -> torch.Tensor:
    """GQA attention. Grouped einsum, so the KV repeat is never
    materialised; f32 scores, masked to -1e30, causal mask aligned at the
    ends (q_pos = i + kv_seq - q_seq)."""
    batch, q_heads, q_seq, d = q.shape
    _, kv_heads, kv_seq, _ = k.shape
    group = q_heads // kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(batch, kv_heads, group, q_seq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * sm_scale
    q_pos = torch.arange(q_seq, device=q.device)[:, None] + (kv_seq - q_seq)
    k_pos = torch.arange(kv_seq, device=q.device)[None, :]
    mask = torch.ones((q_seq, kv_seq), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, _NEG)
    if lengths is not None:
        valid = k_pos < lengths.to(q.device)[:, None, None]  # (batch, 1, kv_seq)
        s = s.masked_fill(~valid[:, None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(batch, q_heads, q_seq, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # (batch, q_heads, 1, d)
    k_cache: torch.Tensor,  # (batch, kv_heads, S, d)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (batch,)
    *,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """With ``return_lse`` also each head's log-sum-exp of the scaled scores
    over its valid prefix, (batch, q_heads) f32, ``-inf`` at length 0: the
    pair the kernel's log-sum-exp form returns."""
    out = attention_ref(
        q, k_cache, v_cache, causal=False, sm_scale=sm_scale, lengths=lengths
    )
    if not return_lse:
        return out
    batch, q_heads, _, d = q.shape
    kv_heads, s_len = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(batch, kv_heads, q_heads // kv_heads, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * sm_scale
    valid = torch.arange(s_len, device=q.device) < lengths.to(q.device)[:, None]  # (batch, S)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    return out, torch.logsumexp(s, dim=-1).reshape(batch, q_heads)
