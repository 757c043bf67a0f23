"""GQA attention: prefill (causal, bidirectional, sliding-window, or cross
attention over given keys and values) and single-token decode against a KV
cache.

Attention runs through the dispatcher, :mod:`repro_torch.kernels.ops`: on a
CUDA tensor the prefill goes to the flash-attention kernel and each decode
step to the decode-attention kernel; on a CPU tensor both go to the plain
versions, which compute what ``repro.kernels.ref`` computes. The
``(B, heads, S, hd)`` layout is kept at those calls, and the weights keep
``repro``'s layout (``wq (d, H, hd)``, ``wo (H, hd, d)``) so the einsums read
the same.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import ops
from .layers import normal_init, rms_norm, rope


class Attention(nn.Module):
    """Weights of one attention block (``repro.models.attention.AttnParams``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 qk_norm: bool, dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wq = param(d_model, n_heads, head_dim)
        self.wk = param(d_model, n_kv_heads, head_dim)
        self.wv = param(d_model, n_kv_heads, head_dim)
        self.wo = param(n_heads, head_dim, d_model)
        self.q_norm = param(head_dim) if qk_norm else None
        self.k_norm = param(head_dim) if qk_norm else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d_model, n_heads, head_dim = self.wq.shape
        s = d_model**-0.5
        so = (n_heads * head_dim) ** -0.5
        for w, scale in ((self.wq, s), (self.wk, s), (self.wv, s), (self.wo, so)):
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))
        for w in (self.q_norm, self.k_norm):
            if w is not None:
                w.fill_(1.0)


def _write_cache_row(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache: (B, K, S, hd); new: (B, K, 1, hd); slot: (B,) int32.

    The scatter write of ``repro.models.attention._write_cache_row``, done
    in place: row ``slot[b]`` of the preallocated cache is overwritten and
    nothing else is touched (O(hd) bytes a sequence)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot.long()] = new[:, :, 0].to(cache.dtype)


def _project_q(p: Attention, x: torch.Tensor, positions: torch.Tensor,
               rope_theta: float, eps: float, use_rope: bool) -> torch.Tensor:
    """x: (B, S, d) -> q (B, S, H, hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, eps)
    return rope(q, positions, rope_theta) if use_rope else q


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 rope_theta: float, eps: float, use_rope: bool = True):
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, K, hd)."""
    q = _project_q(p, x, positions, rope_theta, eps, use_rope)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm, eps)
    if use_rope:
        k = rope(k, positions, rope_theta)
    return q, k, v


def prefill_attention(
    p: Attention,
    x: torch.Tensor,               # (B, S, d)
    positions: torch.Tensor,       # (B, S)
    *,
    rope_theta: float,
    eps: float,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # (B, S_kv, K, hd)
    use_kernel: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the sequence (causal, or bidirectional with
    ``causal=False``), or with ``cross_kv`` attention of the sequence's
    queries over given keys and values, each optionally within a sliding
    ``window`` (zamba2's shared attention). Returns (out (B,S,d), (k, v) in
    (B,K,S,hd) layout)."""
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, positions, rope_theta, eps, use_rope)
    else:
        q = _project_q(p, x, positions, rope_theta, eps, use_rope)
        k, v = cross_kv
    # (B, heads, S, hd) layout for the kernels
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=causal, window=window, use_kernel=use_kernel)
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p.wo)
    return y, (kh, vh)


def decode_attention_step(
    p: Attention,
    x: torch.Tensor,              # (B, 1, d) current token activations
    k_cache: torch.Tensor,        # (B, K, S, hd), written in place
    v_cache: torch.Tensor,
    lengths: torch.Tensor,        # (B,) int32 current valid length (position of new tok)
    *,
    rope_theta: float,
    eps: float,
    window: Optional[int] = None,
    use_rope: bool = True,
    update_cache: bool = True,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One decode step. Returns out (B,1,d); the new token's K and V rows are
    written into the caches in place.

    With ``window``, the cache has size S == window and new entries are
    written at position ``lengths % window`` (ring buffer); attention masks
    to the min(lengths, window) most recent entries, which the decode kernel
    computes as it is. RoPE uses absolute positions so rotations stay
    consistent in the ring.

    With ``update_cache=False`` (cross-attention over the encoder's K/V)
    nothing is written and the step attends over the first min(lengths, S)
    rows; the token's own K and V are not computed, since nothing reads them.
    """
    S = k_cache.shape[2]
    positions = lengths[:, None]  # (B, 1) absolute position of the new token
    if update_cache:
        q, k_new, v_new = _project_qkv(p, x, positions, rope_theta, eps, use_rope)
        slot = lengths % S if window is not None else lengths
        _write_cache_row(k_cache, k_new.transpose(1, 2), slot)
        _write_cache_row(v_cache, v_new.transpose(1, 2), slot)
        valid = torch.clamp(lengths + 1, max=S)
    else:
        q = _project_q(p, x, positions, rope_theta, eps, use_rope)
        valid = torch.clamp(lengths, max=S)
    qh = q.transpose(1, 2).contiguous()       # (B, H, 1, hd)
    out = ops.decode_attention(qh, k_cache, v_cache, valid.to(torch.int32),
                               use_kernel=use_kernel)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p.wo)
