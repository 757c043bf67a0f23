"""K3: single-token decode attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. The CUDA source,
``csrc/decode_attention.cu``, says what bounds it on the H100 and how it is
laid out: one CTA per (batch, kv head) that serves all ``group`` query heads
of that kv head, so each K and V row is read once; a loop over the keys below
``lengths[b]`` only; an f32 online softmax; output in q's dtype.

:func:`decode_attention` launches the kernel and takes CUDA tensors only; its
plain version is :func:`plain` (``ref.decode_attention_ref``). They differ at
one point, which the tests pin: at length 0 the kernel returns zeros, as the
Pallas kernel does, where the plain version returns the mean of V. Serving
never asks for length 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import decode_attention_ref as plain

MAX_GROUP = 16

__all__ = ["decode_attention", "plain"]


def decode_attention(
    q: torch.Tensor,        # (batch, q_heads, 1, d)
    k_cache: torch.Tensor,  # (batch, kv_heads, S, d)
    v_cache: torch.Tensor,  # (batch, kv_heads, S, d)
    lengths: torch.Tensor,  # (batch,) int32 valid prefix per sequence
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    tensors = (q, k_cache, v_cache, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention kernel takes CUDA tensors on one device")
    if q.dtype not in _build.DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode kernel expects exactly one query token, got {tuple(q.shape)}")
    batch, q_heads, _, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad cache shapes {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    kb, kv_heads, s_len, kd = k_cache.shape
    if kb != batch or kd != d or q_heads % kv_heads or lengths.shape != (batch,):
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    if d not in _build.HEAD_DIMS or q_heads // kv_heads > MAX_GROUP:
        raise ValueError(f"head_dim {d} / group {q_heads // kv_heads} not supported")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("decode_attention kernel takes contiguous 16-byte aligned tensors")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.kernel("decode_attention")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), batch, q_heads, kv_heads, s_len, d, float(sm_scale),
            _build.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check("decode_attention", err)
    return out
