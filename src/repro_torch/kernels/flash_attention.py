"""K2: prefill flash attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``. The CUDA source,
``csrc/flash_attention.cu``, says what bounds it on the H100 and how it is
laid out: one CTA per (batch * q-head, 64-row q tile), a loop over 64-row kv
tiles that stops at the causal diagonal, GQA by kv head ``h // group``, an f32
online softmax, and ragged q and kv tails masked in the kernel, so unpadded
serving prompts never fall back.

:func:`flash_attention` launches the kernel and takes CUDA tensors only; its
plain version is :func:`plain` (``ref.attention_ref``). The causal mask is
end-aligned (``q_pos = i + kv_seq - q_seq``) as in the plain version; causal
calls need ``q_seq <= kv_seq``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref as plain

__all__ = ["flash_attention", "plain"]


def flash_attention(
    q: torch.Tensor,  # (batch, q_heads, q_seq, d)
    k: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    v: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes CUDA tensors on one device")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    batch, q_heads, q_seq, d = q.shape
    kb, kv_heads, kv_seq, kd = k.shape
    if kb != batch or kd != d or q_heads % kv_heads:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_build.HEAD_DIMS}")
    if causal and q_seq > kv_seq:
        raise ValueError(f"causal attention needs q_seq <= kv_seq, got {q_seq} > {kv_seq}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.kernel("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, q_heads, kv_heads, q_seq, kv_seq, d, int(causal), float(sm_scale),
            _build.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check("flash_attention", err)
    return out
