"""K3: single-token decode attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. The CUDA source,
``csrc/decode_attention.cu``, says what bounds it on the H100 and how it is
laid out: a split-KV flash-decode. The grid is ``batch * kv_heads *
n_splits`` CTAs; each takes one share of the keys below ``lengths[b]``
(:func:`split_range`, computed on the device from ``lengths``) for all
``group`` query heads of its kv head, so each K and V row is read once; the
last CTA of a (batch, kv head) merges the shares in split order, so the
output is bitwise repeatable. The softmax is f32; the output is in q's dtype.

:func:`n_splits` chooses the split count from the shapes alone, never from
``lengths``: the launch reads nothing back to the host and can be captured in
a CUDA graph. The wrapper allocates the f32 workspace of the partials with
``torch.empty`` and keeps, per device, a zeroed int32 ticket array that each
call leaves zeroed; calls that may run at the same time must share a stream.

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
SMS = 132          # the H100's streaming multiprocessors
KEY_GRAN = 32      # a split's keys are a multiple of this (as the kernel's KEY_GRAN)
MAX_SPLITS = 32    # as the kernel's MAX_SPLITS
MAX_TICKETS = 1 << 14  # batch * kv_heads a call may have

__all__ = ["decode_attention", "plain", "prepare", "n_splits", "split_range"]

_tickets: dict[int, torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def n_splits(batch: int, kv_heads: int, s_len: int) -> int:
    """Splits per (batch, kv head): enough CTAs to cover the 132 SMs about
    twice, no more splits than KEY_GRAN-key shares of the cache, at most
    MAX_SPLITS. From the shapes only, so a captured launch stays valid for
    any lengths."""
    return max(1, min(_cdiv(2 * SMS, batch * kv_heads), _cdiv(s_len, KEY_GRAN), MAX_SPLITS))


def split_range(length: int, s_len: int, splits: int, split: int) -> tuple[int, int]:
    """Keys [start, end) of share ``split``, as each CTA computes them on the
    device: ceil(len / splits) rounded up to KEY_GRAN, never below it, over
    the valid prefix len = clamp(length, 0, s_len). Shares past the prefix
    are empty."""
    n = max(0, min(length, s_len))
    chunk = max(KEY_GRAN, _cdiv(_cdiv(n, splits), KEY_GRAN) * KEY_GRAN)
    start = min(split * chunk, n)
    return start, min(start + chunk, n)


def _tickets_for(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: call it or prepare() once on this device "
                               "before capturing it in a CUDA graph (its ticket array is "
                               "zeroed then)")
        _tickets[index] = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
    return _tickets[index]


def prepare(device: torch.device) -> None:
    """Zero ``device``'s ticket array, launching nothing: what a CUDA-graph
    capture of :func:`decode_attention` needs done first."""
    with torch.cuda.device(device):
        _tickets_for(device)


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
    if batch * kv_heads > MAX_TICKETS:
        raise ValueError(f"batch * kv_heads {batch * kv_heads} > {MAX_TICKETS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("decode_attention kernel takes contiguous 16-byte aligned tensors")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    splits = n_splits(batch, kv_heads, s_len)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        tickets = _tickets_for(q.device)
        workspace = torch.empty(batch * q_heads * splits * (d + 2), dtype=torch.float32,
                                device=q.device)
        err = _build.kernel("decode_attention")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), tickets.data_ptr(), batch, q_heads,
            kv_heads, s_len, d, splits, float(sm_scale), _build.DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("decode_attention", err)
    return out
