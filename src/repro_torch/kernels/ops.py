"""Dispatcher for the three kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version. ``use_kernel=False`` asks for the plain version on
either device, as ``use_pallas=False`` does in ``repro.kernels.ops``: that is
how a run compares the kernel path with the plain path on the card. A kernel
that fails to build or launch raises; nothing falls back.

Unlike ``repro.kernels.ops`` nothing is padded: the kernels mask ragged
edges themselves. ``launches`` and ``plain`` count kernel launches and
plain-version calls per kernel (see :mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .matmul_probe import matmul as _matmul

launches = _build.launches
plain = _build.plain
reset_counters = _build.reset_counters


def matmul(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    if use_kernel and a.is_cuda:
        return _matmul(a, b)
    plain["matmul"] += 1
    return ref.matmul_ref(a, b)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    if use_kernel and q.is_cuda:
        return _flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    plain["flash_attention"] += 1
    return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    if use_kernel and q.is_cuda:
        return _decode_attention(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    plain["decode_attention"] += 1
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
