"""K1: the Minos probe's matrix product as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro/kernels/matmul_probe.py::matmul``.
The CUDA source, ``csrc/matmul_probe.cu``, says what bounds it on the H100
and how it is laid out: for f32, 64x32 output tiles (128 CTAs at the probe's
512^3) fed by a 3-stage ``cp.async`` ring along K, 4x4 f32 accumulators a
thread in IEEE FFMA (never TF32), one thread summing each output in order of
k (repeated calls are bitwise equal); the ragged M, N and K edges are masked
in the kernel, so no caller pads.

:func:`matmul` launches the kernel and takes CUDA tensors only; its plain
version is :func:`plain` (``ref.matmul_ref``). The dispatcher,
:func:`repro_torch.kernels.ops.matmul`, picks between the two.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import matmul_ref as plain

__all__ = ["matmul", "plain"]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the card: (M, K) x (K, N) -> (M, N) in A's dtype."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul kernel takes CUDA tensors on one device")
    if a.dtype not in _build.DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.kernel("matmul")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, _build.DTYPES[a.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("matmul", err)
    return out
