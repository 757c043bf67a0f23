"""Mamba2's chunked SSD scan as hand-written Hopper kernels.

Replaces no Pallas TPU kernel: ``repro/models/ssm.py::ssd_chunked`` is plain
jnp. The CUDA source, ``csrc/ssd_chunk.cu``, says what bounds it on the H100
and how it is laid out: three launches a call (each chunk's cumulative decay
and own state, with C.B once a chunk for every head; the state carried across
the chunks; the outputs, tile by tile up to the causal diagonal), every
product in f32 FFMA, and the intra-chunk scores only in shared memory.

:func:`ssd_chunked` launches the kernels and takes CUDA tensors only, as
``_mamba_mix`` hands them over: ``x``, ``Bm`` and ``Cm`` in the model's type
and strided (slices of the conv's output), ``dt``, ``A`` and ``D`` in f32. Its
plain version is ``models/ssm.py::ssd_chunked``. The workspaces' sizes depend
on the shapes alone and nothing is read back, so a call can be captured in a
CUDA graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["ssd_chunked"]

MAX_CHUNK = 2048  # csum and dt of a chunk sit in shared memory beside two 16 KB tiles


def vector_rows(t: torch.Tensor) -> bool:
    """Whether the kernels' 4-element vector loads can read ``t``: its last
    axis contiguous, its start and its other strides multiples of 4 elements."""
    return (t.stride(-1) == 1 and t.data_ptr() % (4 * t.element_size()) == 0
            and all(s % 4 == 0 for s in t.stride()[:-1]))


def ssd_chunked(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32
    A: torch.Tensor,    # (H,) f32
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    D: torch.Tensor,    # (H,) f32
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) in x's dtype, h_final (B, H, N, P) f32) on the card."""
    tensors = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_chunked kernel takes CUDA tensors on one device")
    if x.dtype not in _build.DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_chunked kernel takes x, Bm and Cm in float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t is not None and t.dtype != torch.float32 for t in (dt, A, D, h0)):
        raise TypeError("ssd_chunked kernel takes dt, A, D and h0 in float32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,)
            or Bm.shape != (Bsz, S, N) or Cm.shape != (Bsz, S, N)
            or (h0 is not None and h0.shape != (Bsz, H, N, P))):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} D {tuple(D.shape)}")
    if (N, P) not in _build.SSD_SHAPES:
        raise ValueError(f"ssd_chunked kernel is built for (d_state, head dim) in "
                         f"{_build.SSD_SHAPES}, got N {N}, P {P}")
    L = min(chunk, S)
    if S < 1 or not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"ssd_chunked kernel takes 1 <= min(chunk, S) <= {MAX_CHUNK}, got "
                         f"chunk {chunk}, S {S}")
    if not all(vector_rows(t) for t in (x, Bm, Cm)):
        raise ValueError("ssd_chunked kernel reads x, Bm and Cm in 4-element vectors: each needs "
                         "a contiguous last axis and a start and strides of multiples of 4")
    dt, A, D = dt.contiguous(), A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    nC, Lp = -(-S // L), -(-L // 64) * 64
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, N, P), **f32)
    states = torch.empty((2, Bsz, nC, H, N, P), **f32)  # each chunk's own, its start
    csum = torch.empty((Bsz, H, nC, Lp), **f32)
    cb = torch.empty((Bsz, nC, Lp, Lp), **f32)
    with torch.cuda.device(x.device):
        err = _build.kernel("ssd_chunked")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), states[0].data_ptr(),
            states[1].data_ptr(), csum.data_ptr(), cb.data_ptr(), Bsz, S, H, N, P, L,
            x.stride(0), x.stride(1), x.stride(2), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1), _build.DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check("ssd_chunked", err)
    return y, h
