"""K2: prefill flash attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``. The CUDA source,
``csrc/flash_attention.cu``, says what bounds it on the H100 and how it is
laid out: one CTA per (batch * q-head, 64-row q tile), a loop over 64-row kv
tiles that stops at the causal diagonal, GQA by kv head ``h // group``, an f32
online softmax, and ragged q and kv tails masked in the kernel, so unpadded
serving prompts never fall back. bf16 runs QK^T and PV on the tensor cores
(``wgmma``, P rounded to bf16 as the Pallas kernel rounds it, K and V through
a ``cp.async`` ring); f32 stays IEEE FFMA.

:func:`flash_attention` launches the kernel and takes CUDA tensors only; its
plain version is :func:`plain` (``ref.attention_ref``). The causal mask is
end-aligned (``q_pos = i + kv_seq - q_seq``) as in the plain version; causal
calls need ``q_seq <= kv_seq``. With ``window`` a key is kept only where
``q_pos - k_pos < window`` (a sliding window, zamba2's shared attention), with
or without the causal mask, as the plain version keeps it; the kernel then
reads only the kv tiles of each q tile's band.

:class:`FlashAttention` puts the kernel under autograd for training: its
forward launches the kernel and saves q, k and v; its backward recomputes the
plain version on them and returns the plain version's gradient, which is what
``jax.grad`` takes of ``repro``'s attention oracle (the GQA group sum comes
from the grouped einsum). The kernel's own output carries no ``grad_fn``, so
without the Function a gradient into q, k and v would be lost.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref as plain

__all__ = ["FlashAttention", "flash_attention", "plain"]


def flash_attention(
    q: torch.Tensor,  # (batch, q_heads, q_seq, d)
    k: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    v: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
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
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash_attention kernel copies 16-byte rows: "
                         "q, k and v must start 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.kernel("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, q_heads, kv_heads, q_seq, kv_seq, d, int(causal), window or 0, float(sm_scale),
            _build.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check("flash_attention", err)
    return out


# the profiler range of the backward's plain recomputation and its gradient
BACKWARD_RANGE = "flash_attention.backward (plain)"


class FlashAttention(torch.autograd.Function):
    """The kernel's forward, the plain version's backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float], window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, window=window)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        needs = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        _build.backward["flash_attention"] += 1
        with torch.enable_grad(), torch.profiler.record_function(BACKWARD_RANGE):
            out = plain(*inputs, **ctx.kw)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if n else None for n in needs), None, None, None)
