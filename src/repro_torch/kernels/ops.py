"""Dispatcher for the three kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version. ``use_kernel=False`` asks for the plain version on
either device, as ``use_pallas=False`` does in ``repro.kernels.ops``: that is
how a run compares the kernel path with the plain path on the card. A kernel
that fails to build or launch raises; nothing falls back.

Unlike ``repro.kernels.ops`` nothing is padded: the kernels mask ragged
edges themselves. ``launches`` and ``plain`` count kernel launches and
plain-version calls per kernel, ``backward`` the plain recomputations of a
kernel's backward (see :mod:`repro_torch.kernels._build`).

Under autograd (grad mode on and an input that requires grad) a CUDA call of
flash attention goes through :class:`~repro_torch.kernels.flash_attention.FlashAttention`:
the kernel's forward, the plain version's gradient. Without a gradient the
kernel is called as it is, so serving and CUDA-graph capture launch the same.
Nothing trains through the matmul and decode-attention kernels; asked for a
gradient on the card, they raise rather than return an output that autograd
would treat as a constant.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from . import decode_attention as _k3
from . import flash_attention as _k2
from .decode_attention import decode_attention as _decode_attention
from .matmul_probe import matmul as _matmul

launches = _build.launches
plain = _build.plain
backward = _build.backward
form_launches = _build.form_launches
form_plain = _build.form_plain
reset_counters = _build.reset_counters


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_grad_kernel(name: str, *tensors: torch.Tensor) -> None:
    if _wants_grad(*tensors):
        raise RuntimeError(f"the {name} kernel has no backward: call it under torch.no_grad() "
                           f"or with inputs that do not require grad")


def prepare_capture(device: torch.device) -> None:
    """Make the kernels ready to be captured in a CUDA graph on ``device``:
    build and load them, and zero the decode kernel's ticket array. Launches
    nothing, so the launch counts stay those of real work."""
    for name in _build.KERNELS:
        _build.kernel(name)
    _k3.prepare(device)


def matmul(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    if use_kernel and _on_card(a):
        _no_grad_kernel("matmul", a, b)
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
    window: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    if use_kernel and _on_card(q):
        if _wants_grad(q, k, v):
            return _k2.FlashAttention.apply(q, k, v, causal, sm_scale, window)
        return _k2.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
    plain["flash_attention"] += 1
    return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, window=window)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    use_kernel: bool = True,
    return_lse: bool = False,
):
    """The output, or with ``return_lse`` the pair (output, log-sum-exp
    (batch, q_heads) f32), counted as ``decode_attention_lse``."""
    if use_kernel and _on_card(q):
        _no_grad_kernel("decode_attention", q, k_cache, v_cache)
        return _decode_attention(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                 return_lse=return_lse)
    if return_lse:
        form_plain["decode_attention_lse"] += 1
    else:
        plain["decode_attention"] += 1
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                    return_lse=return_lse)
