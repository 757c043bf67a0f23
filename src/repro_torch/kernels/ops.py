"""Dispatcher for the kernels, and the one place that chooses between a
kernel and its plain version.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version. Inside ``with plain_path():`` every dispatcher takes
the plain version on either device, as ``use_pallas=False`` does in
``repro.kernels.ops``: that is how a run compares the kernel path with the
plain path on the card. The models take no such option: ``Model`` opens the
scope when it was built with ``use_kernels=False``. A kernel that fails to
build or launch raises; nothing falls back.

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
would treat as a constant. The SSD scan has no backward kernel either: under
autograd it runs its plain version on the card too (zamba2's training),
counted in ``plain``. The MoE's queue positions take integer indices, which
carry no gradient: a CUDA call goes to their kernel under autograd too. The
MoE's decode kernel has no backward either: under autograd its dispatcher
runs the dense dispatch on the card.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..models.ssm import ssd_chunked as _plain_ssd_chunked
from . import _build, ref
from . import decode_attention as _k3
from . import flash_attention as _k2
from .decode_attention import decode_attention as _decode_attention
from .matmul_probe import matmul as _matmul
from .moe_decode import moe_decode as _moe_decode
from .moe_positions import moe_positions as _moe_positions
from .ssd_chunk import ssd_chunked as _ssd_chunked

launches = _build.launches
plain = _build.plain
backward = _build.backward
form_launches = _build.form_launches
form_plain = _build.form_plain
reset_counters = _build.reset_counters
counts = _build.counts


_plain_only = False


@contextlib.contextmanager
def plain_path(on: bool = True) -> Iterator[None]:
    """Inside the block every dispatcher takes the plain version (with
    ``on`` False: the kernel on the card, also inside an outer block). Nests;
    the value before it comes back on exit, an exception's too."""
    global _plain_only
    before, _plain_only = _plain_only, on
    try:
        yield
    finally:
        _plain_only = before


def plain_only() -> bool:
    """Whether an open :func:`plain_path` asks for the plain versions."""
    return _plain_only


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _kernel(t: torch.Tensor) -> bool:
    return not _plain_only and _on_card(t)


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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _kernel(a):
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
) -> torch.Tensor:
    if _kernel(q):
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
    return_lse: bool = False,
):
    """The output, or with ``return_lse`` the pair (output, log-sum-exp
    (batch, q_heads) f32), counted as ``decode_attention_lse``."""
    if _kernel(q):
        _no_grad_kernel("decode_attention", q, k_cache, v_cache)
        return _decode_attention(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                 return_lse=return_lse)
    if return_lse:
        form_plain["decode_attention_lse"] += 1
    else:
        plain["decode_attention"] += 1
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                    return_lse=return_lse)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,
):
    """Mamba2's chunked SSD scan: (y (B, S, H, P) in x's dtype, h_final (B,
    H, N, P) f32). The kernel on the card without a gradient; the plain scan
    (``models/ssm.py``) on the CPU, in :func:`plain_path` or under autograd."""
    tensors = (x, dt, A, Bm, Cm, D) + (() if h0 is None else (h0,))
    if _kernel(x) and not _wants_grad(*tensors):
        return _ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
    plain["ssd_chunked"] += 1
    return _plain_ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)


def moe_positions(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, choice) pair's 0-based position in its expert's queue in
    its own row, (B, S, K) int32 from ``gate_idx`` (B, S, K), unclipped. The
    kernel on the card; the cumsum form (``ref.moe_positions_ref``) on the
    CPU or in :func:`plain_path`."""
    if _kernel(gate_idx):
        return _moe_positions(gate_idx, n_experts)
    plain["moe_positions"] += 1
    return ref.moe_positions_ref(gate_idx, n_experts)


def moe_decode(x: torch.Tensor, gate_idx: torch.Tensor, gate_vals: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
               capacity: int) -> torch.Tensor:
    """The experts' output at one token a row, (B, 1, d) in x's dtype, from
    the router's choices (``moe.gates``: (B, 1, K) each). The kernel on the
    card without a gradient: only the chosen experts. The dense dispatch at
    ``capacity`` slots an expert (``ref.moe_experts_ref``) on the CPU, in
    :func:`plain_path` or under autograd; the two agree wherever no expert
    takes more than ``capacity`` of a row's pairs."""
    if _kernel(x) and not _wants_grad(x, gate_vals, w_gate, w_up, w_down):
        return _moe_decode(x, gate_idx, gate_vals, w_gate, w_up, w_down)
    plain["moe_decode"] += 1
    return ref.moe_experts_ref(x, gate_idx, gate_vals, w_gate, w_up, w_down, capacity)
