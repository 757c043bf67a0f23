"""The MoE FFN of a decode step as a hand-written Hopper kernel: each token
reads the weights of its top-k experts only.

Replaces no Pallas TPU kernel: ``repro/models/moe.py`` is plain jnp, a dense
dispatch that computes every expert over its capacity slots. The CUDA source,
``csrc/moe_decode.cu``, says what bounds it on the H100 (its bytes, at 3.35
TB/s) and how it streams them: one launch for the gate and up projections of
every (row, choice) pair, with the activation applied and rounded to the
model's type, one for the down projection summed over the row's choices, and,
where the down projection's reduction is split across blocks, one that adds
the splits in order.

:func:`moe_decode` takes what ``models/moe.py::_experts`` has at one token a
row: x (B, 1, d), the router's choices as ``moe.gates`` returns them (indices
(B, 1, K) int64, gate values (B, 1, K) f32) and the experts' weights; it
returns the experts' output (B, 1, d) in x's type, without the shared expert.
Its plain version is the dense dispatch (``kernels/ref.py::moe_experts_ref``),
which gives the same wherever no expert takes more of a row's pairs than its
capacity: always at one token. Scratch sizes depend on the shapes alone and
nothing is read back, so a call can be captured in a CUDA graph.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["moe_decode", "plan"]

MAX_TOP_K = 64   # the row's expert table in shared memory (csrc/moe_decode.cu)
MAX_D = 8192     # x in f32 in shared memory beside the warps' sums, under 48 KB
MAX_SPLIT_ROWS = 8192  # a split's coefficients in f32 in shared memory
MIN_SPLIT_ROWS = 512   # below this a split's blocks spend more on set-up than on loads
BLOCKS_PER_SM = 3      # blocks a launch wants on each SM to keep enough loads in flight


def plan(B: int, K: int, d: int, d_e: int, itemsize: int, sms: int) -> tuple[int, int, int]:
    """(threads a row of the up launch, of the down launch, splits of the
    down launch's K·d_e rows), from the shapes alone. A thread reads 16
    bytes of a row, so a block's tile is 4 or 8 such vectors wide. Wider
    tiles read longer runs of each row; narrower ones, and splits, make more
    blocks. A launch streams fastest with about three blocks an SM (timed
    on the H100 at granite's and granite-4.0-h's shapes, batch 1 and 8:
    PERF.md §6), so each launch takes the wider tile where it still reaches
    ``BLOCKS_PER_SM * sms`` blocks, and the down launch splits its rows
    until it does, while a split keeps at least ``MIN_SPLIT_ROWS``."""
    vec = 16 // itemsize
    want = BLOCKS_PER_SM * sms
    rows = K * d_e

    def blocks(n_cols, tpr):
        return -(-n_cols // (tpr * vec))

    def most_splits():
        return max(1, rows // MIN_SPLIT_ROWS)

    tpr_up = 8 if B * K * blocks(d_e, 8) >= want else 4
    tpr_down = 8 if B * blocks(d, 8) * most_splits() >= want else 4
    splits = 1
    while (-(-rows // splits) > MAX_SPLIT_ROWS
           or (B * blocks(d, tpr_down) * splits < want and 2 * splits <= most_splits())):
        splits *= 2
    return tpr_up, tpr_down, splits


def moe_decode(x: torch.Tensor, gate_idx: torch.Tensor, gate_vals: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) in x's dtype: Σ_k g_k · SwiGLU_{e_k}(x) for each row."""
    tensors = (x, gate_idx, gate_vals, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("moe_decode kernel takes CUDA tensors on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the moe_decode kernel has no backward: call it under torch.no_grad() "
                           "or with inputs that do not require grad")
    if x.dtype not in _build.DTYPES or any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"moe_decode kernel takes x and the weights in float32 or bfloat16, one "
                        f"type, got {x.dtype}, {w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    if gate_idx.dtype != torch.int64 or gate_vals.dtype != torch.float32:
        raise TypeError(f"moe_decode kernel takes int64 indices and float32 gate values, got "
                        f"{gate_idx.dtype}, {gate_vals.dtype}")
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, d), one token a row, got {tuple(x.shape)}")
    B, _, d = x.shape
    E, _, d_e = w_gate.shape
    K = gate_idx.shape[-1]
    if (gate_idx.shape != (B, 1, K) or gate_vals.shape != (B, 1, K)
            or w_gate.shape != (E, d, d_e) or w_up.shape != (E, d, d_e)
            or w_down.shape != (E, d_e, d)):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, gate_idx "
                         f"{tuple(gate_idx.shape)}, gate_vals {tuple(gate_vals.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    vec = 16 // x.element_size()
    if not 1 <= K <= min(E, MAX_TOP_K) or d > MAX_D or d % vec or d_e % vec:
        raise ValueError(f"moe_decode kernel takes 1 to {MAX_TOP_K} choices of the experts, d "
                         f"up to {MAX_D}, and d and d_e in whole 16-byte vectors; got K {K}, "
                         f"E {E}, d {d}, d_e {d_e}")
    weights = (w_gate, w_up, w_down)
    if not all(w.is_contiguous() and w.data_ptr() % 16 == 0 for w in weights):
        raise ValueError("moe_decode kernel takes contiguous, 16-byte aligned expert weights")
    x, idx, vals = x.contiguous(), gate_idx.contiguous(), gate_vals.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tpr_up, tpr_down, splits = plan(B, K, d, d_e, x.element_size(), sms)
    act = torch.empty((B * K, d_e), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, B, d), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    y = torch.empty((B, 1, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.kernel("moe_decode")(
            x.data_ptr(), idx.data_ptr(), vals.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), act.data_ptr(), None if part is None else part.data_ptr(),
            y.data_ptr(), B, K, d, d_e, E, _build.DTYPES[x.dtype], tpr_up, tpr_down, splits,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("moe_decode", err)
    return y
