"""Plain PyTorch versions of the kernels.

They compute what ``repro.kernels.ref`` computes (the MoE's queue positions
and its dense dispatch: what ``repro.models.moe`` computes inline): the
ground truth the CUDA kernels are held against (``chip_smoke.py``,
``tests/test_torch_kernels.py``) and the path :mod:`repro_torch.kernels.ops`
takes for a tensor on the CPU. The MoE's prefill and training run the dense
dispatch's masks and expert GEMMs from here too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B accumulated in f32, returned in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def attention_ref(
    q: torch.Tensor,  # (batch, q_heads, q_seq, d)
    k: torch.Tensor,  # (batch, kv_heads, kv_seq, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    lengths: Optional[torch.Tensor] = None,  # (batch,) valid kv prefix
    window: Optional[int] = None,  # sliding-window size (None = full)
) -> torch.Tensor:
    """GQA attention. Grouped einsum, so the KV repeat is never
    materialised; f32 scores, masked to -1e30, causal mask aligned at the
    ends (q_pos = i + kv_seq - q_seq)."""
    batch, q_heads, q_seq, d = q.shape
    _, kv_heads, kv_seq, _ = k.shape
    group = q_heads // kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(batch, kv_heads, group, q_seq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * sm_scale
    q_pos = torch.arange(q_seq, device=q.device)[:, None] + (kv_seq - q_seq)
    k_pos = torch.arange(kv_seq, device=q.device)[None, :]
    mask = torch.ones((q_seq, kv_seq), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, _NEG)
    if lengths is not None:
        valid = k_pos < lengths.to(q.device)[:, None, None]  # (batch, 1, kv_seq)
        s = s.masked_fill(~valid[:, None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(batch, q_heads, q_seq, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # (batch, q_heads, 1, d)
    k_cache: torch.Tensor,  # (batch, kv_heads, S, d)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (batch,)
    *,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """With ``return_lse`` also each head's log-sum-exp of the scaled scores
    over its valid prefix, (batch, q_heads) f32, ``-inf`` at length 0: the
    pair the kernel's log-sum-exp form returns."""
    out = attention_ref(
        q, k_cache, v_cache, causal=False, sm_scale=sm_scale, lengths=lengths
    )
    if not return_lse:
        return out
    batch, q_heads, _, d = q.shape
    kv_heads, s_len = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(batch, kv_heads, q_heads // kv_heads, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * sm_scale
    valid = torch.arange(s_len, device=q.device) < lengths.to(q.device)[:, None]  # (batch, S)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    return out, torch.logsumexp(s, dim=-1).reshape(batch, q_heads)


def moe_positions_ref(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, choice) pair's 0-based position in its expert's queue in
    its own row b, pairs counted in (s, k) row-major order, unclipped: the
    cumsum form of ``repro.models.moe.apply_moe`` (the f32 one-hot of every
    pair summed down the row's S·K pairs, exact below 2**24 pairs). (B, S, K)
    int32; a pair whose index lies outside [0, n_experts) gets 0."""
    B, S, K = gate_idx.shape
    onehot = one_hot(gate_idx, n_experts)
    pos_in_e = torch.cumsum(onehot.reshape(B, S * K, n_experts), dim=1).reshape(onehot.shape)
    pos_in_e = (pos_in_e - 1.0) * onehot                               # 0-based, only where routed
    return torch.sum(pos_in_e * onehot, dim=-1).to(torch.int32)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a row of zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` would
    raise there: a dropped pair's queue position is ``>= C``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_masks(gate_vals: torch.Tensor, gate_idx: torch.Tensor, pos: torch.Tensor,
              n_experts: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch's (B, S, E, C) f32 dispatch mask (1 where token s
    takes slot c of expert e) and combine weights (its gate value there),
    from the router's choices (B, S, K) and their queue positions; a pair at
    a position ``>= capacity`` is dropped."""
    routed = one_hot(gate_idx, n_experts) * (pos < capacity)[..., None]  # (B, S, K, E)
    cap_oh = one_hot(pos, capacity)                                    # (B, S, K, C), 0 past C
    dispatch = torch.einsum("bske,bskc->bsec", routed, cap_oh)
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, routed, cap_oh)
    return dispatch, combine


def moe_slots(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its C slots, combined back: (B, S, d)."""
    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)       # (B, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    ye = torch.einsum("becf,efd->becd", F.silu(h) * u, w_down)         # (B, E, C, d)
    return torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)


def moe_experts_ref(x: torch.Tensor, gate_idx: torch.Tensor, gate_vals: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """The experts' output by the dense dispatch at ``capacity`` slots an
    expert, the queue positions in their cumsum form: the plain version of
    the MoE decode kernel. At one token a row it drops no pair (a token's
    top-k experts are distinct), so it equals Σ_k g_k · SwiGLU_{e_k}(x)."""
    E = w_gate.shape[0]
    dispatch, combine = moe_masks(gate_vals, gate_idx, moe_positions_ref(gate_idx, E), E,
                                  capacity)
    return moe_slots(x, dispatch, combine, w_gate, w_up, w_down)
