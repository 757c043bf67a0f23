"""Recurrent sequence mixers, the port of ``repro.models.ssm``: Mamba2's SSD
(arXiv:2405.21060, as Zamba2 uses it) and xLSTM's mLSTM and sLSTM cells
(arXiv:2405.04517), as plain functions on tensors.

The chunked formulation of DESIGN.md §2 is kept: inside a chunk of ``L``
positions the recurrence is dense (L x L) products, and a loop over the
``nC`` chunks carries the state across them (``repro``'s ``lax.scan``).
``nC`` is fixed by the shape, so the loop is captured whole in a CUDA graph.
Every product of the scans runs in f32, as ``repro``'s ``.astype(float32)``
does, and masks are applied before ``exp`` (``-1e30``), as there. The
reference has no kernel here (nothing reaches ``pl.pallas_call``), so the
port computes in plain PyTorch ops.

``softplus`` is ``logaddexp(x, 0)``, which is what ``jax.nn.softplus``
computes; ``torch.nn.functional.softplus`` switches to the identity above 20.

Under a count that counts a scan once (``roofline.count.count(...,
scan_once=True)``, the dry-run) each loop over chunks or tokens runs one
step, counted as many times as the loop has steps, its backward too
(``repro``'s counter counts a while loop's body times its trip count); the
values are then not the scan's.

All cells expose:
  *_chunked     — full-sequence (prefill) form
  *_step        — single-token decode form
and ``slstm_scan``, the sLSTM's sequential scan (prefill and decode alike).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..roofline.count import scans_once, step_counted

_NEG = -1e30


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _tril(L: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Mamba2 SSD: H_t = a_t · H_{t-1} + B_t ⊗ (Δ_t x_t);  y_t = C_t·H_t + D·x_t
#   a_t = exp(Δ_t · A) with A < 0 scalar per head (scalar-identity SSD).
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,    # (B, S, H, P)  inputs (Δ not applied)
    dt: torch.Tensor,   # (B, S, H)     Δ_t (positive), f32
    A: torch.Tensor,    # (H,)          negative decay rates
    Bm: torch.Tensor,   # (B, S, N)     input maps (shared across heads, 1 group)
    Cm: torch.Tensor,   # (B, S, N)
    D: torch.Tensor,    # (H,)          skip connection
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P) initial state
):
    """Chunked SSD scan. Returns (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # padding is a no-op: dt=0 -> decay exp(0)=1 (state kept), input 0
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    S_orig, S = S, S + pad
    nC = S // L

    loga = dt * A[None, None, :]                       # (B, S, H) log decay, <=0
    xdt = x * dt[..., None]                            # Δ_t x_t, f32
    loga_c = loga.reshape(Bsz, nC, L, H)
    xdt_c = xdt.reshape(Bsz, nC, L, H, P).float()
    B_c = Bm.reshape(Bsz, nC, L, N).float()
    C_c = Cm.reshape(Bsz, nC, L, N).float()
    csum = torch.cumsum(loga_c, dim=2)                 # (B, nC, L, H) inclusive
    mask = _tril(L, x.device)[None, :, :, None]

    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device) if h0 is None else h0

    def step(csum_i, x_i, B_i, C_i, h):
        # intra-chunk scores: S_ij = (C_i · B_j) * exp(csum_i - csum_j), j <= i;
        # masked before exp, as the reference masks it
        gap = csum_i[:, :, None, :] - csum_i[:, None, :, :]   # (B, L, L, H)
        dec = torch.exp(torch.where(mask, gap, _NEG))
        cb = torch.einsum("bin,bjn->bij", C_i, B_i)
        scores = cb[..., None] * dec                    # (B, L, L, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, x_i)
        # inter-chunk: y_i += C_i · (exp(csum_i) * H_prev)
        y_inter = torch.einsum("bin,bhnp->bihp", C_i, h) * torch.exp(csum_i)[..., None]
        # state update: H_new = exp(csum_L) H_prev + sum_j exp(csum_L - csum_j) B_j x_j
        tail = torch.exp(csum_i[:, -1:, :] - csum_i)    # (B, L, H)
        h_new = h * torch.exp(csum_i[:, -1])[..., None, None]
        h = h_new + torch.einsum("bjn,bjh,bjhp->bhnp", B_i, tail, x_i)
        return y_intra + y_inter, h

    # the chunks as views (one stack in the backward, where per-chunk
    # indexing would write a zero tensor of the whole input a chunk)
    chunks = [t.unbind(1) for t in (csum, xdt_c, B_c, C_c)]
    once = nC > 1 and scans_once()
    ys = []
    for c in range(1 if once else nC):
        args = tuple(t[c] for t in chunks) + (h,)
        y_c, h = step_counted(step, nC, *args) if once else step(*args)
        ys.append(y_c)
    y = torch.stack(ys * nC if once else ys, dim=1).reshape(Bsz, S, H, P)
    y = y + x.float() * D[None, None, :, None]
    return y[:, :S_orig].to(x.dtype), h


def ssd_step(
    x: torch.Tensor,    # (B, H, P) one token (Δ not applied)
    dt: torch.Tensor,   # (B, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, N)
    Cm: torch.Tensor,   # (B, N)
    D: torch.Tensor,    # (H,)
    h: torch.Tensor,    # (B, H, N, P) state
):
    """Single-token SSD recurrence (decode). Returns (y (B,H,P), new h)."""
    a = torch.exp(dt * A[None, :])                     # (B, H)
    xdt = (x * dt[..., None]).float()
    h = h * a[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm.float(), xdt)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + x.float() * D[None, :, None]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory C_t (P_k x P_v per head), exp input gating
# with max-stabilizer m; the chunked form carries (C, n, m).
# ---------------------------------------------------------------------------


def mlstm_init_state(Bsz: int, H: int, P: int, device) -> tuple[torch.Tensor, ...]:
    """(C, n, m) of a fresh mLSTM: zeros, and -1e30 for the stabilizer."""
    return (torch.zeros((Bsz, H, P, P), dtype=torch.float32, device=device),
            torch.zeros((Bsz, H, P), dtype=torch.float32, device=device),
            torch.full((Bsz, H), _NEG, dtype=torch.float32, device=device))


def mlstm_chunked(
    q: torch.Tensor,   # (B, S, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, H) pre-activation (exp gate)
    f_gate: torch.Tensor,  # (B, S, H) pre-activation (sigmoid gate)
    *,
    chunk: int,
    state: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """Returns (h (B,S,H,P) in q's dtype, (C, n, m) final state, f32).

    State convention: stored C/n are scaled by exp(-m) (m is the running
    log-stabilizer), i.e. C_true = C_stored * exp(m)."""
    Bsz, S, H, P = q.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # padding is a no-op: i_gate -> -1e30 (no input), f_gate -> 60
        # (forget gate 1: state kept)
        pad4 = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, pad4) for t in (q, k, v))
        i_gate = torch.nn.functional.pad(i_gate, (0, 0, 0, pad), value=_NEG)
        f_gate = torch.nn.functional.pad(f_gate, (0, 0, 0, pad), value=60.0)
    S_orig, S = S, S + pad
    nC = S // L
    scale = P**-0.5

    logf = -softplus(-f_gate.float())                 # log sigmoid(f)
    q_c, k_c, v_c = (t.reshape(Bsz, nC, L, H, P).float() for t in (q, k, v))
    logf_c = logf.reshape(Bsz, nC, L, H)
    i_c = i_gate.float().reshape(Bsz, nC, L, H)
    mask = _tril(L, q.device)[None, :, :, None]

    C_prev, n_prev, m_prev = mlstm_init_state(Bsz, H, P, q.device) if state is None else state

    def step(q_i, k_i, v_i, ig_i, logf_i, C_prev, n_prev, m_prev):
        b = torch.cumsum(logf_i, dim=1)                 # (B, L, H) inclusive
        # source log-gain within chunk: a_j = i_j - b_j
        a = ig_i - b
        # per-position stabilizer: m_i = max(b_i + cummax_j<=i(a_j), b_i + m_prev)
        acum = torch.cummax(a, dim=1).values
        m_pos = b + torch.maximum(acum, m_prev[:, None, :])   # (B, L, H)
        # intra scores: D_ij = exp(b_i - b_j + i_j - m_i) for j <= i
        gap = b[:, :, None, :] - b[:, None, :, :] + ig_i[:, None, :, :]  # (B,L,L,H)
        gap = gap - m_pos[:, :, None, :]
        dmat = torch.exp(torch.where(mask, gap, _NEG))  # pre-exp mask
        qk = torch.einsum("bihp,bjhp->bijh", q_i, k_i) * scale
        S_ij = qk * dmat
        num = torch.einsum("bijh,bjhp->bihp", S_ij, v_i)
        den = torch.sum(S_ij, dim=2)                    # (B, L, H)
        # inter-chunk: factor exp(b_i + m_prev - m_i)
        inter_f = torch.exp(b + m_prev[:, None, :] - m_pos)   # (B, L, H)
        qC = torch.einsum("bihp,bhpr->bihr", q_i, C_prev) * scale
        qn = torch.einsum("bihp,bhp->bih", q_i, n_prev) * scale
        num = num + qC * inter_f[..., None]
        den = den + qn * inter_f
        h_i = num / torch.maximum(torch.abs(den), torch.exp(-m_pos))[..., None]
        # ---- state update to chunk end ----
        b_L = b[:, -1, :]                               # (B, H)
        m_new = torch.maximum(b_L + m_prev, b_L + acum[:, -1, :])
        src = torch.exp(b_L[:, None, :] - b + ig_i - m_new[:, None, :])  # (B, L, H)
        decay = torch.exp(b_L + m_prev - m_new)
        C_prev = C_prev * decay[..., None, None] + torch.einsum(
            "bjhp,bjhr->bhpr", src[..., None] * k_i, v_i)
        n_prev = n_prev * decay[..., None] + torch.einsum("bjh,bjhp->bhp", src, k_i)
        return h_i, C_prev, n_prev, m_new

    chunks = [t.unbind(1) for t in (q_c, k_c, v_c, i_c, logf_c)]  # as in ssd_chunked
    once = nC > 1 and scans_once()
    hs = []
    for c in range(1 if once else nC):
        args = tuple(t[c] for t in chunks) + (C_prev, n_prev, m_prev)
        h_i, C_prev, n_prev, m_prev = step_counted(step, nC, *args) if once else step(*args)
        hs.append(h_i)
    h = torch.stack(hs * nC if once else hs, dim=1).reshape(Bsz, S, H, P)
    return h[:, :S_orig].to(q.dtype), (C_prev, n_prev, m_prev)


def mlstm_step(
    q: torch.Tensor,  # (B, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, H)
    f_gate: torch.Tensor,  # (B, H)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    *,
    reduce: Optional[Callable[[list], list]] = None,
):
    """One mLSTM recurrence step (decode). Returns (h (B,H,P), (C, n, m)).

    With ``reduce``, ``q``, ``k`` and the state's ``C`` (B, H, P_k, P) and
    ``n`` are one block of the key axis P_k (a tensor-parallel rank's):
    ``reduce([num, den])`` sums ``q·C`` and ``q·n`` over the blocks before
    the division."""
    C, n, m = state
    P = v.shape[-1]  # the head dim (q and k may be a block of it)
    scale = P**-0.5
    logf = -softplus(-f_gate.float())
    ig = i_gate.float()
    m_new = torch.maximum(logf + m, ig)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(ig - m_new)
    kf = k.float()
    vf = v.float()
    C = C * f_s[..., None, None] + i_s[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n = n * f_s[..., None] + i_s[..., None] * kf
    qf = q.float() * scale
    num = torch.einsum("bhp,bhpr->bhr", qf, C)
    den = torch.einsum("bhp,bhp->bh", qf, n)
    if reduce is not None:
        num, den = reduce([num, den])
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with true recurrence (h_{t-1} feeds the gates), so
# inherently sequential: a loop over time. Block-diagonal recurrent matrices
# per head (the paper's design for parallelizable heads).
# ---------------------------------------------------------------------------


def slstm_init_state(Bsz: int, H: int, P: int, device) -> tuple[torch.Tensor, ...]:
    """(c, n, h, m) of a fresh sLSTM: zeros, and -1e30 for the stabilizer."""
    z = torch.zeros((Bsz, H, P), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((Bsz, H, P), _NEG, dtype=torch.float32, device=device))


def slstm_scan(
    x_gates: torch.Tensor,  # (B, S, 4, H, P) pre-activations from input (z,i,f,o)
    R: torch.Tensor,        # (4, H, P, P) recurrent block-diagonal weights
    *,
    state: Optional[tuple] = None,
):
    """Returns (h (B,S,H,P) in x_gates' dtype, final (c,n,h,m) f32). Gate
    order: z, i, f, o. ``R`` may hold a block of the output P axis (r) of
    every head, and the state's ``c``, ``n``, ``m`` that block: the step
    then reads the whole ``h`` it is given and returns the block of it."""
    Bsz, S, _, H, P = x_gates.shape
    c, n, h, m = (slstm_init_state(Bsz, H, P, x_gates.device) if state is None
                  else state)
    Rf = R.float()  # the reference casts R at every step; the values are the same
    steps = x_gates.unbind(1)  # as in ssd_chunked
    once = S > 1 and scans_once()
    hs = []
    for t in range(1 if once else S):
        args = (steps[t], Rf, c, n, h, m)
        c, n, h, m = step_counted(_slstm_step, S, *args) if once else _slstm_step(*args)
        hs.append(h)
    return torch.stack(hs * S if once else hs, dim=1).to(x_gates.dtype), (c, n, h, m)


def _slstm_step(x_gates_t, Rf, c, n, h, m):
    """One sLSTM step: the new (c, n, h, m)."""
    xg = x_gates_t.float()
    # gate pre-activations: input part + recurrent part
    rec = torch.einsum("bhp,ghpr->gbhr", h, Rf)
    zt = torch.tanh(xg[:, 0] + rec[0])
    it = xg[:, 1] + rec[1]                          # exp gate (log-space)
    ft = xg[:, 2] + rec[2]                          # sigmoid gate
    ot = torch.sigmoid(xg[:, 3] + rec[3])
    logf = -softplus(-ft)
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * zt
    n = f_s * n + i_s
    h = ot * c / torch.clamp(torch.abs(n), min=1e-6)
    return c, n, h, m_new

