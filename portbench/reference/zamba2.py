"""Plain float32 forward pass of the hybrid model (zamba2-1.2b's layout as
served): a backbone of Mamba2 blocks, and ONE shared transformer block
(sliding-window GQA attention with rotary positions, then a SwiGLU) whose
weights are applied again after every ``hybrid_attn_every`` Mamba2 blocks.
The per-application LoRA deltas of the published model are not part of the
served model, and not of this reference.

A Mamba2 block: ``u = rms_norm(x) @ w_in`` packs [x (d_inner), z
(d_inner), B (N), C (N), dt (H)]; a depthwise causal conv of width
``d_conv`` (with bias, then SiLU) runs over [x, B, C]; the SSD recurrence
per head ``h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t h_t +
D x_t`` with ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)`` and head
size P = N; then ``rms_norm(y * silu(z)) @ w_out`` is added to the residual.
The scan is computed in chunks of ``chunk`` positions (dense products inside
a chunk, the state carried between chunks), all in float32.

As in :mod:`.granite`, the served sequence is ``prompt + [prompt[-1]] +
served[:-1]`` (:func:`.common.served_sequence`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, attention, rms_norm, softplus, swiglu

_NEG = -1e30


def ssd(x, dt, A, Bm, Cm, D, chunk: int) -> torch.Tensor:
    """x (S, H, P), dt (S, H), A (H,), Bm/Cm (S, N), D (H,) -> y (S, H, P)."""
    S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:  # dt = 0 keeps the state and adds nothing
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nC = (S + pad) // L
    csum = torch.cumsum((dt * A).reshape(nC, L, H), dim=1)
    xdt = (x * dt[..., None]).reshape(nC, L, H, P)
    Bc, Cc = Bm.reshape(nC, L, N), Cm.reshape(nC, L, N)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[:, :, None]
    h = torch.zeros((H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nC):
        cs = csum[c]
        dec = torch.exp(torch.where(mask, cs[:, None, :] - cs[None, :, :], _NEG))
        scores = (Cc[c] @ Bc[c].T)[..., None] * dec                      # (L, L, H)
        y = torch.einsum("ijh,jhp->ihp", scores, xdt[c])
        y = y + torch.einsum("in,hnp->ihp", Cc[c], h) * torch.exp(cs)[..., None]
        tail = torch.exp(cs[-1:] - cs)                                     # (L, H)
        h = h * torch.exp(cs[-1])[:, None, None] + torch.einsum("jn,jh,jhp->hnp", Bc[c], tail,
                                                                 xdt[c])
        ys.append(y)
    y = torch.cat(ys)[:S] + x[:S] * D[None, :, None]
    return y


def mamba(prec: Precision, cfg: dict, W: dict, pre: str, x: torch.Tensor) -> torch.Tensor:
    ssm = cfg["ssm"]
    d_inner, N, K = ssm["expand"] * cfg["d_model"], ssm["d_state"], ssm["d_conv"]
    P = N
    H = d_inner // P
    S = x.shape[0]
    u = prec.mm(rms_norm(x, W[pre + "ln"], cfg["norm_eps"]), W[pre + "w_in"])
    xs, z, Bm, Cm, dt = torch.split(u, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    full = torch.cat([conv_in.new_zeros((K - 1, conv_in.shape[1])), conv_in])
    w = W[pre + "conv_w"].float()
    conv = sum(full[i:i + S] * w[i] for i in range(K)) + W[pre + "conv_b"].float()
    xs, Bm, Cm = torch.split(F.silu(conv), [d_inner, N, N], dim=-1)
    dt = softplus(dt + W[pre + "dt_bias"].float())
    A = -torch.exp(W[pre + "A_log"].float())
    y = ssd(xs.reshape(S, H, P), dt, A, Bm, Cm, W[pre + "D"].float(), ssm["chunk"])
    y = rms_norm(y.reshape(S, d_inner) * F.silu(z), W[pre + "ynorm"], cfg["norm_eps"])
    return x + prec.mm(y, W[pre + "w_out"])


def shared_block(prec: Precision, cfg: dict, W: dict, x: torch.Tensor) -> torch.Tensor:
    eps, a = cfg["norm_eps"], "shared_attn.attn."
    x = x + attention(prec, rms_norm(x, W["shared_attn.ln1"], eps), W[a + "wq"], W[a + "wk"],
                      W[a + "wv"], W[a + "wo"], theta=cfg["rope_theta"],
                      window=cfg.get("sliding_window"))
    m = "shared_attn.mlp."
    return x + swiglu(prec, rms_norm(x, W["shared_attn.ln2"], eps), W[m + "w_gate"],
                      W[m + "w_up"], W[m + "w_down"])


@torch.no_grad()
def logits(cfg: dict, W: dict, tokens: torch.Tensor, prefill_len: int,
           prec: Precision | None = None) -> torch.Tensor:
    """Logits (S, V) in float32 of ``tokens`` (S,). ``prefill_len`` is
    unused (no layer of this model depends on where the prompt ended); it
    keeps the references' signature one."""
    prec = prec or Precision()
    every, L = cfg["hybrid_attn_every"], cfg["n_layers"]
    x = W["embed"][tokens.long()].float()
    for li in range(L):
        x = mamba(prec, cfg, W, f"mamba.{li}.", x)
        # the shared block follows each whole group of `every` blocks
        if every and (li + 1) % every == 0:
            x = shared_block(prec, cfg, W, x)
    x = rms_norm(x, W["final_norm"], cfg["norm_eps"])
    return prec.mm(x, W["unembed"])
