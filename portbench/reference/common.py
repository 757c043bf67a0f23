"""Plain float32 building blocks of the benchmark's references.

Written from the layer equations of the served architectures, with no
kernel, cache or batching, and importing nothing of the program. Every
weight product goes through :class:`Precision`, so the same code computes
the reference (float32, TF32 off), its control (each bfloat16 weight
product of the served model taken in float8 e4m3 instead, with a scale a
row of the activations and a column of the weights), and a witness in the
served precision (the operands of each weight product rounded to bfloat16,
the product summed in float32). Products that the served model computes
in float32 (the MoE router, the SSD scan) stay in float32 in all three.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_NEG = -1e30
_E4M3_MAX = 448.0


class Precision:
    """How weight products are computed: ``"f32"``, ``"bf16"`` or ``"fp8"``."""

    def __init__(self, mode: str = "f32") -> None:
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision must be 'f32', 'bf16' or 'fp8', got {mode!r}")
        self.mode = mode

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for activations ``a`` (..., k) and weights ``w`` (k, n)."""
        if self.mode == "bf16":
            a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
        a, w = a.float(), w.float()
        if self.mode == "fp8":
            a = _fp8(a, dim=-1)
            w = _fp8(w, dim=0)
        return a @ w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def served_sequence(prompt: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """The tokens whose logits at positions ``len(prompt)..`` chose the
    ``served`` tokens: the server prefills the prompt, then decodes from its
    last token again, so that token comes twice."""
    return torch.cat([prompt, prompt[-1:], served[:-1]])


def no_tf32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (S, heads, hd) at positions 0..S-1, the
    two halves of each head rotated as a pair."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(prec: Precision, x: torch.Tensor, wq, wk, wv, wo, *, theta: float,
              window: int | None, block: int = 1024) -> torch.Tensor:
    """Causal GQA self-attention of ``x`` (S, d), optionally within a
    sliding ``window``; queries in blocks of ``block`` rows so that the
    scores fit. ``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd), ``wo`` (H, hd, d)."""
    S, d = x.shape
    _, H, hd = wq.shape
    K = wk.shape[1]
    q = rope(prec.mm(x, wq.reshape(d, H * hd)).reshape(S, H, hd), theta)
    k = rope(prec.mm(x, wk.reshape(d, K * hd)).reshape(S, K, hd), theta)
    v = prec.mm(x, wv.reshape(d, K * hd)).reshape(S, K, hd)
    g = H // K
    qg = q.reshape(S, K, g, hd)
    kpos = torch.arange(S, device=x.device)
    out = torch.empty((S, H, hd), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = torch.einsum("qkgd,skd->kgqs", qg[s0:s1], k) / math.sqrt(hd)
        qpos = torch.arange(s0, s1, device=x.device)[:, None]
        mask = kpos[None, :] <= qpos
        if window is not None:
            mask &= qpos - kpos[None, :] < window
        p = torch.softmax(sc.masked_fill(~mask, _NEG), dim=-1)
        out[s0:s1] = torch.einsum("kgqs,skd->qkgd", p, v).reshape(s1 - s0, H, hd)
    return prec.mm(out.reshape(S, H * hd), wo.reshape(H * hd, d))


def swiglu(prec: Precision, x, w_gate, w_up, w_down) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a switch to the identity for large x."""
    return torch.logaddexp(x, x.new_zeros(()))
