"""Plain float32 forward pass of the Mamba2 and attention hybrid with an MoE
FFN after every mixer (granite-4.0-h-small's layout, Hugging Face
``granitemoehybrid``), written from its layer equations.

Layer ``i`` mixes with a Mamba2 block or a GQA attention block, as
``cfg["layer_types"][i]`` says (the first ``n_layers`` entries), each with
its own weights, and every mixer is followed by a token-choice top-k mixture
of SwiGLU experts plus one shared SwiGLU. With ``r`` the residual multiplier::

    x = embed[tokens] * embedding_multiplier
    x = x + r * mixer_i(rms_norm(x))
    x = x + r * (moe(rms_norm(x)) + shared(rms_norm(x)))
    logits = rms_norm(x) @ embed.T / logits_scaling

* Attention: no positional encoding where ``position_embedding_type`` is
  ``"nope"`` (rotary positions at ``rope_theta`` otherwise), softmax scale
  ``attention_multiplier``, causal, within ``sliding_window`` where one is
  set (no cell sets one).
* Mamba2: ``u = rms_norm(x) @ w_in`` packs [x (d_inner), z (d_inner), B (N),
  C (N), dt (H)] with H = d_inner / P heads of ``ssm["head_dim"]`` (P); a
  depthwise causal conv of width ``d_conv`` with bias, then SiLU, over [x, B,
  C]; the SSD recurrence of :func:`.zamba2.ssd` in chunks of ``chunk``; then
  ``rms_norm(y * silu(z)) @ w_out``. One group of B and C.
* MoE: :func:`.granite.moe` (router in f32, top-k of the softmax
  renormalised, which is the softmax over the top-k logits; the prefill's
  expert capacity), plus the shared SwiGLU.

Departures from the published model, the served program's:

* expert capacity: in the prefill each expert takes at most ``C = max(4,
  int(S * top_k * capacity_factor / n_experts))`` (token, choice) pairs and
  the pairs past it are dropped (:mod:`.granite` says how); the published
  model drops none;
* the shared MLP is one SwiGLU of width ``n_shared * d_expert`` (2 x 768,
  the published ``shared_intermediate_size`` 1536);
* the in-projection is packed in the order [x, z, B, C, dt] (the published
  one is [z, x, B, C, dt]): with random weights the two are the same model;
* random weights from the seed, not the checkpoint.

As in :mod:`.granite`, the served sequence is ``prompt + [prompt[-1]] +
served[:-1]`` (:func:`.common.served_sequence`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, rms_norm, rope, softplus, swiglu
from .granite import moe
from .zamba2 import ssd

_NEG = -1e30


def attention(prec: Precision, cfg: dict, W: dict, pre: str, x: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal GQA self-attention of ``x`` (S, d) with the configuration's
    positions, softmax scale and window; queries in blocks of ``block``."""
    S, d = x.shape
    wq, wk, wv, wo = (W[pre + n] for n in ("wq", "wk", "wv", "wo"))
    _, H, hd = wq.shape
    K = wk.shape[1]
    q = prec.mm(x, wq.reshape(d, H * hd)).reshape(S, H, hd)
    k = prec.mm(x, wk.reshape(d, K * hd)).reshape(S, K, hd)
    v = prec.mm(x, wv.reshape(d, K * hd)).reshape(S, K, hd)
    if cfg.get("position_embedding_type", "rope") == "rope":
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    scale = cfg.get("attention_multiplier") or hd ** -0.5
    window = cfg.get("sliding_window")
    qg = q.reshape(S, K, H // K, hd)
    kpos = torch.arange(S, device=x.device)
    out = torch.empty((S, H, hd), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = torch.einsum("qkgd,skd->kgqs", qg[s0:s1], k) * scale
        qpos = torch.arange(s0, s1, device=x.device)[:, None]
        mask = kpos[None, :] <= qpos
        if window is not None:
            mask &= qpos - kpos[None, :] < window
        p = torch.softmax(sc.masked_fill(~mask, _NEG), dim=-1)
        out[s0:s1] = torch.einsum("kgqs,skd->qkgd", p, v).reshape(s1 - s0, H, hd)
    return prec.mm(out.reshape(S, H * hd), wo.reshape(H * hd, d))


def mamba(prec: Precision, cfg: dict, W: dict, pre: str, x: torch.Tensor) -> torch.Tensor:
    """The Mamba2 mixer's output for ``x`` (S, d), already normalised."""
    s = cfg["ssm"]
    d_inner, N, K = s["expand"] * cfg["d_model"], s["d_state"], s["d_conv"]
    P = s.get("head_dim") or N
    H = d_inner // P
    S = x.shape[0]
    u = prec.mm(x, W[pre + "w_in"])
    xs, z, Bm, Cm, dt = torch.split(u, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    full = torch.cat([conv_in.new_zeros((K - 1, conv_in.shape[1])), conv_in])
    w = W[pre + "conv_w"].float()
    conv = sum(full[i:i + S] * w[i] for i in range(K)) + W[pre + "conv_b"].float()
    xs, Bm, Cm = torch.split(F.silu(conv), [d_inner, N, N], dim=-1)
    dt = softplus(dt + W[pre + "dt_bias"].float())
    A = -torch.exp(W[pre + "A_log"].float())
    y = ssd(xs.reshape(S, H, P), dt, A, Bm, Cm, W[pre + "D"].float(), s["chunk"])
    y = rms_norm(y.reshape(S, d_inner) * F.silu(z), W[pre + "ynorm"], cfg["norm_eps"])
    return prec.mm(y, W[pre + "w_out"])


@torch.no_grad()
def logits(cfg: dict, W: dict, tokens: torch.Tensor, prefill_len: int,
           prec: Precision | None = None) -> torch.Tensor:
    """Logits (S, V) in float32 of ``tokens`` (S,), whose first
    ``prefill_len`` positions were the served prompt."""
    prec = prec or Precision()
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    x = W["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"][:cfg["n_layers"]]):
        pre = f"layers.{i}."
        if kind == "mamba":
            m = pre + "mamba."
            y = mamba(prec, cfg, W, m, rms_norm(x, W[m + "ln"], eps))
        else:
            y = attention(prec, cfg, W, pre + "attn.", rms_norm(x, W[pre + "ln1"], eps))
        x = x + r * y
        h = rms_norm(x, W[pre + "ln2"], eps)
        sh = pre + "mlp.shared."
        y = moe(prec, cfg, W, pre + "mlp.", h, prefill_len) + swiglu(
            prec, h, W[sh + "w_gate"], W[sh + "w_up"], W[sh + "w_down"])
        x = x + r * y
    x = rms_norm(x, W["final_norm"], eps)
    return prec.mm(x, W["embed"].T) / cfg["logits_scaling"]
