"""The Mamba2 and attention hybrid whose every mixer is followed by a mixture
of experts: IBM's Granite 4.0 H (Hugging Face ``granitemoehybrid``; the
``hybrid_moe`` family).

Layer ``i`` is a Mamba2 block or a GQA attention block, as
``cfg.layer_types[i]`` says (the first ``n_layers`` entries are used), and
each layer owns its weights. Every mixer is followed by an MoE FFN with its
shared SwiGLU (:class:`~repro_torch.models.moe.MoE` with ``n_shared``). With
``r = cfg.residual_multiplier``::

    x = embed(tokens) * cfg.embedding_multiplier
    x = x + r * mixer_i(rms_norm(x))                 # for each layer i
    x = x + r * (moe(rms_norm(x)) + shared(rms_norm(x)))
    logits = rms_norm(x) @ embed.T / cfg.logits_scaling

A multiplier of 1 adds no operation. Attention has no positional encoding
(Granite 4.0 H's ``position_embedding_type`` is ``"nope"``) and no sliding
window, and takes its softmax scale from ``cfg.attention_multiplier`` (0:
1/sqrt(head_dim)). The Mamba2 mixer is
zamba2's (:mod:`repro_torch.models.hybrid`: the packed in-projection [x, z,
B, C, dt], the causal conv, the SSD scan, the gated norm), with its own head
size ``cfg.ssm.head_dim``.

On the card each Mamba2 layer's prefill runs the SSD kernel once, each
attention layer's prefill the flash-attention kernel and each of its decode
steps the decode-attention kernel; the MoE FFN is plain PyTorch ops (the
dense dispatch of :mod:`repro_torch.models.moe`: a decode step computes all
the experts at 4 slots). The cache is a flat dict written in place: ``h``
(Mamba2 layers, B, H, N, P) f32, ``conv`` (Mamba2 layers, B, d_conv - 1,
conv_dim), ``attn_k``/``attn_v`` (attention layers, B, K, rows, hd) and
``lengths``. Prefill starts every Mamba2 layer from a zero state.

Not placed on a mesh: ``launch.shardings`` has no specs for this family.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import trace
from ..configs.base import ArchConfig
from . import moe
from .attention import Attention, decode_attention_step, prefill_attention, store_prefill_kv
from .hybrid import MambaBlock, _dims, mamba_mixer, mamba_mixer_step
from .layers import cross_entropy, embed, normal_init, parameter, remat as _remat, rms_norm

KINDS = ("mamba", "attention")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Each layer's mixer, from ``cfg.layer_types``."""
    kinds = list(cfg.layer_types[:cfg.n_layers])
    if len(kinds) < cfg.n_layers or not set(kinds) <= set(KINDS):
        raise ValueError(f"layer_types must give one of {KINDS} for each of the "
                         f"{cfg.n_layers} layers, got {cfg.layer_types}")
    return kinds


class Layer(nn.Module):
    """One layer's weights: ``mamba`` (a Mamba2 block, whose ``ln`` is the
    mixer's norm) or ``ln1`` and ``attn``; then ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, kind: str, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.kind = kind
        if kind == "mamba":
            self.mamba = MambaBlock(cfg, device)
        else:
            self.ln1 = parameter((cfg.d_model,), dt, device)
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.qk_norm, dt, device)
        self.ln2 = parameter((cfg.d_model,), dt, device)
        self.mlp = moe.MoE(cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        if self.kind == "mamba":
            self.mamba.init(generator)
        else:
            self.ln1.fill_(1.0)
            self.attn.init(generator)
        self.ln2.fill_(1.0)
        self.mlp.init(generator)


class GraniteHybrid(nn.Module):
    """The parameters of one model: ``embed`` (tied to the logits),
    ``layers`` and ``final_norm``."""

    tp = None  # never placed on a mesh

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = parameter((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(Layer(cfg, k, device) for k in layer_kinds(cfg))
        self.final_norm = parameter((cfg.d_model,), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GraniteHybrid":
        """Each block's own scales, and the embedding's at 0.02 after
        ``embedding_multiplier``: with tied logits a larger one lets the fed
        token's own row decide them."""
        cfg = self.cfg
        self.embed.copy_(normal_init((cfg.vocab, cfg.d_model), 0.02 / cfg.embedding_multiplier,
                                     self.embed.dtype, generator))
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.fill_(1.0)
        return self


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    return x if m == 1.0 else x * m


def _attend_kw(cfg: ArchConfig) -> dict:
    return dict(rope_theta=cfg.rope_theta, eps=cfg.norm_eps, use_rope=False,
                sm_scale=cfg.attention_multiplier or None)


def _ffn(cfg: ArchConfig, p: Layer, x: torch.Tensor) -> torch.Tensor:
    with trace.scope("ffn"):
        return x + _scaled(p.mlp(rms_norm(x, p.ln2, cfg.norm_eps)), cfg.residual_multiplier)


def _embed(cfg: ArchConfig, params: GraniteHybrid, tokens: torch.Tensor) -> torch.Tensor:
    return _scaled(embed(params.embed, tokens), cfg.embedding_multiplier)


def _logits(cfg: ArchConfig, params: GraniteHybrid, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.embed.T
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _mixer_prefill(cfg: ArchConfig, p: Layer, x, positions):
    """(the mixer's output over the sequence, its state: (h, conv ctx) or
    (k, v))."""
    if p.kind == "mamba":
        return mamba_mixer(cfg, p.mamba, x)
    return prefill_attention(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), positions, causal=True,
                             **_attend_kw(cfg))


def forward(cfg: ArchConfig, params: GraniteHybrid, tokens: torch.Tensor, *,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass over ``tokens`` (B, S). Returns (logits (B, S, V),
    the routers' summed aux loss as a 0-dim f32 tensor). ``remat``
    recomputes each layer in the backward."""
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params.layers:

        def body(x, p=p):
            x = x + _scaled(_mixer_prefill(cfg, p, x, positions)[0], cfg.residual_multiplier)
            y, layer_aux = moe.apply_moe(cfg, p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))
            return x + _scaled(y, cfg.residual_multiplier), layer_aux

        x, layer_aux = _remat(body, x) if remat else body(x)
        aux = aux + layer_aux
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params: GraniteHybrid, batch, *, remat: bool = True):
    """batch: {"tokens", "labels"} (B, S). Returns (ce + aux, {"ce", "nll",
    "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat)
    ce, nll = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _slots(cfg: ArchConfig) -> list[int]:
    """Each layer's index among the layers of its kind: its entry of
    ``h``/``conv`` or of ``attn_k``/``attn_v``."""
    seen = {k: 0 for k in KINDS}
    out = []
    for kind in layer_kinds(cfg):
        out.append(seen[kind])
        seen[kind] += 1
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device) -> dict[str, torch.Tensor]:
    """SSD states and conv contexts of the Mamba2 layers, and K/V of
    ``max_len`` rows of the attention layers (an empty stack where there
    are none, so the cache always has rows)."""
    kinds = layer_kinds(cfg)
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    d_inner, H, P, N = _dims(cfg)
    kv = (n_attn, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "h": torch.zeros((n_mamba, batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_mamba, batch, cfg.ssm.d_conv - 1, d_inner + 2 * N),
                            dtype=cfg.torch_dtype, device=device),
        "attn_k": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: ArchConfig, params: GraniteHybrid, tokens: torch.Tensor, cache):
    """Run the prompt from a zero state, writing each Mamba2 layer's SSD
    state and conv context and each attention layer's K/V rows into the
    cache in place. Returns (last-token logits (B, 1, V), cache). A prompt
    longer than the cache raises ValueError."""
    B, S = tokens.shape
    S_c = cache["attn_k"].shape[3]
    if S > S_c:
        raise ValueError(f"prompt of {S} tokens is longer than the cache's {S_c} rows")
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for p, i in zip(params.layers, _slots(cfg)):
        with trace.scope("mamba2" if p.kind == "mamba" else "attention"):
            y, state = _mixer_prefill(cfg, p, x, positions)
            if p.kind == "mamba":
                cache["h"][i].copy_(state[0])
                cache["conv"][i].copy_(state[1])
            else:
                k, v = state
                store_prefill_kv(cache["attn_k"][i], k, None)
                store_prefill_kv(cache["attn_v"][i], v, None)
        x = _ffn(cfg, p, x + _scaled(y, cfg.residual_multiplier))
    with trace.scope("logits"):
        logits = _logits(cfg, params, x[:, -1:])
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg: ArchConfig, params: GraniteHybrid, cache, tokens: torch.Tensor):
    """One greedy decode step. tokens: (B, 1) int32, the current token.
    Returns (logits (B, 1, V), cache updated in place)."""
    x = _embed(cfg, params, tokens)
    lengths = cache["lengths"]
    r = cfg.residual_multiplier
    for p, i in zip(params.layers, _slots(cfg)):
        if p.kind == "mamba":
            with trace.scope("mamba2"):
                y, (h, ctx) = mamba_mixer_step(cfg, p.mamba, x, (cache["h"][i], cache["conv"][i]))
                cache["h"][i].copy_(h)
                cache["conv"][i].copy_(ctx)
        else:
            with trace.scope("attention"):
                y = decode_attention_step(p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                                          cache["attn_k"][i], cache["attn_v"][i], lengths,
                                          **_attend_kw(cfg))
        x = _ffn(cfg, p, x + _scaled(y, r))
    with trace.scope("logits"):
        logits = _logits(cfg, params, x)
    lengths.add_(1)
    return logits, cache

