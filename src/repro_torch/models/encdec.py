"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the port of
``repro.models.encdec``.

The modality frontend (mel-spectrogram + conv1d feature extractor) is the
stub ``repro`` keeps: inputs are precomputed frame embeddings (B, frames,
d_model). Downstream is the bidirectional encoder, the causal decoder with
cross-attention, and the caches for decode. RoPE replaces Whisper's absolute
embeddings and SwiGLU its GELU MLP, as in ``repro`` (DESIGN.md §8).

On the card the encoder's attention runs on the flash-attention kernel
(non-causal, one launch a layer), and each decode step runs the
decode-attention kernel twice a layer: over the decoder's own cache, which
the step writes, and over the encoder's cross K/V, which prefill stores and
decode only reads. Layers are per-layer modules, as in
:mod:`repro_torch.models.transformer`, and the caches are written in place.

Training (:func:`loss_fn`) runs the encoder and the teacher-forced decoder
(``decode_train``), each layer recomputed in the backward with ``remat`` as
``repro`` wraps both scan bodies in ``jax.checkpoint``; the decoder's
gradient reaches the encoder's output through each layer's cross K/V, the
flash-attention kernel's non-causal ``k`` and ``v``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..distributed.sharding import shard
from .attention import Attention, decode_attention_step, prefill_attention, store_prefill_kv
from .layers import (SwiGLU, cross_entropy, embed, normal_init, remat as _remat, rms_norm,
                     unembed, unembed_input)


def _norm(cfg: ArchConfig, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(cfg.d_model, dtype=cfg.torch_dtype, device=device),
                        requires_grad=False)


def _attention(cfg: ArchConfig, device: torch.device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False,
                     cfg.torch_dtype, device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.attn = _attention(cfg, device)
        self.ln2 = _norm(cfg, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.torch_dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.attn.init(generator)
        self.ln2.fill_(1.0)
        self.mlp.init(generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.self_attn = _attention(cfg, device)
        self.ln_x = _norm(cfg, device)
        self.cross_attn = _attention(cfg, device)
        self.ln2 = _norm(cfg, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.torch_dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for norm in (self.ln1, self.ln_x, self.ln2):
            norm.fill_(1.0)
        self.self_attn.init(generator)
        self.cross_attn.init(generator)
        self.mlp.init(generator)


class EncDec(nn.Module):
    """The parameters of one encoder-decoder model (``repro``'s ``params``
    dict): ``embed``, ``encoder`` layers, ``enc_norm``, ``decoder`` layers,
    ``final_norm`` and an untied ``unembed``."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=device),
                                  requires_grad=False)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.enc_norm = _norm(cfg, device)
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, device)
        self.unembed = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, dtype=dt, device=device),
                                    requires_grad=False)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDec":
        """``repro``'s scales (its values come from ``jax.random``)."""
        cfg = self.cfg
        self.embed.copy_(normal_init((cfg.vocab, cfg.d_model), 1.0, self.embed.dtype, generator))
        for layer in (*self.encoder, *self.decoder):
            layer.init(generator)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        self.unembed.copy_(normal_init((cfg.d_model, cfg.vocab), cfg.d_model**-0.5,
                                       self.unembed.dtype, generator))
        return self


def _positions(B: int, S: int, device: torch.device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(cfg: ArchConfig, params: EncDec, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, F, d_model), the stub frontend's output, cast to the
    model's dtype. Returns the normed encoder output (B, F, d_model)."""
    B, F, _ = frames.shape
    sp = sh.seq_parallel(F)
    x = shard(frames.to(cfg.torch_dtype), "batch", "seq", None)
    if sp:  # the rank's block of the frames
        x = sh.local_block(x, 1, sh.MODEL_AXIS)
    positions = _positions(B, F, x.device)
    with sh.sequence_parallel(sp):
        for p in params.encoder:

            def body(x, p=p):
                with sh.sequence_parallel(sp), sh.gathered(p):
                    h, _ = prefill_attention(
                        p.attn, rms_norm(x, p.ln1, cfg.norm_eps), positions,
                        rope_theta=cfg.rope_theta, eps=cfg.norm_eps, causal=False)
                    x = x + h
                    return x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps))

            x = _remat(body, x) if remat else body(x)
    with sh.gathered(params, recurse=False, fields=("enc_norm",)):
        x = rms_norm(x, params.enc_norm, cfg.norm_eps)
    # every cross-attention reads every frame, and makes its gradient whole
    return sh.all_gather(x, 1) if sp else x


def _cross_kv(p_attn: Attention, enc_out: torch.Tensor):
    """The encoder output's keys and values for one cross-attention block,
    (B, F, K, hd) each."""
    if p_attn.tp is not None and p_attn.tp.heads:
        enc_out = sh.copy_to(enc_out)
    k = torch.einsum("bsd,dhk->bshk", enc_out, p_attn.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, p_attn.wv)
    return k, v


def decode_train(cfg: ArchConfig, params: EncDec, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """The decoder over a whole token sequence (B, S), teacher-forced.
    Returns logits (B, S, V)."""
    B, S = tokens.shape
    sp = sh.seq_parallel(S)
    with sh.sequence_parallel(sp), sh.gathered(params, recurse=False,
                                               fields=("embed", "final_norm", "unembed")):
        x = shard(embed(params.embed, tokens, params.tp), "batch", "seq", None)
        positions = _positions(B, S, x.device)
        for p in params.decoder:

            def body(x, enc_out, p=p):
                with sh.sequence_parallel(sp), sh.gathered(p):
                    h, _ = prefill_attention(
                        p.self_attn, rms_norm(x, p.ln1, cfg.norm_eps), positions,
                        rope_theta=cfg.rope_theta, eps=cfg.norm_eps, causal=True)
                    x = x + h
                    h, _ = prefill_attention(
                        p.cross_attn, rms_norm(x, p.ln_x, cfg.norm_eps), positions,
                        rope_theta=cfg.rope_theta, eps=cfg.norm_eps, causal=False,
                        cross_kv=_cross_kv(p.cross_attn, enc_out), use_rope=False)
                    x = x + h
                    return x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps))

            x = _remat(body, x, enc_out) if remat else body(x, enc_out)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        return unembed(unembed_input(x, params.tp), params.unembed)


def forward(cfg: ArchConfig, params: EncDec, batch, *,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"frames": (B, F, d), "tokens": (B, S)}. Returns (logits (B,
    S, V), aux loss 0 as a 0-dim f32 tensor)."""
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    logits = decode_train(cfg, params, batch["tokens"], enc_out, remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ArchConfig, params: EncDec, batch, *, remat: bool = True):
    """batch: {"frames", "tokens", "labels"}. Returns (ce + aux, {"ce",
    "nll", "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    ce, nll = cross_entropy(logits, batch["labels"], tp=params.tp)
    return ce + aux, {"ce": ce, "nll": nll, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device) -> dict[str, torch.Tensor]:
    """The decoder's self-attention cache of ``max_len`` rows and the
    encoder's cross K/V, ``(L, B, K, encoder_frames, hd)``."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_frames, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "cross_k": torch.zeros(cross, dtype=cfg.torch_dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=cfg.torch_dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: ArchConfig, params: EncDec, frames: torch.Tensor, cache):
    """Encode ``frames`` and store each decoder layer's cross K/V in the
    cache, in place. The decoder starts empty: ``lengths`` is set to 0, what
    ``repro``'s prefill leaves in a fresh cache (a reused cache may hold an
    earlier request's length). Returns (None, cache)."""
    enc_out = encode(cfg, params, frames, remat=False)
    for i, p in enumerate(params.decoder):
        k, v = _cross_kv(p.cross_attn, enc_out)
        if p.cross_attn.tp is None:
            cache["cross_k"][i] = k.transpose(1, 2)
            cache["cross_v"][i] = v.transpose(1, 2)
        else:
            store_prefill_kv(cache["cross_k"][i], k.transpose(1, 2), p.cross_attn.tp)
            store_prefill_kv(cache["cross_v"][i], v.transpose(1, 2), p.cross_attn.tp)
    cache["lengths"].zero_()
    return None, cache


def decode_step(cfg: ArchConfig, params: EncDec, cache, tokens: torch.Tensor):
    """One greedy decode step. tokens: (B, 1) int32, the current token.
    Returns (logits (B, 1, V), cache updated in place)."""
    B = tokens.shape[0]
    x = embed(params.embed, tokens, params.tp)
    lengths = cache["lengths"]
    frames = cache["cross_k"].shape[3]
    cross_tp = params.decoder[0].cross_attn.tp if len(params.decoder) else None
    if cross_tp is not None and cross_tp.cache_dim == 2:  # this rank's slice of the frames
        frames *= sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS)
    all_frames = torch.full((B,), frames, dtype=torch.int32, device=x.device)
    for i, p in enumerate(params.decoder):
        h = decode_attention_step(
            p.self_attn, rms_norm(x, p.ln1, cfg.norm_eps), cache["k"][i], cache["v"][i],
            lengths, rope_theta=cfg.rope_theta, eps=cfg.norm_eps)
        x = x + h
        h = decode_attention_step(
            p.cross_attn, rms_norm(x, p.ln_x, cfg.norm_eps), cache["cross_k"][i],
            cache["cross_v"][i], all_frames, rope_theta=cfg.rope_theta, eps=cfg.norm_eps,
            use_rope=False, update_cache=False)
        x = x + h
        x = x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(x, params.unembed)
    lengths.add_(1)
    return logits, cache
