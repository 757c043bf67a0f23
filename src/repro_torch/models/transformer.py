"""Dense and MoE decoder-only transformer (the FFN is pluggable) with
KV-cache prefill/decode and sliding-window support.

Used directly by: llama3.2-1b, phi3-mini, qwen3, mistral-large-123b and
chameleon-34b (early-fusion VLM: image tokens are ordinary vocab ids), and
with MoE FFNs (:mod:`repro_torch.models.moe`) by deepseek-moe-16b and
granite-moe-1b-a400m.

Layers are per-layer modules in an ``nn.ModuleList`` in place of
``repro``'s stacked, vmap-initialised layer pytree; layer ``i`` holds slice
``i`` of each stacked weight (see :mod:`repro_torch.models.convert`). The
KV cache is preallocated and written in place: prefill fills the prompt's
rows, each decode step one row a sequence, and ``lengths`` advances in place.
:func:`forward` returns the layers' summed auxiliary loss beside the logits
(the MoE router's load-balance and z-loss terms; 0 for a dense FFN); prefill
and decode drop it, as ``repro``'s do. :func:`loss_fn` adds it to the cross
entropy, and ``remat`` recomputes each layer in the backward, where
``repro`` wraps its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import trace
from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..distributed.sharding import shard
from . import moe
from .attention import Attention, decode_attention_step, prefill_attention, store_prefill_kv
from .layers import (SwiGLU, cross_entropy, embed, normal_init, remat as _remat, rms_norm,
                     unembed, unembed_input)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, dtype=dt, device=device),
                                requires_grad=False)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.qk_norm, dt, device)
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model, dtype=dt, device=device),
                                requires_grad=False)
        self.mlp = (moe.MoE(cfg, device) if cfg.moe is not None
                    else SwiGLU(cfg.d_model, cfg.d_ff, dt, device))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.attn.init(generator)
        self.ln2.fill_(1.0)
        self.mlp.init(generator)


class Transformer(nn.Module):
    """The parameters of one model (``repro``'s ``params`` dict)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=device),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, dtype=dt, device=device),
                                       requires_grad=False)
        self.unembed = (
            None if cfg.tie_embeddings
            else nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, dtype=dt, device=device),
                              requires_grad=False)
        )

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        cfg = self.cfg
        self.embed.copy_(normal_init((cfg.vocab, cfg.d_model), 1.0, self.embed.dtype, generator))
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.fill_(1.0)
        if self.unembed is not None:
            self.unembed.copy_(normal_init((cfg.d_model, cfg.vocab), cfg.d_model**-0.5,
                                           self.unembed.dtype, generator))
        return self

    def out_proj(self) -> torch.Tensor:
        return self.unembed if self.unembed is not None else self.embed.T


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _mlp_apply(cfg: ArchConfig, p: Block, x, use_kernel):
    """Returns (y, aux_loss)."""
    if cfg.moe is not None:
        return moe.apply_moe(cfg, p.mlp, x, use_kernel)
    return p.mlp(x), 0.0


def _mlp(cfg: ArchConfig, p: Block, x, use_kernel):
    """The FFN's output alone."""
    return p.mlp(x, use_kernel) if cfg.moe is not None else p.mlp(x)


def _layer_prefill(cfg: ArchConfig, p: Block, x, positions, window, use_kernel, with_aux):
    """``with_aux=False`` skips the aux loss that a caller would drop (in
    ``repro``, jit removes it as dead code) and returns 0.0 for it."""
    with trace.scope("attention"):
        h, (k, v) = prefill_attention(
            p.attn, rms_norm(x, p.ln1, cfg.norm_eps), positions,
            rope_theta=cfg.rope_theta, eps=cfg.norm_eps, window=window, use_kernel=use_kernel,
        )
        x = x + h
    with trace.scope("ffn"):
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        m, aux = (_mlp_apply(cfg, p, h, use_kernel) if with_aux
                  else (_mlp(cfg, p, h, use_kernel), 0.0))
        return x + m, (k, v), aux


def _layer_decode(cfg: ArchConfig, p: Block, x, k_cache, v_cache, lengths, window, use_kernel):
    with trace.scope("attention"):
        h = decode_attention_step(
            p.attn, rms_norm(x, p.ln1, cfg.norm_eps), k_cache, v_cache, lengths,
            rope_theta=cfg.rope_theta, eps=cfg.norm_eps, window=window, use_kernel=use_kernel,
        )
        x = x + h
    # the FFN alone: repro computes the aux here and drops it (jit removes it)
    with trace.scope("ffn"):
        return x + _mlp(cfg, p, rms_norm(x, p.ln2, cfg.norm_eps), use_kernel)


# ---------------------------------------------------------------------------
# Public model functions
# ---------------------------------------------------------------------------


def _embed(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return shard(embed(params.embed, tokens, params.tp), "batch", "seq", None)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def forward(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor, *,
            remat: bool = True, use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass over ``tokens`` (B, S). Returns (logits (B, S, V),
    the layers' summed aux loss as a 0-dim f32 tensor). ``remat``
    recomputes each layer in the backward. On a mesh whose rules map
    ``"seq"`` to the model axis the residual stream between the layers is
    the rank's block of the sequence (:func:`sh.sequence_parallel`); FSDP
    parameters are gathered for the layer that reads them, and again in its
    recompute (:func:`sh.gathered`)."""
    window = cfg.sliding_window
    sp = sh.seq_parallel(tokens.shape[1])
    with sh.sequence_parallel(sp), sh.gathered(params, recurse=False):
        x = _embed(params, tokens)
        positions = _positions(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in params.layers:

            def body(x, p=p):
                with sh.sequence_parallel(sp), sh.gathered(p):
                    y, _, layer_aux = _layer_prefill(cfg, p, x, positions, window, use_kernel,
                                                     True)
                return y, layer_aux

            x, layer_aux = _remat(body, x) if remat else body(x)
            aux = aux + layer_aux
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        return unembed(unembed_input(x, params.tp), params.out_proj()), aux


def loss_fn(cfg: ArchConfig, params: Transformer, batch, *, remat: bool = True,
            use_kernel: bool = True):
    """batch: {"tokens", "labels"} (B, S). Returns (ce + aux, {"ce", "nll",
    "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat, use_kernel=use_kernel)
    ce, nll = cross_entropy(logits, batch["labels"], tp=params.tp)
    return ce + aux, {"ce": ce, "nll": nll, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device) -> dict[str, torch.Tensor]:
    """KV cache. With a sliding window, the cache is a ring of size window."""
    window = cfg.sliding_window
    S = min(max_len, window) if window is not None else max_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor, cache, *,
            use_kernel: bool = True):
    """Run the prompt through the stack, filling the cache in place. Returns
    (last-token logits (B, 1, V), cache). Without a sliding window a prompt
    longer than the cache raises ValueError."""
    B, S = tokens.shape
    window = cfg.sliding_window
    S_c = cache["k"].shape[3]
    tp = params.layers[0].attn.tp if len(params.layers) else None
    if tp is not None and tp.cache_dim == 2:  # this rank's slice of the rows
        S_c *= sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS)
    if window is None and S > S_c:
        # repro returns a cache grown to S rows here; its next decode step
        # then writes row S of an S-row cache, which dynamic_update_slice
        # clamps onto the last prompt row
        raise ValueError(f"prompt of {S} tokens is longer than the cache's {S_c} rows "
                         f"(repro grows the cache to {S} rows here)")
    sp = sh.seq_parallel(S)
    with sh.sequence_parallel(sp):
        x = _embed(params, tokens)
        positions = _positions(tokens)
        for i, p in enumerate(params.layers):
            x, (k, v), _ = _layer_prefill(cfg, p, x, positions, window, use_kernel, False)
            with trace.scope("attention"):
                if window is not None and S > S_c:
                    # keep the last `window` positions; ring alignment: slot = pos % window
                    shift = (S - S_c) % S_c
                    k = torch.roll(k[:, :, -S_c:], shifts=shift, dims=2)
                    v = torch.roll(v[:, :, -S_c:], shifts=shift, dims=2)
                store_prefill_kv(cache["k"][i], k, p.attn.tp)
                store_prefill_kv(cache["v"][i], v, p.attn.tp)
    with trace.scope("logits"):
        if sp:  # the last position is on the last rank's block
            x = sh.all_gather(x, 1)
        x = rms_norm(x[:, -1:, :], params.final_norm, cfg.norm_eps)
        logits = unembed(x, params.out_proj())
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg: ArchConfig, params: Transformer, cache, tokens: torch.Tensor, *,
                use_kernel: bool = True):
    """One greedy decode step. tokens: (B, 1) int32 — the current token.
    Returns (logits (B,1,V), cache updated in place)."""
    window = cfg.sliding_window
    x = _embed(params, tokens)
    lengths = cache["lengths"]
    for i, p in enumerate(params.layers):
        x = _layer_decode(cfg, p, x, cache["k"][i], cache["v"][i], lengths, window, use_kernel)
    with trace.scope("logits"):
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = unembed(x, params.out_proj())
    lengths.add_(1)
    return logits, cache
