"""Unified model API, as ``repro.models.model`` exposes it:

    model = build_model(cfg)                       # on the card; device="cpu" for the CPU
    params = model.init(seed)
    logits, aux = model.forward(params, batch)              # full forward, aux loss
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.prefill(params, batch, cache)        # inference prefill
    logits, cache = model.decode_step(params, cache, tokens)   # serve_step

Serving additionally uses the compiled surface, ``repro``'s ``jax.jit``
counterparts:

    cache = model.static_cache(batch_size, max_len)
    logits, cache = model.prefill_jit(params, batch, cache)
    tokens, cache = model.decode_tokens(params, cache, tok, n_steps)

``params`` is a :class:`~repro_torch.models.transformer.Transformer`
module. The transformer families (dense, moe, vlm) are ported; the others
raise.

``decode_tokens`` is the greedy loop that ``repro`` rolls into one
``lax.scan``: a fixed-shape loop of ``n_steps`` steps whose argmax stays on
the device, writing into a ``(B, n_steps)`` tensor, with no host copy inside
the loop. On a CUDA device the whole loop is one CUDA graph per ``(B,
cache_len, n_steps)`` and ``prefill_jit`` one per ``(B, S, cache_len)``,
captured at the first call of a shape and replayed after it
(:mod:`repro_torch.models.graphs`); on the CPU both run as they are.
``static_cache`` is the model's own cache per ``(B, cache_len)``, reused by
every call: the graphs' static buffer. Because step ``t`` depends only on
steps ``< t``, running extra (bucket-padding) steps never changes the first
``n`` tokens.

``use_kernels=False`` routes attention to the plain versions on the card
too; that is how a run holds the kernel path against the plain path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from . import transformer
from .graphs import GraphCache

_NOT_PORTED = {
    "xlstm": "the recurrent families are ROADMAP item M9",
    "hybrid": "the recurrent families are ROADMAP item M9",
    "encdec": "the encoder-decoder family is ROADMAP item M7",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    use_kernels: bool = True
    graphs: GraphCache = dataclasses.field(default_factory=GraphCache, compare=False,
                                           repr=False)

    def init(self, seed: int) -> transformer.Transformer:
        """Fresh weights drawn from a ``torch.Generator`` seeded with ``seed``
        on the target device (``repro``'s scales, not its values)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.Transformer(self.cfg, self.device).init(gen)

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V), aux loss), as ``repro``'s ``Model.forward``."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   use_kernel=self.use_kernels)

    def init_cache(self, batch_size: int, max_len: int):
        return transformer.init_cache(self.cfg, batch_size, max_len, device=self.device)

    def prefill(self, params, batch, cache):
        return transformer.prefill(self.cfg, params, batch["tokens"], cache,
                                   use_kernel=self.use_kernels)

    def decode_step(self, params, cache, tokens):
        return transformer.decode_step(self.cfg, params, cache, tokens,
                                       use_kernel=self.use_kernels)

    @property
    def graph_stats(self) -> dict[str, int]:
        """CUDA graphs captured, replayed and dropped for new weights."""
        return self.graphs.stats

    def static_cache(self, batch_size: int, max_len: int):
        """The model's KV cache for ``(batch_size, max_len)``, made at the
        first call and returned again after. A request never reads an earlier
        one's rows: prefill writes the prompt's rows and sets ``lengths``, and
        decode attention reads only below ``lengths``."""
        return self.graphs.static_cache((batch_size, max_len),
                                        lambda: self.init_cache(batch_size, max_len))

    def prefill_jit(self, params, batch, cache):
        """``prefill``, as one CUDA graph per (B, S, cache_len) on the card."""
        if self.device.type != "cuda":
            return self.prefill(params, batch, cache)
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache_len = cache["k"].shape[3]
        static = self.static_cache(B, cache_len)

        def body(toks):
            return self.prefill(params, {"tokens": toks}, static)[0]

        key = ("prefill", B, S, cache_len)
        return self.graphs.run(key, params, tokens, body, cache, static), cache

    def decode_tokens(self, params, cache, tokens: torch.Tensor, n_steps: int):
        """Greedy-decode ``n_steps`` tokens from ``tokens`` (B, 1), as one
        CUDA graph per (B, cache_len, n_steps) on the card. Returns ((B,
        n_steps) int32 tokens on the device, the cache)."""
        if self.device.type != "cuda":
            return self._decode_loop(params, cache, tokens, n_steps), cache
        B, cache_len = tokens.shape[0], cache["k"].shape[3]
        static = self.static_cache(B, cache_len)

        def body(toks):
            return self._decode_loop(params, static, toks, n_steps)

        key = ("decode", B, cache_len, n_steps)
        return self.graphs.run(key, params, tokens, body, cache, static), cache

    def _decode_loop(self, params, cache, tokens: torch.Tensor, n_steps: int) -> torch.Tensor:
        out = torch.empty((tokens.shape[0], n_steps), dtype=torch.int32, device=tokens.device)
        tok = tokens
        for t in range(n_steps):
            logits, cache = self.decode_step(params, cache, tok)
            tok = greedy_token(logits)
            out[:, t] = tok[:, 0]
        return out


def build_model(cfg: ArchConfig, *, device: Optional[Union[str, torch.device]] = None,
                use_kernels: bool = True) -> Model:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.arch_id}: {_NOT_PORTED[fam]}, not ported yet")
    if fam not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {fam!r}")
    return Model(cfg=cfg, device=resolve_device(device), use_kernels=use_kernels)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) argmax token (the first maximum, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
