"""Unified model API, as ``repro.models.model`` exposes it:

    model = build_model(cfg)                       # on the card; device="cpu" for the CPU
    params = model.init(seed)
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.prefill(params, batch, cache)        # inference prefill
    logits, cache = model.decode_step(params, cache, tokens)   # serve_step
    tokens, cache = model.decode_tokens(params, cache, tok, n_steps)

``params`` is a :class:`~repro_torch.models.transformer.Transformer`
module. Only the dense family (dense, vlm) is ported; the others raise.

``decode_tokens`` is the greedy loop that ``repro`` rolls into one
``lax.scan``: here a fixed-shape Python loop of ``n_steps`` steps whose
argmax stays on the device, writing into a preallocated ``(B, n_steps)``
tensor, with no host copy inside the loop — so it is capturable by a CUDA
graph. Because step ``t`` depends only on steps ``< t``, running extra
(bucket-padding) steps never changes the first ``n`` tokens.

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

_NOT_PORTED = {
    "moe": "the MoE FFN is ROADMAP item M6",
    "xlstm": "the recurrent families are ROADMAP item M9",
    "hybrid": "the recurrent families are ROADMAP item M9",
    "encdec": "the encoder-decoder family is ROADMAP item M7",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    use_kernels: bool = True

    def init(self, seed: int) -> transformer.Transformer:
        """Fresh weights drawn from a ``torch.Generator`` seeded with ``seed``
        on the target device (``repro``'s scales, not its values)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.Transformer(self.cfg, self.device).init(gen)

    def forward(self, params, batch) -> torch.Tensor:
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

    def decode_tokens(self, params, cache, tokens: torch.Tensor, n_steps: int):
        """Greedy-decode ``n_steps`` tokens from ``tokens`` (B, 1). Returns
        ((B, n_steps) int32 tokens on the device, the cache)."""
        out = torch.empty((tokens.shape[0], n_steps), dtype=torch.int32, device=tokens.device)
        tok = tokens
        for t in range(n_steps):
            logits, cache = self.decode_step(params, cache, tok)
            tok = greedy_token(logits)
            out[:, t] = tok[:, 0]
        return out, cache


def build_model(cfg: ArchConfig, *, device: Optional[Union[str, torch.device]] = None,
                use_kernels: bool = True) -> Model:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.arch_id}: {_NOT_PORTED[fam]}, not ported yet")
    if fam not in ("dense", "vlm"):
        raise ValueError(f"unknown family {fam!r}")
    return Model(cfg=cfg, device=resolve_device(device), use_kernels=use_kernels)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) argmax token (the first maximum, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
