"""Unified model API, as ``repro.models.model`` exposes it:

    model = build_model(cfg)                       # on the card; device="cpu" for the CPU
    params = model.init(seed)
    loss, metrics = model.loss(params, batch)               # training
    logits, aux = model.forward(params, batch)              # full forward, aux loss
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.prefill(params, batch, cache)        # inference prefill
    logits, cache = model.decode_step(params, cache, tokens)   # serve_step

Serving additionally uses the compiled surface, ``repro``'s ``jax.jit``
counterparts:

    cache = model.static_cache(batch_size, max_len)
    logits, cache = model.prefill_jit(params, batch, cache)
    tokens, cache = model.decode_tokens(params, cache, tok, n_steps)

``params`` is the family's module: a
:class:`~repro_torch.models.transformer.Transformer` (dense, moe, vlm), an
:class:`~repro_torch.models.encdec.EncDec` (whisper-small, whose ``batch``
is ``{"frames", "tokens"}`` in ``forward`` and ``{"frames"}`` in
``prefill``), a :class:`~repro_torch.models.hybrid.Zamba2` (zamba2-1.2b),
an :class:`~repro_torch.models.xlstm.XLSTM` (xlstm-1.3b) or a
:class:`~repro_torch.models.hybrid_moe.GraniteHybrid` (``hybrid_moe``:
granite-4.0-h, a family ``repro`` does not have). Every family of ``repro``
is ported.

``decode_tokens`` is the greedy loop that ``repro`` rolls into one
``lax.scan``: a fixed-shape loop of ``n_steps`` steps whose argmax stays on
the device, writing into a ``(B, n_steps)`` tensor, with no host copy inside
the loop. On a CUDA device the whole loop is one CUDA graph per ``(B,
cache_len, n_steps)`` and ``prefill_jit`` one per ``(B, S, cache_len)`` (for
encdec per ``(B, frames, cache_len)``), captured at the first call of a
shape and replayed after it (:mod:`repro_torch.models.graphs`); on the CPU
both run as they are. ``cache_len`` is the rows of the cache's K/V (for
zamba2 its shared block's ring, ``min(max_len, window)``); xlstm's state has
no rows (it is O(1) in ``max_len``), so its caches and graphs are keyed by
batch (and prompt length) alone, with ``cache_len`` None: one 0.7 GB state
a batch size, not one a length bucket.
``static_cache`` is the model's own cache per ``(B, cache_len)``, reused by
every call: the graphs' static buffer. On a mesh (``sharding.use_mesh``) the
keys of the graphs and of the static caches also hold the placement
(:meth:`Model._layout`), ``cache_len`` is the whole cache's rows, and a
placed model's static cache is this rank's blocks. Because step ``t``
depends only on
steps ``< t``, running extra (bucket-padding) steps never changes the first
``n`` tokens.

``use_kernels=False`` routes attention to the plain versions on the card
too; that is how a run holds the kernel path against the plain path.

``loss`` and ``forward`` run in the caller's grad mode (the trainer turns the
parameters' gradients on: they are built frozen); ``remat`` recomputes each
layer in the backward (``repro``'s defaults: on in ``loss``, off in
``forward``). The serving surface (``prefill``, ``decode_step``,
``prefill_jit``, ``decode_tokens``) runs under ``torch.no_grad()``, so a
model that has trained serves, and is captured, without recording autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .. import trace
from .._device import resolve_device
from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from . import attention, encdec, hybrid, hybrid_moe, transformer, xlstm
from .attention import Attention
from .graphs import GraphCache
from .layers import gather_logits

# family -> (module of its functions, its parameter module)
_FAMILIES = {
    "dense": (transformer, transformer.Transformer),
    "moe": (transformer, transformer.Transformer),
    "vlm": (transformer, transformer.Transformer),
    "encdec": (encdec, encdec.EncDec),
    "hybrid": (hybrid, hybrid.Zamba2),
    "hybrid_moe": (hybrid_moe, hybrid_moe.GraniteHybrid),
    "xlstm": (xlstm, xlstm.XLSTM),
}


def cache_len(cache: dict[str, torch.Tensor]) -> Optional[int]:
    """The rows of a cache's K/V: ``k`` (transformer, encdec), ``attn_k``
    (zamba2's shared block, hybrid_moe's attention layers); None for a
    cache of recurrent state alone."""
    for name in ("k", "attn_k"):
        if name in cache:
            return cache[name].shape[3]
    return None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    use_kernels: bool = True
    graphs: GraphCache = dataclasses.field(default_factory=GraphCache, compare=False,
                                           repr=False)

    @property
    def _impl(self):
        """The family's module of functions."""
        return _FAMILIES[self.cfg.family][0]

    @property
    def _input(self) -> str:
        """The batch key that ``prefill`` reads."""
        return "frames" if self._impl is encdec else "tokens"

    def init(self, seed: int) -> Union[transformer.Transformer, encdec.EncDec, hybrid.Zamba2,
                                       xlstm.XLSTM]:
        """Fresh weights drawn from a ``torch.Generator`` seeded with ``seed``
        on the target device (``repro``'s scales, not its values)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return _FAMILIES[self.cfg.family][1](self.cfg, self.device).init(gen)

    def loss(self, params, batch, *, remat: bool = True) -> tuple[torch.Tensor, dict]:
        """(ce + aux, {"ce", "nll", "aux"}), as ``repro``'s ``Model.loss``:
        batch ``{"tokens", "labels"}`` (encdec: and ``"frames"``)."""
        return self._impl.loss_fn(self.cfg, params, batch, remat=remat,
                                  use_kernel=self.use_kernels)

    def forward(self, params, batch, *, remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V), aux loss), as ``repro``'s ``Model.forward``."""
        inputs = batch if self._impl is encdec else batch["tokens"]
        return self._impl.forward(self.cfg, params, inputs, remat=remat,
                                  use_kernel=self.use_kernels)

    def init_cache(self, batch_size: int, max_len: int):
        return self._impl.init_cache(self.cfg, batch_size, max_len, device=self.device)

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return self._impl.prefill(self.cfg, params, batch[self._input], cache,
                                  use_kernel=self.use_kernels)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        return self._impl.decode_step(self.cfg, params, cache, tokens,
                                      use_kernel=self.use_kernels)

    @property
    def graph_stats(self) -> dict[str, int]:
        """CUDA graphs captured, replayed and dropped for new weights."""
        return self.graphs.stats

    def static_cache(self, batch_size: int, max_len: Optional[int], params=None):
        """The model's cache for ``(batch_size, max_len)``, made at the first
        call and returned again after: one a ``(batch_size, cache_len)``, so
        ``max_len`` past a sliding window shares the window's cache, and an
        xlstm model has one a batch size. A request never reads an earlier
        one's rows or state: prefill writes the prompt's rows and sets
        ``lengths``, and decode attention reads only below ``lengths``;
        prefill starts every recurrent state from its initial value and
        overwrites the cache's.

        On a mesh, given the ``params`` it serves, one also a placement
        (:meth:`_layout`): a placed model's is this rank's blocks
        (``launch.shardings.place_cache``), and ``max_len`` counts the
        whole cache's rows."""
        rows = self._rows(max_len)
        layout = self._layout(params) if params is not None else ()

        def make():
            cache = self.init_cache(batch_size, max_len)
            if getattr(params, "tp", None) is None:
                return cache
            from ..launch.shardings import place_cache  # launch imports the models

            return place_cache(cache, self.cfg, sh.current_mesh())[0]

        return self.graphs.static_cache((batch_size, rows) + layout, make)

    def _layout(self, params) -> tuple:
        """What selects the program a graph records besides the shapes, as
        a key: on a mesh its axes and their sizes, the dim of each
        attention's cache that the model axis splits (``tp.cache_dim``;
        None where not placed) and the decode mode. At model-axis size 1 a
        placed model keeps every weight tensor, so this alone tells its
        graphs from the unplaced model's. () without a mesh."""
        mesh = sh.current_mesh()
        if mesh is None:
            return ()
        dims = tuple(m.tp.cache_dim if m.tp is not None else None
                     for m in params.modules() if isinstance(m, Attention))
        return ((tuple(mesh.mesh_dim_names), tuple(mesh.shape), dims,
                 attention.DECODE_ATTN_MODE),)

    def _global_rows(self, params, cache) -> Optional[int]:
        """``cache_len`` of the whole cache of which ``cache`` may be this
        rank's slice along the length."""
        rows = cache_len(cache)
        if rows is None or sh.current_mesh() is None:
            return rows
        tp = next((m.tp for m in params.modules() if isinstance(m, Attention)), None)
        if tp is not None and tp.cache_dim == 2:
            rows *= sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS)
        return rows

    def _rows(self, max_len: Optional[int]) -> Optional[int]:
        """``cache_len`` of ``init_cache(B, max_len)``."""
        if self.cfg.family == "xlstm":
            return None
        window = self.cfg.sliding_window
        return min(max_len, window) if window is not None else max_len

    @torch.no_grad()
    def prefill_jit(self, params, batch, cache):
        """``prefill``, as one CUDA graph per (B, S, cache_len) on the card;
        for encdec per (B, frames, cache_len), whose graph returns None."""
        if self.device.type != "cuda":
            return self.prefill(params, batch, cache)
        name = self._input
        inputs = batch[name]
        B, S = inputs.shape[:2]
        static = self.static_cache(B, self._global_rows(params, cache), params)

        def body(x):
            return self.prefill(params, {name: x}, static)[0]

        key = self.graph_key("prefill", params, cache, B, S)
        return self.graphs.run(key, params, inputs, body, cache, static), cache

    @torch.no_grad()
    def decode_tokens(self, params, cache, tokens: torch.Tensor, n_steps: int):
        """Greedy-decode ``n_steps`` tokens from ``tokens`` (B, 1), as one
        CUDA graph per (B, cache_len, n_steps) on the card. Returns ((B,
        n_steps) int32 tokens on the device, the cache)."""
        if self.device.type != "cuda":
            return self._decode_loop(params, cache, tokens, n_steps), cache
        B = tokens.shape[0]
        static = self.static_cache(B, self._global_rows(params, cache), params)

        def body(toks):
            return self._decode_loop(params, static, toks, n_steps)

        key = self.graph_key("decode", params, cache, B, n_steps)
        return self.graphs.run(key, params, tokens, body, cache, static), cache

    def graph_key(self, kind: str, params, cache, batch_size: int, n: int) -> tuple:
        """The key of the graph that ``prefill_jit`` (``kind`` "prefill",
        ``n`` the prompt's length or frames) or ``decode_tokens`` ("decode",
        ``n`` steps) captures for ``cache``: ``("prefill", B, S, cache_len)``
        or ``("decode", B, cache_len, n_steps)``, and on a mesh the
        placement (:meth:`_layout`)."""
        rows = self._global_rows(params, cache)
        key = (kind, batch_size, n, rows) if kind == "prefill" else (kind, batch_size, rows, n)
        return key + self._layout(params)

    def _decode_loop(self, params, cache, tokens: torch.Tensor, n_steps: int) -> torch.Tensor:
        """The greedy loop; a placed model's logits are gathered over the
        vocab before the argmax."""
        out = torch.empty((tokens.shape[0], n_steps), dtype=torch.int32, device=tokens.device)
        tok = tokens
        for t in range(n_steps):
            logits, cache = self.decode_step(params, cache, tok)
            with trace.scope("logits"):
                tok = greedy_token(gather_logits(params, logits))
                out[:, t] = tok[:, 0]
        return out


def build_model(cfg: ArchConfig, *, device: Optional[Union[str, torch.device]] = None,
                use_kernels: bool = True) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg=cfg, device=resolve_device(device), use_kernels=use_kernels)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) argmax token (the first maximum, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
