"""xLSTM language model (arXiv:2405.04517), the port of
``repro.models.xlstm``: a stack of mLSTM blocks with an sLSTM block every
``cfg.slstm_every`` layers (the paper's mixed-block design). d_ff == 0:
blocks carry their own up/down projections (expand 2x), no separate FFN.

Layer layout (n_layers=48, slstm_every=8):
  [7x mLSTM, 1x sLSTM] x 6
Each group of the plan (``_plan``) is a ``ModuleList`` of mLSTM blocks or
one sLSTM block, in place of ``repro``'s stacked mLSTM tree.

No TPU kernel is on this path: everything computes in plain PyTorch ops
(:mod:`repro_torch.models.ssm`). The sLSTM cell calls ``slstm_scan`` on
the batch it is given. ``repro`` runs the cell under ``shard_map`` when its
``SLSTM_SHARD_MAP`` is set (each data rank on its batch block, ``R``
replicated, no collective); the port's local program on a mesh already
holds the rank's batch block, so it is that branch as it stands, and the
port has no such knob.

The recurrent state is O(1) in ``max_len`` and is held as a flat dict of
tensors, named per plan group ``gi``: an mLSTM group's ``g{gi}.C`` (count, B,
H, P, P), ``g{gi}.n`` (count, B, H, P) and ``g{gi}.m`` (count, B, H); an sLSTM
group's ``g{gi}.c``, ``g{gi}.n``, ``g{gi}.h`` and ``g{gi}.m`` (B, H, P); and
``lengths``. ``prefill`` starts from a fresh state (zeros, and -1e30 for
the stabilizers) whatever the cache holds: ``repro``'s continues from the
cache's state, and its serving path always hands it a fresh ``init_cache``,
while the port's serving path reuses one static cache for every request.
Decode computes each new state and then copies it into the cache.

In training (:func:`loss_fn`) ``remat`` recomputes each mLSTM block in the
backward and keeps the sLSTM's activations, as ``repro`` wraps only the
mLSTM scan's body in ``jax.checkpoint``.

On a mesh a model placed by ``launch.shardings.place_params`` runs its local
program on the blocks that ``repro``'s specs place. xlstm-1.3b has 4 heads,
which no model axis of 16 splits: the specs split the P axes instead.

- An mLSTM block (``tp.inner``) holds a block of ``w_up``'s columns, which
  pack [a | z] (at 2 ranks one holds all of ``a``), the input P rows of
  ``wq``/``wk``/``wv`` (so q, k and v are partial sums), the rows of ``w_i``,
  ``w_f``, ``hnorm`` and ``w_down``, and the first P axis of its ``C`` and
  ``n``. Every rank reads its P rows of ``a`` for q, k, v, its block of
  ``a`` for the gates and its block of ``z``: three layouts of the packed
  columns, so the projection is all-gathered (B x S x 2 d_inner a block; an
  all-to-all of the parts a rank reads, at most 3 d_inner / m columns of
  the gather's 2 d_inner (m - 1) / m, would move less: the port's
  collectives are all-reduce, all-gather and reduce-scatter, and of these
  the all-gather moves least). The partial q, k, v and gates are
  summed in one all-reduce. The prefill runs the chunked cell on the whole
  heads (every rank the same, no collective inside the cell) and keeps the
  rank's block of ``C`` and ``n``; a decode step updates the rank's block
  and sums ``q·C`` and ``q·n`` over the key axis in one all-reduce
  (``mlstm_step``'s ``reduce``). ``hnorm`` normalises the whole ``h``, and
  ``w_down``'s partial product is all-reduced.
- An sLSTM block (``tp.inner``) holds the rows of ``w_out`` and ``hnorm`` and
  the P axis of its states; ``w_gates`` and ``R`` are whole. The prefill runs
  the whole scan on every rank (no per-token collective) and keeps the
  state's P block; a decode step all-gathers ``h`` for the recurrence,
  updates the rank's P block, and all-gathers the new ``h`` for the output,
  whose rows split as ``w_out``'s.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from .layers import (cross_entropy, embed, normal_init, parameter, remat as _remat, rms_norm,
                     rms_norm_block, unembed, unembed_input)
from .ssm import mlstm_chunked, mlstm_init_state, mlstm_step, slstm_init_state, slstm_scan

EXPAND = 2
MLSTM_STATE = ("C", "n", "m")
SLSTM_STATE = ("c", "n", "h", "m")


def _dims(cfg: ArchConfig):
    d_inner = EXPAND * cfg.d_model
    H = cfg.n_heads
    P = d_inner // H
    return d_inner, H, P


class MLSTMBlock(nn.Module):
    """One mLSTM block's weights (``repro``'s ``init_mlstm_block``)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        d_inner, H, P = _dims(cfg)
        self.ln = parameter((d,), dt, device)
        self.w_up = parameter((d, 2 * d_inner), dt, device)
        # per-head block-diagonal projections (xLSTM's multi-head design)
        self.wq = parameter((H, P, P), dt, device)
        self.wk = parameter((H, P, P), dt, device)
        self.wv = parameter((H, P, P), dt, device)
        self.w_i = parameter((d_inner, H), dt, device)
        self.w_f = parameter((d_inner, H), dt, device)
        self.b_f = parameter((H,), dt, device)
        self.b_i = parameter((H,), dt, device)
        self.hnorm = parameter((d_inner,), dt, device)
        self.w_down = parameter((d_inner, d), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d, d_inner = self.w_up.shape[0], self.w_down.shape[0]
        P = self.wq.shape[1]
        for w, scale in ((self.w_up, d**-0.5), (self.wq, P**-0.5), (self.wk, P**-0.5),
                         (self.wv, P**-0.5), (self.w_i, d_inner**-0.5),
                         (self.w_f, d_inner**-0.5), (self.w_down, d_inner**-0.5)):
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))
        self.ln.fill_(1.0)
        self.b_f.fill_(3.0)  # open forget gates at init
        self.b_i.fill_(-2.0)
        self.hnorm.fill_(1.0)


class SLSTMBlock(nn.Module):
    """One sLSTM block's weights (``repro``'s ``init_slstm_block``)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        d, dt, H = cfg.d_model, cfg.torch_dtype, cfg.n_heads
        self.ln = parameter((d,), dt, device)
        self.w_gates = parameter((d, 4 * d), dt, device)
        self.b_gates = parameter((4 * d,), dt, device)
        self.R = parameter((4, H, d // H, d // H), dt, device)
        self.hnorm = parameter((d,), dt, device)
        self.w_out = parameter((d, d), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d, P = self.w_out.shape[0], self.R.shape[2]
        for w, scale in ((self.w_gates, d**-0.5), (self.R, P**-0.5), (self.w_out, d**-0.5)):
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))
        self.ln.fill_(1.0)
        self.b_gates.zero_()
        self.b_gates[2 * d : 3 * d] = 3.0  # the forget gates' bias
        self.hnorm.fill_(1.0)


def _plan(cfg: ArchConfig) -> list[tuple[str, int]]:
    """[(kind, count)] groups: runs of mLSTM followed by one sLSTM."""
    if not cfg.slstm_every:
        return [("mlstm", cfg.n_layers)]
    groups = []
    n_groups = cfg.n_layers // cfg.slstm_every
    for _ in range(n_groups):
        groups.append(("mlstm", cfg.slstm_every - 1))
        groups.append(("slstm", 1))
    rem = cfg.n_layers - n_groups * cfg.slstm_every
    if rem:
        groups.append(("mlstm", rem))
    return groups


class XLSTM(nn.Module):
    """The parameters of one xLSTM model (``repro``'s ``params`` dict):
    ``embed``, ``final_norm``, ``unembed`` and ``groups``, one entry a plan
    group (a ``ModuleList`` of mLSTM blocks, or an sLSTM block)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = parameter((cfg.vocab, cfg.d_model), dt, device)
        self.final_norm = parameter((cfg.d_model,), dt, device)
        self.unembed = parameter((cfg.d_model, cfg.vocab), dt, device)
        self.groups = nn.ModuleList(
            nn.ModuleList(MLSTMBlock(cfg, device) for _ in range(count)) if kind == "mlstm"
            else SLSTMBlock(cfg, device)
            for kind, count in _plan(cfg))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "XLSTM":
        """``repro``'s scales (its values come from ``jax.random``)."""
        cfg = self.cfg
        self.embed.copy_(normal_init((cfg.vocab, cfg.d_model), 1.0, self.embed.dtype, generator))
        self.final_norm.fill_(1.0)
        self.unembed.copy_(normal_init((cfg.d_model, cfg.vocab), cfg.d_model**-0.5,
                                       self.unembed.dtype, generator))
        for group in self.groups:
            for block in (group if isinstance(group, nn.ModuleList) else [group]):
                block.init(generator)
        return self


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _split(p) -> bool:
    """Whether the block's inner rows and state are split."""
    return p.tp is not None and p.tp.inner


def _mlstm_qkv(cfg: ArchConfig, p: MLSTMBlock, x):
    """q, k, v (B,S,H,P), the gates (B,S,H) and z: whole heads; z the rank's
    block of d_inner where the block is split (the module's docstring)."""
    d_inner, H, P = _dims(cfg)
    split = _split(p)
    u = sh.enter(rms_norm(x, p.ln, cfg.norm_eps), split) @ p.w_up
    if split:  # each rank reads its own parts of it: the gradient is summed
        u = sh.all_gather(u, 2, sum_grad=True)
    a, z = torch.chunk(u, 2, dim=-1)
    a = sh.shard(a, "batch", None, "ff")
    B, S = x.shape[:2]
    ah = a.reshape(B, S, H, P)
    if split:
        ah = sh.local_block(ah, 3, sh.MODEL_AXIS)  # the input P rows of wq, wk, wv
        a, z = sh.local_block(a, 2, sh.MODEL_AXIS), sh.local_block(z, 2, sh.MODEL_AXIS)
    q = torch.einsum("bshp,hpr->bshr", ah, p.wq)
    k = torch.einsum("bshp,hpr->bshr", ah, p.wk)
    v = torch.einsum("bshp,hpr->bshr", ah, p.wv)
    ig, fg = a @ p.w_i, a @ p.w_f
    if split:
        q, k, v, ig, fg = sh.all_reduce_many([q, k, v, ig, fg])
    return q, k, v, ig + p.b_i.float(), fg + p.b_f.float(), z


def _mlstm_out(cfg: ArchConfig, p: MLSTMBlock, x, h, z):
    split = _split(p)
    h = h.reshape(x.shape[0], x.shape[1], -1)
    h = rms_norm_block(h, p.hnorm, cfg.norm_eps, split) * F.silu(z)
    return x + sh.leave(h @ p.w_down, split)


def _state_block(p, state: tuple) -> tuple:
    """The rank's block of a whole state's P axis (dim 2; an mLSTM's ``m``,
    one scalar a head, whole) where the block is split."""
    if not _split(p):
        return state
    return tuple(t if t.dim() == 2 else sh.local_block(t, 2, sh.MODEL_AXIS) for t in state)


def mlstm_block(cfg: ArchConfig, p: MLSTMBlock, x, *, chunk: int):
    """x: (B,S,d), from a fresh state. Returns (y, (C, n, m)), the rank's
    block of ``C`` and ``n`` where the block is split."""
    q, k, v, ig, fg, z = _mlstm_qkv(cfg, p, x)
    h, state = mlstm_chunked(q, k, v, ig, fg, chunk=chunk)
    return _mlstm_out(cfg, p, x, h, z), _state_block(p, state)


def mlstm_block_step(cfg: ArchConfig, p: MLSTMBlock, x, state):
    """x: (B,1,d); single-token decode on ``state`` (the rank's block where
    the block is split). Returns (y, new (C, n, m))."""
    q, k, v, ig, fg, z = _mlstm_qkv(cfg, p, x)
    q, k, reduce = q[:, 0], k[:, 0], None
    if _split(p):
        q, k = sh.local_block(q, 2, sh.MODEL_AXIS), sh.local_block(k, 2, sh.MODEL_AXIS)
        reduce = sh.all_reduce_many
    h, state = mlstm_step(q, k, v[:, 0], ig[:, 0], fg[:, 0], state, reduce=reduce)
    return _mlstm_out(cfg, p, x, h, z), state


def slstm_block(cfg: ArchConfig, p: SLSTMBlock, x, *, state=None):
    """x: (B,S,d); ``state`` None is a fresh one (the rank's P block of each
    state where the block is split). Returns (y, (c, n, h, m))."""
    B, S, d = x.shape
    H = cfg.n_heads
    split = _split(p)
    xg = (rms_norm(x, p.ln, cfg.norm_eps) @ p.w_gates + p.b_gates.float()).reshape(B, S, 4, H,
                                                                                 d // H)
    if state is None or not split:
        h, state = slstm_scan(xg, p.R, state=state)
        state = _state_block(p, state)
    else:  # the rank's P block of the step, from the whole h
        c, n, h_prev, m = state
        state = (c, n, sh.all_gather(h_prev, 2), m)
        h, state = slstm_scan(sh.local_block(xg, 4, sh.MODEL_AXIS),
                              sh.local_block(p.R, 3, sh.MODEL_AXIS), state=state)
        h = sh.all_gather(h, 3)
    h = rms_norm_block(h.reshape(B, S, -1).to(x.dtype), p.hnorm, cfg.norm_eps, split)
    return x + sh.leave(h @ p.w_out, split), state


def _chunk(cfg: ArchConfig) -> int:
    return cfg.ssm.chunk if cfg.ssm else 256


def _embed(params: XLSTM, tokens: torch.Tensor) -> torch.Tensor:
    return sh.shard(embed(params.embed, tokens, params.tp), "batch", "seq", None)


def _logits(cfg: ArchConfig, params: XLSTM, x):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(unembed_input(x, params.tp), params.unembed)


def _run(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, cache=None, remat=False):
    """The stack over ``tokens`` from a fresh state; with ``cache``, each
    block's final state is copied into it; ``remat`` recomputes each mLSTM
    block in the backward. FSDP parameters are gathered for the block that
    reads them (:func:`sh.gathered`). Returns the last layer's output."""
    x = _embed(params, tokens)
    for gi, group in enumerate(params.groups):
        if isinstance(group, SLSTMBlock):
            with sh.gathered(group):
                x, state = slstm_block(cfg, group, x)
            if cache is not None:
                for name, t in zip(SLSTM_STATE, state):
                    cache[f"g{gi}.{name}"].copy_(t)
            continue
        for j, block in enumerate(group):

            def body(x, p=block):
                with sh.gathered(p):
                    return mlstm_block(cfg, p, x, chunk=_chunk(cfg))

            x, state = _remat(body, x) if remat else body(x)
            if cache is not None:
                for name, t in zip(MLSTM_STATE, state):
                    cache[f"g{gi}.{name}"][j].copy_(t)
    return x


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, *,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass over ``tokens`` (B, S). Returns (logits (B, S, V),
    aux loss 0 as a 0-dim f32 tensor). ``remat`` recomputes each mLSTM block
    in the backward. No kernel is on this path."""
    with sh.gathered(params, recurse=False):
        logits = _logits(cfg, params, _run(cfg, params, tokens, remat=remat))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ArchConfig, params: XLSTM, batch, *, remat: bool = True):
    """batch: {"tokens", "labels"} (B, S). Returns (ce + aux, {"ce", "nll",
    "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat)
    ce, nll = cross_entropy(logits, batch["labels"], tp=params.tp)
    return ce + aux, {"ce": ce, "nll": nll, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len=None, *,
               device: torch.device) -> dict[str, torch.Tensor]:
    """Recurrent state, O(1) in ``max_len`` (which is not read): the xLSTM
    long-context advantage."""
    d_inner, H, P = _dims(cfg)
    Hs, Ps = cfg.n_heads, cfg.d_model // cfg.n_heads
    cache: dict[str, torch.Tensor] = {}
    for gi, (kind, count) in enumerate(_plan(cfg)):
        if kind == "mlstm":
            state = [t[None].expand(count, *t.shape).clone()
                     for t in mlstm_init_state(batch, H, P, device)]
            names = MLSTM_STATE
        else:
            state = [t.clone() for t in slstm_init_state(batch, Hs, Ps, device)]
            names = SLSTM_STATE
        cache.update((f"g{gi}.{name}", t) for name, t in zip(names, state))
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def prefill(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, cache):
    """Run the prompt from a fresh state (whatever ``cache`` holds), writing
    every block's final state into the cache in place. Returns (last-token
    logits (B, 1, V), cache); ``lengths`` is the prompt's length, what
    ``repro``'s prefill leaves in a fresh cache."""
    x = _run(cfg, params, tokens, cache)
    logits = _logits(cfg, params, x[:, -1:])
    cache["lengths"].fill_(tokens.shape[1])
    return logits, cache


def decode_step(cfg: ArchConfig, params: XLSTM, cache, tokens: torch.Tensor):
    """One greedy decode step. tokens: (B, 1) int32, the current token.
    Returns (logits (B, 1, V), cache updated in place)."""
    x = _embed(params, tokens)
    for gi, group in enumerate(params.groups):
        if isinstance(group, SLSTMBlock):
            names = [f"g{gi}.{name}" for name in SLSTM_STATE]
            x, state = slstm_block(cfg, group, x, state=tuple(cache[n] for n in names))
            for n, t in zip(names, state):
                cache[n].copy_(t)
            continue
        names = [f"g{gi}.{name}" for name in MLSTM_STATE]
        for j, block in enumerate(group):
            x, state = mlstm_block_step(cfg, block, x, tuple(cache[n][j] for n in names))
            for n, t in zip(names, state):
                cache[n][j].copy_(t)
    logits = _logits(cfg, params, x)
    cache["lengths"].add_(1)
    return logits, cache
