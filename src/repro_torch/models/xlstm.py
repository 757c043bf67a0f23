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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from .layers import cross_entropy, normal_init, parameter, remat as _remat, rms_norm, unembed
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


def _mlstm_qkv(cfg: ArchConfig, p: MLSTMBlock, x):
    d_inner, H, P = _dims(cfg)
    u = rms_norm(x, p.ln, cfg.norm_eps) @ p.w_up
    a, z = torch.chunk(u, 2, dim=-1)
    a = sh.shard(a, "batch", None, "ff")
    B, S = x.shape[:2]
    ah = a.reshape(B, S, H, P)
    q = torch.einsum("bshp,hpr->bshr", ah, p.wq)
    k = torch.einsum("bshp,hpr->bshr", ah, p.wk)
    v = torch.einsum("bshp,hpr->bshr", ah, p.wv)
    ig = a @ p.w_i + p.b_i.float()
    fg = a @ p.w_f + p.b_f.float()
    return q, k, v, ig, fg, z


def _mlstm_out(cfg: ArchConfig, p: MLSTMBlock, x, h, z):
    h = h.reshape(x.shape[0], x.shape[1], -1)
    h = rms_norm(h, p.hnorm, cfg.norm_eps) * F.silu(z)
    return x + h @ p.w_down


def mlstm_block(cfg: ArchConfig, p: MLSTMBlock, x, *, chunk: int):
    """x: (B,S,d), from a fresh state. Returns (y, (C, n, m))."""
    q, k, v, ig, fg, z = _mlstm_qkv(cfg, p, x)
    h, state = mlstm_chunked(q, k, v, ig, fg, chunk=chunk)
    return _mlstm_out(cfg, p, x, h, z), state


def mlstm_block_step(cfg: ArchConfig, p: MLSTMBlock, x, state):
    """x: (B,1,d); single-token decode. Returns (y, new (C, n, m))."""
    q, k, v, ig, fg, z = _mlstm_qkv(cfg, p, x)
    h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0], state)
    return _mlstm_out(cfg, p, x, h, z), state


def slstm_block(cfg: ArchConfig, p: SLSTMBlock, x, *, state=None):
    """x: (B,S,d); ``state`` None is a fresh one. Returns (y, (c, n, h, m))."""
    B, S, d = x.shape
    H = cfg.n_heads
    xg = rms_norm(x, p.ln, cfg.norm_eps) @ p.w_gates + p.b_gates.float()
    h, state = slstm_scan(xg.reshape(B, S, 4, H, d // H), p.R, state=state)
    h = rms_norm(h.reshape(B, S, -1).to(x.dtype), p.hnorm, cfg.norm_eps)
    return x + h @ p.w_out, state


def _chunk(cfg: ArchConfig) -> int:
    return cfg.ssm.chunk if cfg.ssm else 256


def _run(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, cache=None, remat=False):
    """The stack over ``tokens`` from a fresh state; with ``cache``, each
    block's final state is copied into it; ``remat`` recomputes each mLSTM
    block in the backward. Returns the last layer's output."""
    x = sh.shard(params.embed[tokens.long()], "batch", "seq", None)
    for gi, group in enumerate(params.groups):
        if isinstance(group, SLSTMBlock):
            x, state = slstm_block(cfg, group, x)
            if cache is not None:
                for name, t in zip(SLSTM_STATE, state):
                    cache[f"g{gi}.{name}"].copy_(t)
            continue
        for j, block in enumerate(group):

            def body(x, p=block):
                return mlstm_block(cfg, p, x, chunk=_chunk(cfg))

            x, state = _remat(body, x) if remat else body(x)
            if cache is not None:
                for name, t in zip(MLSTM_STATE, state):
                    cache[f"g{gi}.{name}"][j].copy_(t)
    return x


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, *, remat: bool = True,
            use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass over ``tokens`` (B, S). Returns (logits (B, S, V),
    aux loss 0 as a 0-dim f32 tensor). ``remat`` recomputes each mLSTM block
    in the backward. ``use_kernel`` is accepted for the common surface; no
    kernel is on this path."""
    x = rms_norm(_run(cfg, params, tokens, remat=remat), params.final_norm, cfg.norm_eps)
    logits = unembed(x, params.unembed)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ArchConfig, params: XLSTM, batch, *, remat: bool = True,
            use_kernel: bool = True):
    """batch: {"tokens", "labels"} (B, S). Returns (ce + aux, {"ce", "nll",
    "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat, use_kernel=use_kernel)
    ce, nll = cross_entropy(logits, batch["labels"])
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


def prefill(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, cache, *,
            use_kernel: bool = True):
    """Run the prompt from a fresh state (whatever ``cache`` holds), writing
    every block's final state into the cache in place. Returns (last-token
    logits (B, 1, V), cache); ``lengths`` is the prompt's length, what
    ``repro``'s prefill leaves in a fresh cache."""
    x = _run(cfg, params, tokens, cache)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = unembed(x, params.unembed)
    cache["lengths"].fill_(tokens.shape[1])
    return logits, cache


def decode_step(cfg: ArchConfig, params: XLSTM, cache, tokens: torch.Tensor, *,
                use_kernel: bool = True):
    """One greedy decode step. tokens: (B, 1) int32, the current token.
    Returns (logits (B, 1, V), cache updated in place)."""
    x = sh.shard(params.embed[tokens.long()], "batch", "seq", None)
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
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(x, params.unembed)
    cache["lengths"].add_(1)
    return logits, cache
