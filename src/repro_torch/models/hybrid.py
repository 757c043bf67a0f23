"""Mamba2 block and the Zamba2 hybrid model (arXiv:2411.15242), the port of
``repro.models.hybrid``.

Zamba2: a backbone of Mamba2 blocks with ONE shared transformer block
(attention + SwiGLU) whose weights are re-applied after every
``cfg.hybrid_attn_every`` Mamba layers (the paper's parameter sharing; the
per-application LoRA deltas are omitted, as in ``repro``). The shared block
uses sliding-window attention when ``cfg.sliding_window`` is set, which keeps
the model sub-quadratic for long contexts.

On the card the shared block's prefill runs the flash-attention kernel
(causal, with the window) and each of its decode steps the decode-attention
kernel over a ring of ``min(max_len, window)`` rows: one launch of each an
application. Each Mamba2 block's prefill runs the SSD kernel
(``ops.ssd_chunked``, one call a layer; the plain scan under autograd); its
decode step computes in plain PyTorch ops (:mod:`repro_torch.models.ssm`).
The cache is a flat dict of tensors, written in place: ``h`` (layers, B, H,
N, P) f32 SSD states, ``conv`` (layers, B, d_conv - 1, conv_dim) the causal
conv's last inputs, ``attn_k``/``attn_v`` (applications, B, K, rows, hd) and
``lengths``. Prefill starts every layer from a zero state, as ``repro``'s
does (it reads no state from the cache), so a reused cache holds nothing of
an earlier request that decode reads.

In training (:func:`loss_fn`) ``remat`` recomputes each Mamba2 block in the
backward and keeps the shared block's activations, as ``repro`` wraps only
the Mamba scan's body in ``jax.checkpoint``; the shared block's gradient sums
over its applications.

On a mesh a model placed by ``launch.shardings.place_params`` runs its local
program on the blocks that ``repro``'s specs place: the vocab-split
embedding and logits, the shared block's attention and SwiGLU as the
transformer's, and in each Mamba2 block (``tp.heads``; its heads, conv
channels and ``w_out`` rows split together) the rank's heads. ``w_in`` is
whole, so every rank computes the whole packed projection [x, z, B, C, dt];
the rank runs the causal conv on its block of the conv channels (its
``conv_w``/``conv_b`` and ``conv`` state), whose output is all-gathered
(one all-gather of B x S x conv_dim a block), because a rank's conv block
is not its heads' channels (at zamba2-1.2b on 16 ranks a block is 264 of
the 4,224 channels; a rank's 4 heads read 256 channels of x and all of B
and C). An all-to-all of the x channels and a broadcast of B and C would
move less, about 384 of the 4,224 channels a rank; the port's collectives
are all-reduce, all-gather and reduce-scatter, and of these the all-gather
moves least. The SSD then runs on the rank's heads (its slices of ``dt``,
``A_log``, ``D``, ``dt_bias``, its block of ``h``), ``ynorm`` normalises
over the whole d_inner with one all-reduce of the rows' mean squares, and
``w_out``'s partial product is all-reduced.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from .. import trace
from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..distributed.sharding import shard
from ..kernels import ops
from .attention import Attention, decode_attention_step, prefill_attention, store_prefill_kv
from .layers import (SwiGLU, cross_entropy, embed, normal_init, parameter, remat as _remat,
                     rms_norm, rms_norm_split, unembed, unembed_input)
from .ssm import softplus, ssd_step


def _dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    N = ssm.d_state
    P = ssm.head_dim or N  # head dim; zamba2's equals d_state
    H = d_inner // P
    return d_inner, H, P, N


class MambaBlock(nn.Module):
    """One Mamba2 block's weights (``repro``'s ``init_mamba_block``)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        d_inner, H, P, N = _dims(cfg)
        conv_dim = d_inner + 2 * N
        self.ln = parameter((d,), dt, device)
        # in_proj -> [x (d_inner), z (d_inner), B (N), C (N), dt (H)]
        self.w_in = parameter((d, 2 * d_inner + 2 * N + H), dt, device)
        self.conv_w = parameter((cfg.ssm.d_conv, conv_dim), dt, device)
        self.conv_b = parameter((conv_dim,), dt, device)
        self.A_log = parameter((H,), torch.float32, device)
        self.D = parameter((H,), torch.float32, device)
        self.dt_bias = parameter((H,), torch.float32, device)
        self.ynorm = parameter((d_inner,), dt, device)
        self.w_out = parameter((d_inner, d), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d, d_inner = self.w_in.shape[0], self.w_out.shape[0]
        H = self.A_log.shape[0]
        self.ln.fill_(1.0)
        self.w_in.copy_(normal_init(tuple(self.w_in.shape), d**-0.5, self.w_in.dtype, generator))
        self.conv_w.copy_(normal_init(tuple(self.conv_w.shape), 0.5, self.conv_w.dtype, generator))
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.ynorm.fill_(1.0)
        self.w_out.copy_(normal_init(tuple(self.w_out.shape), d_inner**-0.5, self.w_out.dtype,
                                     generator))


class SharedBlock(nn.Module):
    """The shared transformer block: ``ln1``, attention, ``ln2``, SwiGLU."""

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = parameter((cfg.d_model,), dt, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.qk_norm, dt, device)
        self.ln2 = parameter((cfg.d_model,), dt, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.attn.init(generator)
        self.ln2.fill_(1.0)
        self.mlp.init(generator)


class Zamba2(nn.Module):
    """The parameters of one hybrid model (``repro``'s ``params`` dict):
    ``embed``, ``mamba`` (one block a layer, in place of the stacked tree),
    ``final_norm``, ``unembed`` and, with ``hybrid_attn_every``, the one
    ``shared_attn`` block."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, cfg: ArchConfig, device: torch.device) -> None:
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = parameter((cfg.vocab, cfg.d_model), dt, device)
        self.mamba = nn.ModuleList(MambaBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = parameter((cfg.d_model,), dt, device)
        self.unembed = parameter((cfg.d_model, cfg.vocab), dt, device)
        self.shared_attn = SharedBlock(cfg, device) if cfg.hybrid_attn_every else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Zamba2":
        """``repro``'s scales (its values come from ``jax.random``)."""
        cfg = self.cfg
        self.embed.copy_(normal_init((cfg.vocab, cfg.d_model), 1.0, self.embed.dtype, generator))
        for block in self.mamba:
            block.init(generator)
        self.final_norm.fill_(1.0)
        self.unembed.copy_(normal_init((cfg.d_model, cfg.vocab), cfg.d_model**-0.5,
                                       self.unembed.dtype, generator))
        if self.shared_attn is not None:
            self.shared_attn.init(generator)
        return self


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, ctx=None):
    """Depthwise causal conv. seq: (B, S, C); w: (K, C). ctx: (B, K-1, C)
    previous inputs (decode) or None (prefill pads with zeros). The K terms
    are summed from 0 in ``repro``'s order. Returns (out (B,S,C), new_ctx
    (B, K-1, C))."""
    K, S = w.shape[0], seq.shape[1]
    if ctx is None:
        ctx = seq.new_zeros((seq.shape[0], K - 1, seq.shape[2]))
    full = torch.cat([ctx, seq], dim=1)
    out = sum(full[:, i : i + S] * w[i][None, None, :] for i in range(K))
    out = out + b[None, None, :]
    return F.silu(out), full[:, -(K - 1):, :]


def _split(p: MambaBlock) -> bool:
    """Whether the block's heads, conv channels and rows are split."""
    return p.tp is not None and p.tp.heads


def _mamba_mix(cfg: ArchConfig, p: MambaBlock, x, ctx):
    """The projections and the conv: (xs, z, Bm, Cm, dt f32, A, D, new_ctx);
    on a split block xs, dt, A and D of the rank's heads, z its block of
    d_inner, the conv and ``ctx`` on its block of the channels (the
    module's docstring says why its output is all-gathered)."""
    d_inner, H, P, N = _dims(cfg)
    split = _split(p)
    xs, z, Bm, Cm, dt = _mamba_proj(cfg, p, x)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    dt_bias, A_log, D = p.dt_bias, p.A_log, p.D
    if split:
        conv_in = sh.local_block(conv_in, 2, sh.MODEL_AXIS)
        z, dt = sh.local_block(z, 2, sh.MODEL_AXIS), sh.local_block(dt, 2, sh.MODEL_AXIS)
        dt_bias, A_log, D = (sh.local_block(t, 0, sh.MODEL_AXIS) for t in (dt_bias, A_log, D))
    conv_out, new_ctx = _causal_conv(conv_in, p.conv_w, p.conv_b, ctx)
    if split:  # each rank's heads read their own part of it: the gradient is summed
        conv_out = sh.all_gather(conv_out, 2, sum_grad=True)
    xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    if split:
        xs = sh.local_block(xs, 2, sh.MODEL_AXIS)
    dt = softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    return xs, z, Bm, Cm, dt, A, D, new_ctx


def _mamba_out(cfg: ArchConfig, p: MambaBlock, y, z):
    """The gated norm and the out projection: the mixer's output, without
    the residual."""
    split = _split(p)
    y = rms_norm_split(y * F.silu(z), p.ynorm, cfg.norm_eps, split)
    return sh.leave(y @ p.w_out, split)


def _mamba_in(cfg: ArchConfig, p: MambaBlock, x):
    """The normalised input; where the block is split it enters the split
    region (Megatron's f)."""
    return sh.enter(rms_norm(x, p.ln, cfg.norm_eps), _split(p))


def _mamba_proj(cfg: ArchConfig, p: MambaBlock, x):
    d_inner, H, P, N = _dims(cfg)
    u = _mamba_in(cfg, p, x) @ p.w_in
    return torch.split(u, [d_inner, d_inner, N, N, H], dim=-1)  # xs, z, Bm, Cm, dt


def mamba_mixer(cfg: ArchConfig, p: MambaBlock, x, use_kernel: bool = True):
    """x: (B,S,d), from a zero state. Returns (the mixer's output, (h
    (B,H,N,P), conv ctx)), the state of the rank's heads and channels on a
    split block."""
    d_inner, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    xs, z, Bm, Cm, dt, A, D, new_ctx = _mamba_mix(cfg, p, x, None)
    y, h = ops.ssd_chunked(xs.reshape(B, S, -1, P), dt, A, Bm, Cm, D, chunk=cfg.ssm.chunk,
                           use_kernel=use_kernel)
    return _mamba_out(cfg, p, y.reshape(B, S, -1), z), (h, new_ctx)


def mamba_mixer_step(cfg: ArchConfig, p: MambaBlock, x, state):
    """x: (B,1,d); state: (h, conv ctx). Returns (the mixer's output, (h,
    conv ctx)), new tensors."""
    d_inner, H, P, N = _dims(cfg)
    B = x.shape[0]
    h, ctx = state
    xs, z, Bm, Cm, dt, A, D, new_ctx = _mamba_mix(cfg, p, x, ctx)
    y, h = ssd_step(xs[:, 0].reshape(B, -1, P), dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, h)
    return _mamba_out(cfg, p, y.reshape(B, 1, -1), z), (h, new_ctx)


def mamba_block(cfg: ArchConfig, p: MambaBlock, x, use_kernel: bool = True):
    """x: (B,S,d), from a zero state. Returns (x + the mixer's output, (h
    (B,H,N,P), conv ctx))."""
    y, state = mamba_mixer(cfg, p, x, use_kernel)
    return x + y, state


def mamba_block_step(cfg: ArchConfig, p: MambaBlock, x, state):
    """x: (B,1,d); state: (h, conv ctx). Returns (x + the mixer's output,
    (h, conv ctx)), new tensors."""
    y, state = mamba_mixer_step(cfg, p, x, state)
    return x + y, state


# ---------------------------------------------------------------------------
# Zamba2
# ---------------------------------------------------------------------------


def _n_attn(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0


def _group_sizes(cfg: ArchConfig) -> list[int]:
    """Mamba-run lengths between shared-attention applications."""
    if not cfg.hybrid_attn_every:
        return [cfg.n_layers]
    e = cfg.hybrid_attn_every
    sizes = [e] * (cfg.n_layers // e)
    if cfg.n_layers % e:
        sizes.append(cfg.n_layers % e)
    return sizes


def _groups(cfg: ArchConfig):
    """(group index, its layers' indices, whether the shared block follows)."""
    start = 0
    for gi, size in enumerate(_group_sizes(cfg)):
        yield gi, range(start, start + size), gi < _n_attn(cfg)
        start += size


def _shared_attn_prefill(cfg: ArchConfig, p: SharedBlock, x, positions, use_kernel):
    h, (k, v) = prefill_attention(
        p.attn, rms_norm(x, p.ln1, cfg.norm_eps), positions,
        rope_theta=cfg.rope_theta, eps=cfg.norm_eps, causal=True,
        window=cfg.sliding_window, use_kernel=use_kernel,
    )
    x = x + h
    return x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps)), (k, v)


def _embed(params: Zamba2, tokens: torch.Tensor):
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    return shard(embed(params.embed, tokens, params.tp), "batch", "seq", None), positions


def _logits(cfg: ArchConfig, params: Zamba2, x):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(unembed_input(x, params.tp), params.unembed)


def forward(cfg: ArchConfig, params: Zamba2, tokens: torch.Tensor, *, remat: bool = True,
            use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass over ``tokens`` (B, S). Returns (logits (B, S, V),
    aux loss 0 as a 0-dim f32 tensor). ``remat`` recomputes each Mamba2
    block in the backward. FSDP parameters are gathered for the block that
    reads them, and again in its recompute (:func:`sh.gathered`)."""
    with sh.gathered(params, recurse=False):
        x, positions = _embed(params, tokens)
        for _, layers, attn in _groups(cfg):
            for li in layers:

                def body(x, p=params.mamba[li]):
                    with sh.gathered(p):
                        return mamba_block(cfg, p, x, use_kernel)[0]

                x = _remat(body, x) if remat else body(x)
            if attn:
                with sh.gathered(params.shared_attn):
                    x, _ = _shared_attn_prefill(cfg, params.shared_attn, x, positions,
                                                use_kernel)
        logits = _logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ArchConfig, params: Zamba2, batch, *, remat: bool = True,
            use_kernel: bool = True):
    """batch: {"tokens", "labels"} (B, S). Returns (ce + aux, {"ce", "nll",
    "aux"}), 0-dim f32 tensors."""
    logits, aux = forward(cfg, params, batch["tokens"], remat=remat, use_kernel=use_kernel)
    ce, nll = cross_entropy(logits, batch["labels"], tp=params.tp)
    return ce + aux, {"ce": ce, "nll": nll, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device) -> dict[str, torch.Tensor]:
    """SSD states, conv contexts, and the shared block's KV ring of
    ``min(max_len, window)`` rows an application."""
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N
    cache = {
        "h": torch.zeros((cfg.n_layers, batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.d_conv - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    n_attn = _n_attn(cfg)
    if n_attn:
        S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shape = (n_attn, batch, cfg.n_kv_heads, S, cfg.head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
    return cache


def prefill(cfg: ArchConfig, params: Zamba2, tokens: torch.Tensor, cache, *,
            use_kernel: bool = True):
    """Run the prompt from a zero state, writing each layer's SSD state and
    conv context and each application's K/V rows into the cache in place.
    Returns (last-token logits (B, 1, V), cache). Without a sliding window a
    prompt longer than the cache raises ValueError, as in the transformer."""
    B, S = tokens.shape
    window = cfg.sliding_window
    S_c = cache["attn_k"].shape[3] if "attn_k" in cache else 0
    tp = params.shared_attn.attn.tp if params.shared_attn is not None else None
    if tp is not None and tp.cache_dim == 2:  # this rank's slice of the rows
        S_c *= sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS)
    if "attn_k" in cache and window is None and S > S_c:
        raise ValueError(f"prompt of {S} tokens is longer than the cache's {S_c} rows")
    x, positions = _embed(params, tokens)
    for gi, layers, attn in _groups(cfg):
        for li in layers:
            with trace.scope("mamba2"):
                x, (h, ctx) = mamba_block(cfg, params.mamba[li], x, use_kernel)
                cache["h"][li].copy_(h)
                cache["conv"][li].copy_(ctx)
        if attn:
            with trace.scope("shared_block"):
                x, (k, v) = _shared_attn_prefill(cfg, params.shared_attn, x, positions,
                                                 use_kernel)
                if S > S_c:
                    # keep the last `window` positions; ring alignment: slot = pos % window
                    shift = (S - S_c) % S_c
                    k = torch.roll(k[:, :, -S_c:], shifts=shift, dims=2)
                    v = torch.roll(v[:, :, -S_c:], shifts=shift, dims=2)
                store_prefill_kv(cache["attn_k"][gi], k, tp)
                store_prefill_kv(cache["attn_v"][gi], v, tp)
    with trace.scope("logits"):
        logits = _logits(cfg, params, x[:, -1:])
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(cfg: ArchConfig, params: Zamba2, cache, tokens: torch.Tensor, *,
                use_kernel: bool = True):
    """One greedy decode step. tokens: (B, 1) int32, the current token.
    Returns (logits (B, 1, V), cache updated in place: each new state is
    computed, then copied in)."""
    x = shard(embed(params.embed, tokens, params.tp), "batch", "seq", None)
    lengths = cache["lengths"]
    for gi, layers, attn in _groups(cfg):
        for li in layers:
            with trace.scope("mamba2"):
                x, (h, ctx) = mamba_block_step(cfg, params.mamba[li], x,
                                               (cache["h"][li], cache["conv"][li]))
                cache["h"][li].copy_(h)
                cache["conv"][li].copy_(ctx)
        if attn:
            p = params.shared_attn
            with trace.scope("shared_block"):
                h_att = decode_attention_step(
                    p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cache["attn_k"][gi],
                    cache["attn_v"][gi], lengths, rope_theta=cfg.rope_theta, eps=cfg.norm_eps,
                    window=cfg.sliding_window, use_kernel=use_kernel,
                )
                x = x + h_att
                x = x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps))
    with trace.scope("logits"):
        logits = _logits(cfg, params, x)
    lengths.add_(1)
    return logits, cache
