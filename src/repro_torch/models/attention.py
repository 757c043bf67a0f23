"""GQA attention: prefill (causal, bidirectional, sliding-window, or cross
attention over given keys and values) and single-token decode against a KV
cache.

Attention runs through the dispatcher, :mod:`repro_torch.kernels.ops`: on a
CUDA tensor the prefill goes to the flash-attention kernel and each decode
step to the decode-attention kernel; on a CPU tensor both go to the plain
versions, which compute what ``repro.kernels.ref`` computes. The
``(B, heads, S, hd)`` layout is kept at those calls, and the weights keep
``repro``'s layout (``wq (d, H, hd)``, ``wo (H, hd, d)``) so the einsums read
the same.

On a mesh (:mod:`repro_torch.distributed.sharding`) a module placed by
``repro_torch.launch.shardings.place_params`` carries a ``tp``: it holds this
rank's heads, and the functions run the rank's local program (Megatron-style:
the heads' partial output is all-reduced after ``wo``), with the K/V cache
split over kv heads, head_dim or length as ``cache_spec`` says (on the card
a head_dim split becomes a length split: the decode kernel reads whole
rows). The kernels see plain local tensors. ``DECODE_ATTN_MODE =
"shard_map"`` runs decode as the explicit flash-decode over a length-sharded
cache (:func:`_sharded_flash_decode`): the decode kernel's log-sum-exp form
on the rank's slice, merged by all-reduces. Without a mesh and a ``tp``
nothing of this runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..distributed import sharding as sh
from ..distributed.sharding import shard
from ..kernels import ops
from .layers import normal_init, rms_norm, rope

# Decode attention strategy:
#   "local" (default) — attention over the rank's cache as it is placed.
#   "shard_map" — explicit flash-decode. The KV cache is sharded along its
#       LENGTH over the model axis; each rank computes its slice's output and
#       log-sum-exp with the decode kernel, the ranks merge them with
#       all-reduces (max, then sums), and the new token row is written by
#       exactly one rank.
DECODE_ATTN_MODE = "local"

# KV-cache update strategy for decode:
#   "scatter" (default) — per-sequence row write; touches only the written
#       row (O(hd) bytes a sequence).
#   "onehot" — masked full-cache blend, the reference's first baseline (kept
#       selectable; its dry-run defaults to it).
CACHE_UPDATE_MODE = "scatter"


class Attention(nn.Module):
    """Weights of one attention block (``repro.models.attention.AttnParams``)."""

    tp: Optional[sh.TensorParallel] = None  # set by launch.shardings.place_params

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 qk_norm: bool, dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wq = param(d_model, n_heads, head_dim)
        self.wk = param(d_model, n_kv_heads, head_dim)
        self.wv = param(d_model, n_kv_heads, head_dim)
        self.wo = param(n_heads, head_dim, d_model)
        self.q_norm = param(head_dim) if qk_norm else None
        self.k_norm = param(head_dim) if qk_norm else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d_model, n_heads, head_dim = self.wq.shape
        s = d_model**-0.5
        so = (n_heads * head_dim) ** -0.5
        for w, scale in ((self.wq, s), (self.wk, s), (self.wv, s), (self.wo, so)):
            w.copy_(normal_init(tuple(w.shape), scale, w.dtype, generator))
        for w in (self.q_norm, self.k_norm):
            if w is not None:
                w.fill_(1.0)


def _write_cache_row(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache: (B, K, S, hd); new: (B, K, 1, hd); slot: (B,) int32.

    ``repro.models.attention._write_cache_row``, done in place: the scatter
    write overwrites row ``slot[b]`` of the preallocated cache and touches
    nothing else (O(hd) bytes a sequence); ``CACHE_UPDATE_MODE = "onehot"``
    blends the whole cache with a one-hot row mask."""
    if CACHE_UPDATE_MODE == "onehot":
        oh = (slot.long()[:, None] == torch.arange(cache.shape[2], device=cache.device))
        oh = oh.to(cache.dtype)[:, None, :, None]  # (B, 1, S, 1)
        cache.copy_(cache * (1.0 - oh) + new.to(cache.dtype) * oh)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot.long()] = new[:, :, 0].to(cache.dtype)


def _project_q(p: Attention, x: torch.Tensor, positions: torch.Tensor,
               rope_theta: float, eps: float, use_rope: bool) -> torch.Tensor:
    """x: (B, S, d) -> q (B, S, H, hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, eps)
    return rope(q, positions, rope_theta) if use_rope else q


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 rope_theta: float, eps: float, use_rope: bool = True):
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, K, hd)."""
    q = _project_q(p, x, positions, rope_theta, eps, use_rope)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm, eps)
    if use_rope:
        k = rope(k, positions, rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


# ---------------------------------------------------------------------------
# The local program on a mesh
# ---------------------------------------------------------------------------


def _model_size() -> int:
    return sh.mesh_size(sh.current_mesh(), sh.MODEL_AXIS)


def _full_heads(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """Every rank's heads (dim 1) of a per-rank block, gathered."""
    return sh.all_gather(x, 1) if sharded else x


def _local_heads(x: torch.Tensor, tp: Optional[sh.TensorParallel]) -> torch.Tensor:
    """This rank's heads (dim 1) of a tensor that holds every head."""
    return sh.local_block(x, 1, sh.MODEL_AXIS) if tp is not None and tp.heads else x


def _kv_for_heads(k: torch.Tensor, tp: sh.TensorParallel, n_q: int) -> torch.Tensor:
    """The kv heads (dim 1 of ``k``, every kv head unless ``tp.kv``) that
    this rank's ``n_q`` query heads read, in the order they read them."""
    if not tp.heads or tp.kv:
        return k
    m = _model_size()
    first, group = sh.coordinate(sh.MODEL_AXIS) * n_q, n_q * m // k.shape[1]
    if first % group == 0 and n_q % group == 0:
        return k[:, first // group:(first + n_q) // group]
    if group % n_q == 0:  # all of this rank's heads read one kv head
        return k[:, first // group:first // group + 1]
    idx = torch.arange(first, first + n_q, device=k.device) // group
    return k.index_select(1, idx)


def _cache_layout(kv: torch.Tensor, tp: sh.TensorParallel) -> torch.Tensor:
    """K or V (B, K_here, S, hd) as computed on this rank (its kv heads if
    ``tp.kv``, else all) in the cache's local layout, length aside."""
    if tp.cache_dim == 1:
        return kv
    kv = _full_heads(kv, tp.kv)
    return sh.local_block(kv, 3, sh.MODEL_AXIS) if tp.cache_dim == 3 else kv


def store_prefill_kv(cache: torch.Tensor, kv: torch.Tensor,
                     tp: Optional[sh.TensorParallel]) -> None:
    """Write a prefill's K or V rows ``kv`` (B, K_here, S, hd) into a placed
    per-layer ``cache`` (B, K, S_c, hd), in the cache's local layout; a
    length-sharded cache keeps the rows of its own slice. Without ``tp``
    the rows are written as they are."""
    if tp is None:
        cache[:, :, :kv.shape[2]] = kv
        return
    kv = _cache_layout(kv, tp)
    if tp.cache_dim == 2:
        rows = cache.shape[2]
        kv = kv[:, :, sh.coordinate(sh.MODEL_AXIS) * rows:][:, :, :rows]
    cache[:, :, :kv.shape[2]] = kv


def _reduce_heads(y: torch.Tensor, tp: Optional[sh.TensorParallel]) -> torch.Tensor:
    """The heads' partial sums of ``wo``'s product, all-reduced."""
    return sh.all_reduce(y) if tp is not None and tp.heads else y


def prefill_attention(
    p: Attention,
    x: torch.Tensor,               # (B, S, d)
    positions: torch.Tensor,       # (B, S)
    *,
    rope_theta: float,
    eps: float,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # (B, S_kv, K, hd)
    sm_scale: Optional[float] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the sequence (causal, or bidirectional with
    ``causal=False``), or with ``cross_kv`` attention of the sequence's
    queries over given keys and values, each optionally within a sliding
    ``window`` (zamba2's shared attention), with softmax scale ``sm_scale``
    (None: 1/sqrt(hd)). Returns (out (B,S,d), (k, v) in (B,K,S,hd) layout). In a sequence-parallel region ``x`` and ``out`` are
    the rank's block of the sequence, ``positions`` and K/V the whole."""
    split = p.tp is not None and p.tp.heads
    x = sh.enter(x, split)
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, positions, rope_theta, eps, use_rope)
    else:
        q = _project_q(p, x, positions, rope_theta, eps, use_rope)
        k, v = cross_kv
    # (B, heads, S, hd) layout for the kernels
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    tp = p.tp
    if tp is None:
        out = ops.flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale, window=window)
    else:
        n_q = qh.shape[1]
        out = ops.flash_attention(qh, _kv_for_heads(kh, tp, n_q), _kv_for_heads(vh, tp, n_q),
                                  causal=causal, sm_scale=sm_scale, window=window)
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p.wo)
    y = shard(sh.leave(y, split), "batch", "seq", None)
    return y, (kh, vh)


def decode_attention_step(
    p: Attention,
    x: torch.Tensor,              # (B, 1, d) current token activations
    k_cache: torch.Tensor,        # (B, K, S, hd), written in place
    v_cache: torch.Tensor,
    lengths: torch.Tensor,        # (B,) int32 current valid length (position of new tok)
    *,
    rope_theta: float,
    eps: float,
    window: Optional[int] = None,
    use_rope: bool = True,
    update_cache: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step, with softmax scale ``sm_scale`` (None: 1/sqrt(hd)). Returns out (B,1,d); the new token's K and V rows are
    written into the caches in place.

    With ``window``, the cache has size S == window and new entries are
    written at position ``lengths % window`` (ring buffer); attention masks
    to the min(lengths, window) most recent entries, which the decode kernel
    computes as it is. RoPE uses absolute positions so rotations stay
    consistent in the ring.

    With ``update_cache=False`` (cross-attention over the encoder's K/V)
    nothing is written and the step attends over the first min(lengths, S)
    rows; the token's own K and V are not computed, since nothing reads them.
    """
    mesh = sh.current_mesh()
    if (DECODE_ATTN_MODE == "shard_map" and update_cache and mesh is not None
            and sh.MODEL_AXIS in mesh.mesh_dim_names) or (p.tp is not None
                                                       and p.tp.cache_dim == 2):
        return _decode_length_sharded(p, x, k_cache, v_cache, lengths, rope_theta=rope_theta,
                                      eps=eps, window=window, use_rope=use_rope,
                                      update_cache=update_cache, sm_scale=sm_scale)
    if p.tp is not None:
        return _decode_placed(p, x, k_cache, v_cache, lengths, rope_theta=rope_theta, eps=eps,
                              window=window, use_rope=use_rope, update_cache=update_cache,
                              sm_scale=sm_scale)
    S = k_cache.shape[2]
    positions = lengths[:, None]  # (B, 1) absolute position of the new token
    if update_cache:
        q, k_new, v_new = _project_qkv(p, x, positions, rope_theta, eps, use_rope)
        slot = lengths % S if window is not None else lengths
        _write_cache_row(k_cache, k_new.transpose(1, 2), slot)
        _write_cache_row(v_cache, v_new.transpose(1, 2), slot)
        valid = torch.clamp(lengths + 1, max=S)
    else:
        q = _project_q(p, x, positions, rope_theta, eps, use_rope)
        valid = torch.clamp(lengths, max=S)
    qh = q.transpose(1, 2).contiguous()       # (B, H, 1, hd)
    out = ops.decode_attention(qh, k_cache, v_cache, valid.to(torch.int32), sm_scale=sm_scale)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p.wo)


def _project_step(p: Attention, x, lengths, S: int, *, rope_theta, eps, window, use_rope,
                  update_cache):
    """q (B, H_here, 1, hd), the new K and V rows (B, K_here, 1, hd) or None,
    the slot they go to and the valid length after the step."""
    positions = lengths[:, None]
    if update_cache:
        q, k_new, v_new = _project_qkv(p, x, positions, rope_theta, eps, use_rope)
        slot = lengths % S if window is not None else lengths
        return (q.transpose(1, 2).contiguous(), k_new.transpose(1, 2), v_new.transpose(1, 2),
                slot, torch.clamp(lengths + 1, max=S))
    q = _project_q(p, x, positions, rope_theta, eps, use_rope)
    return q.transpose(1, 2).contiguous(), None, None, None, torch.clamp(lengths, max=S)


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """This rank's heads of ``out`` (B, H_here, 1, hd) through ``wo``."""
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p.wo)
    return shard(_reduce_heads(y, p.tp), "batch", None, None)


def _decode_placed(p: Attention, x, k_cache, v_cache, lengths, *, rope_theta, eps, window,
                   use_rope, update_cache, sm_scale) -> torch.Tensor:
    """A decode step on this rank's heads over a cache split over kv heads
    (the kernel on the rank's heads), over head_dim (partial scores
    all-reduced, in plain ops), or not split. The decode kernel needs whole
    rows, so the head_dim split runs only off the card (the CPU, the
    dry-run's meta tensors): on a CUDA mesh ``launch.shardings.place_cache``
    places such a cache along its length, which
    :func:`_decode_length_sharded` serves with the kernel."""
    tp = p.tp
    S = k_cache.shape[2]
    qh, k_new, v_new, slot, valid = _project_step(
        p, x, lengths, S, rope_theta=rope_theta, eps=eps, window=window, use_rope=use_rope,
        update_cache=update_cache)
    if k_new is not None:
        _write_cache_row(k_cache, _cache_layout(k_new, tp), slot)
        _write_cache_row(v_cache, _cache_layout(v_new, tp), slot)
    if tp.cache_dim != 3:
        n_q = qh.shape[1]
        out = ops.decode_attention(qh, _kv_for_heads(k_cache, tp, n_q).contiguous(),
                                   _kv_for_heads(v_cache, tp, n_q).contiguous(),
                                   valid.to(torch.int32), sm_scale=sm_scale)
        return _out_proj(p, out)
    # head_dim split: every head's scores over this rank's columns, summed
    if qh.is_cuda:
        raise RuntimeError("a K/V cache split over head_dim has no decode kernel: on the card "
                           "place it with launch.shardings.place_cache (along its length)")
    q_all = _full_heads(qh, tp.heads)
    B, K, _, hd_l = k_cache.shape
    H = q_all.shape[1]
    qs = sh.local_block(q_all, 3, sh.MODEL_AXIS).reshape(B, K, H // K, hd_l).float()
    s = sh.all_reduce(torch.einsum("bkgd,bksd->bkgs", qs, k_cache.float()))
    s = s * (sm_scale if sm_scale is not None else 1.0 / math.sqrt(q_all.shape[-1]))
    keep = torch.arange(S, device=s.device) < valid[:, None]
    s = s.masked_fill(~keep[:, None, None], -1e30)
    o = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1), v_cache.float())
    out = sh.all_gather(o.reshape(B, H, 1, hd_l), 3).to(qh.dtype)
    return _out_proj(p, _local_heads(out, tp))


def _decode_length_sharded(p: Attention, x, k_cache, v_cache, lengths, *, rope_theta, eps,
                           window, use_rope, update_cache, sm_scale) -> torch.Tensor:
    """A decode step over a cache sharded along its length over the model
    axis: every head's query, this rank's slice of the keys."""
    tp = p.tp
    if tp is not None and tp.cache_dim != 2:
        raise ValueError("the length-sharded decode needs the cache placed along its length "
                         "(launch.shardings.FORCE_SEQ_SHARD_CACHE)")
    heads, kv = tp is not None and tp.heads, tp is not None and tp.kv
    S = k_cache.shape[2] * _model_size()
    qh, k_new, v_new, slot, valid = _project_step(
        p, x, lengths, S, rope_theta=rope_theta, eps=eps, window=window, use_rope=use_rope,
        update_cache=update_cache)
    if k_new is not None:
        k_new, v_new = _full_heads(k_new, kv), _full_heads(v_new, kv)
    out = _sharded_flash_decode(_full_heads(qh, heads), k_cache, v_cache, k_new, v_new, slot,
                                valid, sm_scale=(sm_scale if sm_scale is not None
                                                 else 1.0 / math.sqrt(qh.shape[-1])))
    return _out_proj(p, _local_heads(out, tp))


def _sharded_flash_decode(
    q: torch.Tensor,        # (B, H, 1, hd), every head
    k_cache: torch.Tensor,  # (B, K, S_loc, hd): this rank's slice of the length
    v_cache: torch.Tensor,
    k_new: Optional[torch.Tensor],  # (B, K, 1, hd), or None: nothing is written
    v_new: Optional[torch.Tensor],
    slot: Optional[torch.Tensor],   # (B,) global write position
    valid: torch.Tensor,    # (B,) valid prefix length after the write
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Flash-decode over a length-sharded cache: this rank's slice
    (:func:`flash_decode_slice`), merged across the model axis by
    all-reduces (:func:`merge_slices`). Returns (B, H, 1, hd) in q's dtype."""
    start = sh.coordinate(sh.MODEL_AXIS) * k_cache.shape[2]
    out, lse = flash_decode_slice(q, k_cache, v_cache, k_new, v_new, slot, valid, start,
                                  sm_scale=sm_scale)
    return merge_slices(out, lse, lambda t, op: sh.all_reduce(t.clone(), sh.MODEL_AXIS, op))


def flash_decode_slice(q, k_cache, v_cache, k_new, v_new, slot, valid, start: int, *,
                       sm_scale: float):
    """The local half of the flash-decode, on the slice of the cache whose
    first row is global row ``start`` (shapes as :func:`_sharded_flash_decode`'s):
    writes a sequence's new K/V row if its global ``slot`` falls in the
    slice, then runs the decode kernel's log-sum-exp form over the slice's
    share of ``valid``. Returns (out (B, H, 1, hd), lse (B, H) f32); a slice
    with no valid row has lse -inf."""
    B, _, S_loc, _ = k_cache.shape
    if k_new is not None:
        local = slot.long() - start
        inside = (local >= 0) & (local < S_loc)
        local = local.clamp(0, S_loc - 1)
        rows = torch.arange(B, device=k_cache.device)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            old = cache[rows, :, local]  # (B, K, hd)
            cache[rows, :, local] = torch.where(inside[:, None, None],
                                                new[:, :, 0].to(cache.dtype), old)
    n_valid = (valid - start).clamp(0, S_loc).to(torch.int32)
    return ops.decode_attention(q, k_cache, v_cache, n_valid, sm_scale=sm_scale,
                                return_lse=True)


def merge_slices(out: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """The slices' outputs merged by ``repro``'s algebra
    (``repro/models/attention.py:165-174``): the max of the log-sum-exps,
    then the sums of the weights and of the weighted outputs; a slice with
    lse -inf has weight 0. ``reduce(t, op)`` reduces ``t`` across the
    slices with ``op`` ("max" or "sum"): the all-reduce on a mesh, or a
    reduction over a leading dim that stacks the slices. Returns out's
    dtype."""
    m = reduce(lse, "max")
    w = torch.where(lse > float("-inf"), torch.exp(lse - m), torch.zeros_like(lse))
    l_sum = reduce(w, "sum")
    acc = reduce(w[..., None, None] * out.float(), "sum")
    return (acc / l_sum.clamp_min(1e-20)[..., None, None]).to(out.dtype)
