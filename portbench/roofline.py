"""The yardstick's arithmetic: the card's peaks, and the useful operations
and bytes of a served request, counted from a configuration file's sizes
and the request's shape, never from what the program runs.

Useful work: every weight product of each token's forward (a MoE layer at
its ``top_k`` experts, not all of them), attention over the valid rows only
(causal, within a sliding window), a Mamba2 layer's recurrence in its
per-token form (``6 H N P``: decay, input outer product, read-out), logits
for the rows the server reads (the prompt's last position and each decode
step). Norms, activations, rotary positions and the conv's SiLU are left
out (a few per cent of a token's work at these widths).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth, at the full 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2}


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _attn_apps(cfg: dict) -> int:
    """Attention layers a token passes (zamba2: applications of the shared block)."""
    if cfg["family"] == "hybrid":
        e = cfg["hybrid_attn_every"]
        return cfg["n_layers"] // e if e else 0
    return cfg["n_layers"]


def _keys(cfg: dict, pos: int) -> int:
    """Rows the token at 0-based position ``pos`` attends to."""
    w = cfg.get("sliding_window")
    return pos + 1 if w is None else min(pos + 1, w)


def _token_flops(cfg: dict) -> float:
    """Weight products of one token through the stack, without attention
    scores and logits."""
    d, H, K, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    proj = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    if cfg["family"] == "hybrid":
        s = cfg["ssm"]
        di, N = s["expand"] * d, s["d_state"]
        Hs, P = di // N, N
        conv_dim = di + 2 * N
        mamba = (2 * d * (2 * di + 2 * N + Hs) + 2 * s["d_conv"] * conv_dim
                 + 6 * Hs * N * P + 2 * di * d)
        shared = proj + 6 * d * cfg["d_ff"]
        return cfg["n_layers"] * mamba + _attn_apps(cfg) * shared
    if cfg.get("moe"):
        m = cfg["moe"]
        ffn = 6 * d * m["d_expert"] * m["top_k"] + 2 * d * m["n_experts"]
    else:
        ffn = 6 * d * cfg["d_ff"]
    return cfg["n_layers"] * (proj + ffn)


def _score_flops(cfg: dict, keys: int) -> float:
    """QK^T and PV of one query over ``keys`` rows, in one attention layer."""
    return 4 * cfg["n_heads"] * _head_dim(cfg) * keys


def prefill_flops(cfg: dict, S: int) -> float:
    """A prompt of ``S`` tokens, with the last position's logits."""
    scores = sum(_score_flops(cfg, _keys(cfg, p)) for p in range(S))
    return S * _token_flops(cfg) + _attn_apps(cfg) * scores + 2 * cfg["d_model"] * cfg["vocab"]


def decode_flops(cfg: dict, S: int, steps: int) -> float:
    """``steps`` decode steps after a prompt of ``S`` tokens (step ``t``
    feeds the token at position ``S + t``), each with its logits."""
    per = _token_flops(cfg) + 2 * cfg["d_model"] * cfg["vocab"]
    scores = sum(_score_flops(cfg, _keys(cfg, S + t)) for t in range(steps))
    return steps * per + _attn_apps(cfg) * scores


def request_flops(cfg: dict, S: int, T: int) -> float:
    """Useful operations of a request that delivers ``T`` tokens."""
    return prefill_flops(cfg, S) + decode_flops(cfg, S, T)


def _bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def decode_attention_bound_s(cfg: dict, rows: int) -> float:
    """Least time of one decode-attention launch over ``rows`` valid cache
    rows: q and the output once, each valid K and V row once."""
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    b = BYTES[cfg["dtype"]]
    nbytes = (2 * H * hd + 2 * K * rows * hd) * b
    return _bound_s(_score_flops(cfg, rows), nbytes, cfg["dtype"])


def prefill_attention_bound_s(cfg: dict, S: int) -> float:
    """Least time of one causal prefill-attention launch over ``S`` tokens:
    q, k, v and the output once each, scores over the valid rows."""
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    nbytes = (2 * H + 2 * K) * S * hd * BYTES[cfg["dtype"]]
    flops = sum(_score_flops(cfg, _keys(cfg, p)) for p in range(S))
    return _bound_s(flops, nbytes, cfg["dtype"])


def request_decode_attention_bound_s(cfg: dict, S: int, steps: int) -> float:
    """The decode-attention launches of ``steps`` decode steps after a
    prompt of ``S``: one a layer (application) a step."""
    w = cfg.get("sliding_window")
    total = 0.0
    for t in range(steps):
        rows = S + t + 1 if w is None else min(S + t + 1, w)
        total += decode_attention_bound_s(cfg, rows)
    return _attn_apps(cfg) * total


def request_prefill_attention_bound_s(cfg: dict, S: int) -> float:
    return _attn_apps(cfg) * prefill_attention_bound_s(cfg, S)


def window_mfu(cfg: dict, requests, window_s: float) -> float:
    """Useful operations of ``requests`` (each with ``req.prompt`` and its
    delivered ``tokens``) over ``window_s``, as per cent of the bf16 peak."""
    flops = sum(request_flops(cfg, len(d.req.prompt), len(d.tokens)) for d in requests)
    return 100.0 * flops / window_s / PEAK_FLOPS[cfg["dtype"]]
