"""The whole step: the useful operations of the window's requests (prompt
and delivered tokens) over the window's time, as a share of the card's bf16
peak, in per cent. Read in granite-4.0-h's cells. Moves ``req_ms_p90``.

Counted from the configuration, per token: in each Mamba2 layer the
in-projection, the conv, the recurrence in its per-token form (``6 H N P``)
and the out-projection; in each attention layer the projections and the
scores over the causal rows; in every layer the router, ``top_k`` experts
and the shared expert; and the logits at the rows the server reads (the
prompt's last position and each decode step). Norms and activations are
left out."""


def token_flops(cfg: dict) -> tuple[float, float]:
    """(operations of one token through the stack without attention scores
    and logits, scores per key in the attention layers)."""
    d = cfg["d_model"]
    kinds = cfg["layer_types"][:cfg["n_layers"]]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    s, m = cfg["ssm"], cfg["moe"]
    di, N = s["expand"] * d, s["d_state"]
    P = s.get("head_dim") or N
    Hs = di // P
    mamba = (2 * d * (2 * di + 2 * N + Hs) + 2 * s["d_conv"] * (di + 2 * N) + 6 * Hs * N * P
             + 2 * di * d)
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    ffn = 2 * d * m["n_experts"] + 6 * d * m["d_expert"] * (m["top_k"] + m["n_shared"])
    return n_mamba * mamba + n_attn * attn + len(kinds) * ffn, n_attn * 4 * H * hd


def request_flops(cfg: dict, S: int, T: int) -> float:
    """A prompt of ``S`` tokens and ``T`` decode steps (step ``t`` feeds the
    token at position ``S + t``), the logits at ``1 + T`` rows."""
    per, per_key = token_flops(cfg)
    keys = sum(p + 1 for p in range(S + T))
    return (S + T) * per + per_key * keys + (1 + T) * 2 * cfg["d_model"] * cfg["vocab"]


def read(ctx):
    cfg, rf = ctx["config"], ctx["roofline"]
    flops = sum(request_flops(cfg, len(d.req.prompt), len(d.tokens)) for d in ctx["requests"])
    return 100.0 * flops / ctx["window_s"] / rf.PEAK_FLOPS[cfg["dtype"]]
