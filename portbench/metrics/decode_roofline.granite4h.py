"""Model (``models/hybrid_moe.py``, ``models/moe.py``): the least time of
the window's decode steps (every step its decode spans replayed, padded
bucket steps included) over those spans' time, in per cent. Read in
granite-4.0-h's cells. Moves ``out_tok_per_s``.

A decode step at batch 1 is bound by bytes: the least it reads is each
weight that a top-k step needs once (the Mamba2 and attention layers', the
routers', ``top_k`` experts and the shared expert of every layer, the tied
embedding for the logits), the SSD and conv states read and written, and
the valid K/V rows of the attention layers, at the card's bandwidth
(``roofline``). The dense dispatch, which reads every expert, shows here."""


def step_bytes(cfg: dict, rows: int) -> float:
    """Least bytes of one decode step whose token sits at position ``rows``
    (the K/V rows before it valid)."""
    d, V = cfg["d_model"], cfg["vocab"]
    b = 2 if cfg["dtype"] == "bfloat16" else 4
    kinds = cfg["layer_types"][:cfg["n_layers"]]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    s, m = cfg["ssm"], cfg["moe"]
    di, N, Kc = s["expand"] * d, s["d_state"], s["d_conv"]
    P = s.get("head_dim") or N
    Hs, conv_dim = di // P, di + 2 * N
    mamba_w = (d * (2 * di + 2 * N + Hs) + (Kc + 1) * conv_dim + di * d + di + d) * b + 3 * Hs * 4
    mamba_state = 2 * (Hs * N * P * 4 + (Kc - 1) * conv_dim * b)
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn_w = (2 * d * H * hd + 2 * d * K * hd + d) * b
    kv = 2 * K * hd * (rows + 1) * b  # the new row written, then read with the others
    ffn = d * m["n_experts"] * 4 + (3 * d * m["d_expert"] * (m["top_k"] + m["n_shared"]) + d) * b
    return (n_mamba * (mamba_w + mamba_state) + n_attn * (attn_w + kv) + len(kinds) * ffn
            + (V * d + d) * b)


def read(ctx):
    cfg, rf = ctx["config"], ctx["roofline"]
    least = spent = 0.0
    for d in ctx["requests"]:
        S = len(d.req.prompt)
        for kind, n, ms in d.spans:
            if kind == "decode":
                least += sum(step_bytes(cfg, S + t) for t in range(n)) / rf.PEAK_BYTES_PER_S
                spent += ms * 1e-3
    return 100.0 * least / spent if spent else None
