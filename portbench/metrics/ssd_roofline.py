"""Kernels (``kernels/ops.py``, ``kernels/csrc/ssd_chunk.cu``): the least
time the SSD scans of the profiled stretch's prefills could take, over the
device time of the SSD kernel's three launches, in per cent. Moves
``req_ms_p90``.

The least time of one Mamba2 layer's scan over a prompt of ``S`` tokens is
counted from the configuration as the chunked dual form at its chunk ``L``
with the causal half: in each chunk of ``Lc`` positions C.B once (one group
of B and C) and, in each head, the scores times x, the read-out of the
carried state and the chunk's own state; and the bytes of x, y, B, C and dt
once and the final state once; the larger of operations at the card's bf16
peak and bytes at its bandwidth (``roofline``'s peaks, so no implementation
can read above 100%)."""

KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")


def scan_flops_bytes(cfg: dict, S: int) -> tuple[float, float]:
    """Operations and bytes of one Mamba2 layer's chunked scan over ``S``."""
    s = cfg["ssm"]
    di, N = s["expand"] * cfg["d_model"], s["d_state"]
    P = s.get("head_dim") or N
    H, L = di // P, s["chunk"]
    flops = 0.0
    for c0 in range(0, S, L):
        Lc = min(L, S - c0)
        tri = Lc * (Lc + 1) / 2
        flops += 2 * N * tri + H * (2 * P * tri + 4 * Lc * N * P)
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    nbytes = (2 * S * H * P + 2 * S * N) * elem + S * H * 4 + H * N * P * 4
    return flops, nbytes


def request_bound_s(cfg: dict, S: int, rf) -> float:
    layers = cfg["layer_types"][:cfg["n_layers"]].count("mamba")
    flops, nbytes = scan_flops_bytes(cfg, S)
    return layers * max(flops / rf.PEAK_FLOPS["bfloat16"], nbytes / rf.PEAK_BYTES_PER_S)


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    spent = sum(d for name, _, d in prof["kernels"] if any(k in name for k in KERNELS)) * 1e-6
    if not spent:
        return None
    bound = sum(request_bound_s(ctx["config"], n, ctx["roofline"])
                for d in prof["requests"] for kind, n, _ in d.spans if kind == "prefill")
    return 100.0 * bound / spent
