"""Kernels (``kernels/ops.py``, ``kernels/csrc/decode_attention.cu``): the
least time the decode-attention launches of the profiled stretch could take
(each valid K and V row, q and the output once; ``roofline``) over their
device time, in per cent. Moves ``out_tok_per_s``."""

KERNELS = ("decode_kernel",)


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    spent = sum(d for name, _, d in prof["kernels"] if any(k in name for k in KERNELS)) * 1e-6
    if not spent:
        return None
    rf = ctx["roofline"]
    bound = sum(rf.request_decode_attention_bound_s(ctx["config"], len(d.req.prompt), n)
                for d in prof["requests"] for kind, n, _ in d.spans if kind == "decode")
    return 100.0 * bound / spent
