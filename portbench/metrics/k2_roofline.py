"""Kernels (``kernels/ops.py``, ``kernels/csrc/flash_attention.cu``): the
least time the prefill-attention launches of the profiled stretch could
take (q, k, v and the output once, scores over the causal rows;
``roofline``) over their device time, in per cent. Moves ``req_ms_p90``."""

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    spent = sum(d for name, _, d in prof["kernels"] if any(k in name for k in KERNELS)) * 1e-6
    if not spent:
        return None
    rf = ctx["roofline"]
    bound = sum(rf.request_prefill_attention_bound_s(ctx["config"], n)
                for d in prof["requests"] for kind, n, _ in d.spans if kind == "prefill")
    return 100.0 * bound / spent
