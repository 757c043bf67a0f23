"""Model (``models/model.py`` and the family's modules): kernels that the
decode replays of the profiled stretch ran, over the steps they replayed.
Moves ``out_tok_per_s``."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    steps = sum(n for d in prof["requests"] for kind, n, _ in d.spans if kind == "decode")
    return prof["decode_kernels"] / steps if steps and prof["decode_kernels"] else None
