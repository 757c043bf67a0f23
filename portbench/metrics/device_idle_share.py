"""Device: the share of the profiled stretch in which no operation ran on
the card, in per cent. Moves ``out_tok_per_s``."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
