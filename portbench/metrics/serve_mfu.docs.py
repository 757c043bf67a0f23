"""The whole step: the useful operations of the window's requests (prompt
and delivered tokens, counted from the configuration by ``roofline``) over
the window's time, as a share of the card's bf16 peak, in per cent. Read
in the document cells. Moves ``req_ms_p90``."""


def read(ctx):
    return ctx["roofline"].window_mfu(ctx["config"], ctx["requests"], ctx["window_s"])
