"""Backend and compiled surface (``serving/backend.py``,
``models/graphs.py``): the decode spans of the window over the decode steps
they replayed, padded bucket steps included. Moves ``out_tok_per_s``."""


def read(ctx):
    spans = [(n, ms) for d in ctx["requests"] for kind, n, ms in d.spans if kind == "decode"]
    steps = sum(n for n, _ in spans)
    return sum(ms for _, ms in spans) / steps if steps else None
