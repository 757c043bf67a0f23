"""Backend and compiled surface (``serving/backend.py``,
``models/graphs.py``): the prefill spans of the window over the prompt
tokens they took, per thousand tokens. Moves ``req_ms_p90``."""


def read(ctx):
    spans = [(n, ms) for d in ctx["requests"] for kind, n, ms in d.spans if kind == "prefill"]
    tokens = sum(n for n, _ in spans)
    return sum(ms for _, ms in spans) / (tokens / 1000) if tokens else None
