"""Serving engine (``serving/engine.py``, ``core/substrate.py``): the median
over the window's requests of a request's wall time less its prefill and
decode spans (CUDA events around ``prefill_jit`` and ``decode_tokens``):
the gate's simulation, dispatch, the backend's host work and the reads of
the tokens. Moves ``req_ms_p50``."""
import statistics


def read(ctx):
    host = [d.wall_ms - sum(ms for _, _, ms in d.spans) for d in ctx["requests"] if d.spans]
    return statistics.median(host) if host else None
