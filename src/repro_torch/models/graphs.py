"""CUDA graphs of the compiled serving surface, ``Model.prefill_jit`` and
``Model.decode_tokens`` on a CUDA device: the port's counterpart of
``jax.jit``.

jax compiles one executable per static shape and caches it. Here a graph is
captured at the first call of a shape and replayed at every later call:
prefill per ``(B, S, cache_len)``, the whole greedy decode loop per
``(B, cache_len, n_steps)``. A graph keeps the addresses it was captured
with, so its inputs and outputs are static buffers:

* one cache per ``(B, cache_len)`` (:meth:`GraphCache.static_cache`):
  ``{k, v, lengths}``, and for the encoder-decoder family also the cross
  K/V ``cross_k``/``cross_v`` of the encoder's frames. The prefill graphs of
  that bucket write it and its decode graphs read and extend it; a caller
  that passes another cache has every entry copied in before the replay and
  back after it;
* each graph's input, which the caller's is copied into (token ids, or
  an encdec prefill's f32 frames), and its output (prefill's last-token
  logits, the decode loop's ``(B, n_steps)`` int32 tokens), cloned for the
  caller. An encdec prefill has no output: its graph returns None, and what
  it computed is in the static cache.

The weights are read where they lay at capture. When the caller passes
other weight tensors (another module, or a parameter replaced) the graphs
are dropped and captured again for them; weights changed in place need
nothing.

All graphs of a model share one memory pool, so their intermediates take the
room of the largest, not the sum. Before the first capture the kernels are
loaded and the decode kernel's ticket array zeroed
(:func:`repro_torch.kernels.ops.prepare_capture`), and one product runs on
the capture stream, so that cuBLAS makes its handle and workspace for that
stream outside a capture. Nothing else is warmed up: no kernel of the port
is launched outside a request. A capture records launches and runs none;
each replay counts what its capture recorded
(:func:`repro_torch.kernels._build.replayed`). Python's cycle collector runs
before a capture and not during it, so that it cannot free earlier CUDA
objects (another graph, tensors of an earlier request) inside the capture
(``torch.cuda.graph`` no longer collects first by default).

A failed capture raises; nothing falls back to eager execution.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch

from ..kernels import _build, ops


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: torch.Tensor                 # static input
    output: Optional[torch.Tensor]       # static output, rewritten by each replay
    recorded: dict[str, dict[str, int]]  # counter deltas made while captured


class GraphCache:
    """One model's captured graphs and static KV caches.

    ``stats`` counts captures, replays and graphs dropped for new weights;
    ``capture_ms`` holds the wall time of each capture by graph key; ``pool``
    is the handle of the graphs' memory pool (None until the first capture)."""

    def __init__(self) -> None:
        self.caches: dict[tuple, dict[str, torch.Tensor]] = {}
        self.graphs: dict[tuple, _Graph] = {}
        self.capture_ms: dict[tuple, float] = {}
        self.stats = {"captures": 0, "replays": 0, "dropped": 0}
        self.pool = None
        self._params = None      # held, so the captured weight addresses stay valid
        self._weights: tuple = ()
        self._stream = None

    def static_cache(self, key: tuple,
                     make: Callable[[], dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
        if key not in self.caches:
            self.caches[key] = make()
        return self.caches[key]

    def run(self, key: tuple, params: torch.nn.Module, inputs: torch.Tensor,
            body: Callable[[torch.Tensor], Optional[torch.Tensor]],
            cache: dict[str, torch.Tensor],
            static: dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """Replay the graph ``key`` of ``body`` (capturing it first if it is
        new) on ``inputs`` and ``cache``; returns a copy of its output, or
        None where ``body`` returns None. ``body`` maps the static input to
        the output and works on ``static``."""
        for name, buf in static.items():
            if cache[name].shape != buf.shape:
                raise ValueError(f"cache {name} {tuple(cache[name].shape)} does not match "
                                 f"the graph's {tuple(buf.shape)}")
        weights = tuple(p.data_ptr() for p in params.parameters())
        if params is not self._params or weights != self._weights:
            self.stats["dropped"] += len(self.graphs)
            self.graphs.clear()
            self._params, self._weights = params, weights
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, inputs, body,
                                                 next(params.parameters()).dtype)
        foreign = cache is not static
        if foreign:
            for name, buf in static.items():
                buf.copy_(cache[name])
        g.inputs.copy_(inputs)
        g.graph.replay()
        _build.replayed(g.recorded)
        self.stats["replays"] += 1
        if foreign:
            for name, buf in static.items():
                cache[name].copy_(buf)
        return None if g.output is None else g.output.clone()

    def _capture(self, key: tuple, inputs: torch.Tensor,
                 body: Callable[[torch.Tensor], Optional[torch.Tensor]],
                 dtype: torch.dtype) -> _Graph:
        device = inputs.device
        if self.pool is None:
            ops.prepare_capture(device)
            self._stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(self._stream):
                x = torch.ones((16, 16), dtype=dtype, device=device)
                x @ x
        static_inputs = torch.empty(inputs.shape, dtype=inputs.dtype, device=device)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with _build.recording() as recorded:
                with torch.cuda.graph(graph, pool=self.pool, stream=self._stream):
                    output = body(static_inputs)
        finally:
            if collecting:
                gc.enable()
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        self.stats["captures"] += 1
        return _Graph(graph, static_inputs, output, recorded)
