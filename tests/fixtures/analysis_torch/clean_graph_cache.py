"""The port's GraphCache idiom: one graph a key of shapes, static input and
cache buffers filled before each replay, the output cloned; host work
(clocks, the cycle collector) outside the capture."""
import gc
import time

import torch


class GraphCache:
    def __init__(self):
        self.graphs = {}
        self.caches = {}
        self.capture_ms = {}
        self._weights = ()

    def static_cache(self, key, make):
        if key not in self.caches:
            self.caches[key] = make()
        return self.caches[key]

    def run(self, key, params, inputs, body, cache, static):
        weights = tuple(p.data_ptr() for p in params.parameters())
        if weights != self._weights:
            self.graphs.clear()
            self._weights = weights
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, inputs, body)
        for name, buf in static.items():
            buf.copy_(cache[name])
        g[1].copy_(inputs)
        g[0].replay()
        for name, buf in static.items():
            cache[name].copy_(buf)
        return None if g[2] is None else g[2].clone()

    def _capture(self, key, inputs, body):
        static_inputs = torch.empty(inputs.shape, dtype=inputs.dtype, device=inputs.device)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            output = body(static_inputs)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return graph, static_inputs, output
