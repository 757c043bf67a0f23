"""R4: captures inside a loop, a capture keyed per call, compile on the spot."""
import torch


class Graphs:
    def __init__(self):
        self.graphs = {}

    def _capture(self, fn, x):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = fn(x)
        return graph, y

    def run(self, fn, x):
        key = (tuple(x.shape), x.data_ptr())      # a new key for every tensor
        if key not in self.graphs:
            self.graphs[key] = self._capture(fn, x)
        return self.graphs[key]


def every_step(fn, xs):
    out = []
    for x in xs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):             # a new graph per step
            out.append(fn(x))
    return out


def compiled(fn, x):
    return torch.compile(fn)(x)
