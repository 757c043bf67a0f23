"""R5: captured code rebinding the state it carries."""
import torch


def _update(cache, state, x):
    cache["h"] = cache["h"] * 0.5 + x             # a new tensor under the old name
    state = state + x                             # the caller's buffer is untouched
    return cache


class Step:
    def __init__(self, x):
        self.state = torch.zeros_like(x)

    def _body(self, x):
        self.state = self.state + x               # rebinds the captured buffer

    def capture(self, cache, x):
        graph = torch.cuda.CUDAGraph()
        state = self.state
        with torch.cuda.graph(graph):
            _update(cache, state, x)
            self._body(x)
        return graph
