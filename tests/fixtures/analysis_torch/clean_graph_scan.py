"""The port's _GraphScan idiom: a chunk of steps captured once and
replayed, the carry in static buffers written back in place, the step index
a device tensor, pytree structure branches (``is None``, ``isinstance``)."""
import torch


def _tree_map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tuple(_tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree))


def _tree_copy(dst, src):
    def cp(d, s):
        if s is not d:
            d.copy_(s)
        return d
    _tree_map(cp, dst, src)


def _advance(step, state, xs, step_t, rows, n_steps):
    x = tuple(a.index_select(1, step_t).squeeze(1) for a in xs)
    state, out = step(state, x)
    if out is not None:
        if rows is None:
            rows = {k: v.new_empty((n_steps,) + tuple(v.shape)) for k, v in out.items()}
        for k, v in out.items():
            rows[k].index_copy_(0, step_t, v.unsqueeze(0))
    if x[0].shape[0] > 1:
        step_t.add_(1)
    return state, rows


class GraphScan:
    def __init__(self, step, n_steps, state, xs, rows):
        self.step, self.n_steps = step, n_steps
        self.state = _tree_map(torch.empty_like, state)
        self.xs = tuple(torch.empty_like(a) for a in xs)
        self.step_t = torch.zeros(1, dtype=torch.long)
        self.rows = rows
        self.graph = self._capture(50)

    def _body(self, k):
        state = self.state
        for _ in range(k):
            state, _ = _advance(self.step, state, self.xs, self.step_t, self.rows,
                                self.n_steps)
        _tree_copy(self.state, state)

    def _capture(self, k):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body(k)
        return graph
