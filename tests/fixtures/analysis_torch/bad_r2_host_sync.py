"""R2: host syncs on tensors inside captured code."""
import numpy as np
import torch


def _body(x, lengths):
    total = int(lengths.sum())                    # host read
    if x.max() > 0:                               # branch on a value
        x = x * 2
    first = lengths[0].item()                     # host read
    rows = lengths.tolist()                       # host copy
    host = np.asarray(x)                          # host copy
    return x, total, first, rows, host.cpu()


def capture(x, lengths):
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin()
    out = _body(x, lengths)
    on_host = out[0].cpu()                        # host copy
    graph.capture_end()
    return graph, out, on_host
