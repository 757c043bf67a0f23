"""A decode step captured with its cache written in place: new state
computed, then ``copy_``; rows written by index; ``torch.where`` in place of
a branch; branches on shapes and static settings."""
import torch


def decode_step(cache, x, window=None):
    h = cache["h"] * 0.5 + x.sum(-1, keepdim=True)
    cache["h"].copy_(h)
    rows = torch.arange(x.shape[0], device=x.device)
    slot = cache["lengths"] % cache["k"].shape[2] if window is not None else cache["lengths"]
    cache["k"][rows, :, slot.long()] = x[:, None, :]
    y = torch.where(x > 0, x, torch.zeros_like(x))
    if x.dim() == 3 and len(cache) > 2:
        y = y + 1
    cache["lengths"].add_(1)
    return y


def capture(cache, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = decode_step(cache, x)
    return graph, y
