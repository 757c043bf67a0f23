"""R1: host RNG and the wall clock inside a CUDA-graph capture."""
import time

import numpy as np
import torch


def capture(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        noise = np.random.normal(size=4)          # one draw, replayed forever
        stamp = time.time()                       # capture time, replayed
        y = x * 2.0
    return graph, y, noise, stamp
