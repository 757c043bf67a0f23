"""R1: host RNG two local calls below a captured step."""
import random

import torch


def _draw():
    return random.random()


def _jitter(x):
    return x + _draw()


def step(x):
    return _jitter(x) * 2


def graphed(x):
    return torch.cuda.make_graphed_callables(step, (x,))
