"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``portbench/traffic/<name>.json``) gives the distributions of prompt
and output lengths and a block size ``n``. The lengths of a block are the
distributions' stratified quantiles, at ``(i + 0.5) / n``, and prompt
quantile ``i`` is paired with output quantile ``(i * pair_stride) % n``. So
every block holds the same multiset of (prompt, output) lengths, whatever
the seed: the seed draws only each block's order and the token ids. The
closed loop serves block after block, so a window holds whole blocks and a
part of one, and the shapes that the warm-up has to cover are fixed.

Distributions: ``uniform`` over ``low, low + multiple, ..., high`` and
``loguniform`` between ``low`` and ``high``, rounded to whole tokens.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int            # position in the seed's stream
    prompt: np.ndarray    # (S,) int32
    new_tokens: int       # T


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    n, stride = mix["block"], mix["pair_stride"]
    if n < 1 or math.gcd(stride, n) != 1:
        raise ValueError(f"{path}: pair_stride {stride} must be coprime with block {n}")
    return mix


def quantiles(dist: dict, n: int) -> list[int]:
    """The ``n`` stratified quantiles of ``dist``, in increasing order."""
    us = [(i + 0.5) / n for i in range(n)]
    low, high = dist["low"], dist["high"]
    if dist["dist"] == "uniform":
        values = list(range(low, high + 1, dist.get("multiple", 1)))
        return [values[min(len(values) - 1, int(u * len(values)))] for u in us]
    if dist["dist"] == "loguniform":
        return [min(high, max(low, round(low * (high / low) ** u))) for u in us]
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def block_shapes(mix: dict) -> list[tuple[int, int]]:
    """The block's (prompt length, output length) pairs, in quantile order."""
    n = mix["block"]
    S = quantiles(mix["prompt"], n)
    T = quantiles(mix["output"], n)
    return [(S[i], T[(i * mix["pair_stride"]) % n]) for i in range(n)]


def stream(mix: dict, seed: int, vocab: int) -> Iterator[Request]:
    """Requests without end: each block the shapes in an order drawn from
    ``seed``, prompts of token ids drawn uniformly from the vocabulary."""
    rng = np.random.Generator(np.random.PCG64(seed))
    shapes = block_shapes(mix)
    index = 0
    while True:
        for j in rng.permutation(len(shapes)):
            S, T = shapes[j]
            prompt = rng.integers(0, vocab, S, dtype=np.int64).astype(np.int32)
            yield Request(index, prompt, T)
            index += 1


def bucket(n: int, base: int) -> int:
    """The serving backend's power-of-two bucket of ``n``, at least ``base``."""
    b = base
    while b < n:
        b <<= 1
    return b


def graph_keys(S: int, T: int, decode_bucket: int = 8) -> tuple[tuple, tuple]:
    """The (prefill, decode) graph keys that one request of ``S`` prompt and
    ``T`` output tokens makes at batch 1: ``("prefill", S, cache_len)`` and
    ``("decode", cache_len, Tb)``, with ``Tb`` the output's bucket and
    ``cache_len`` that of ``S + Tb`` (zamba2's ring of ``min(cache_len,
    window)`` rows serves the same keys: every cell's ``cache_len`` is
    within the window)."""
    Tb = bucket(T, decode_bucket)
    rows = bucket(S + Tb, decode_bucket)
    return ("prefill", S, rows), ("decode", rows, Tb)


def shape_keys(mix: dict) -> set[tuple]:
    """Every graph key that the mix's traffic makes."""
    return {k for S, T in block_shapes(mix) for k in graph_keys(S, T)}


def warmup_shapes(mix: dict) -> list[tuple[int, int]]:
    """A shortest list of the block's (S, T) whose requests make every key
    of :func:`shape_keys`, found greedily: each pick covers the most keys
    not yet made, and the shorter request among equals."""
    todo = shape_keys(mix)
    shapes = sorted(set(block_shapes(mix)), key=lambda st: (st[1], st[0]))
    picked = []
    while todo:
        best = max(shapes, key=lambda st: len(todo & set(graph_keys(*st))))
        picked.append(best)
        todo -= set(graph_keys(*best))
    return picked
