"""Seeded weights, made by the benchmark on the device.

A configuration file's ``init`` is a list of rules ``[pattern, kind,
value]``; the first whose regular expression matches a parameter's whole
name decides it:

* ``normal``: N(0, value^2);
* ``const``: every element ``value``;
* ``log_linspace``: ``log(linspace(value[0], value[1], n))`` (Mamba2's
  ``A_log``).

The normal draws come from one ``torch.Generator`` seeded with ``--seed``,
in the type each weight is served in, in a few large calls: consecutive
weights of one type share a call of up to ``_CHUNK`` elements. The same
specs and seed give the same tensors, so the program and the reference get
the same weights without either keeping the other's copy.
"""
from __future__ import annotations

import math
import re

import torch

_CHUNK = 1 << 26  # elements a draw


def _rule(rules: list, name: str) -> tuple[str, object]:
    for pattern, kind, value in rules:
        if re.fullmatch(pattern, name):
            return kind, value
    raise KeyError(f"no init rule matches parameter {name!r}")


def specs_of(params: torch.nn.Module) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of each parameter, in the module's order."""
    return [(n, tuple(p.shape), p.dtype) for n, p in params.named_parameters()]


@torch.no_grad()
def make(specs, rules: list, seed: int, device, put=None) -> dict[str, torch.Tensor]:
    """The weights of ``specs`` under ``rules``, drawn from ``seed``: a
    dict, or with ``put`` each handed to ``put(name, tensor)`` as it is
    drawn and not kept (then at most one draw is held at a time)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    keep = put if put is not None else out.__setitem__
    pending: list[tuple[str, tuple, float]] = []
    pending_dtype = None

    def draw():
        total = sum(math.prod(shape) for _, shape, _ in pending)
        flat = torch.randn(total, generator=gen, device=device, dtype=pending_dtype)
        off = 0
        for name, shape, scale in pending:
            n = math.prod(shape)
            keep(name, flat[off:off + n].view(shape).mul_(scale))
            off += n
        pending.clear()

    for name, shape, dtype in specs:
        kind, value = _rule(rules, name)
        if kind == "normal":
            n = math.prod(shape)
            if pending and (dtype != pending_dtype or
                            sum(math.prod(s) for _, s, _ in pending) + n > _CHUNK):
                draw()
            pending_dtype = dtype
            pending.append((name, shape, float(value)))
            continue
        if kind == "const":
            keep(name, torch.full(shape, float(value), dtype=dtype, device=device))
        elif kind == "log_linspace":
            lo, hi = value
            keep(name, torch.log(torch.linspace(lo, hi, shape[0], device=device)).to(dtype))
        else:
            raise ValueError(f"unknown init kind {kind!r} for {name!r}")
    if pending:
        draw()
    return out


@torch.no_grad()
def write(params: torch.nn.Module, rules: list, seed: int) -> list:
    """Draw the weights of ``params`` from ``seed`` into them, in place
    (the program's graphs keep reading the same tensors). Returns their
    specs, from which :func:`make` draws the same weights again."""
    named = dict(params.named_parameters())
    specs = specs_of(params)
    make(specs, rules, seed, next(iter(named.values())).device,
         put=lambda name, t: named[name].copy_(t))
    return specs
