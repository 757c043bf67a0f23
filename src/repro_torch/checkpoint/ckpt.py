"""Checkpointing, the port of ``repro.checkpoint.ckpt``: a tree of tensors
<-> ``.npz`` with a structure manifest, in ``repro``'s layout: arrays
``arr_{i}`` and a ``__manifest__`` (JSON) holding ``keys``, ``dtypes`` and
``shardings``; bf16 is stored widened to f32 (numpy has no bf16) and cast
back on restore.

A tree is a model module (its named parameters), an
:class:`~repro_torch.optim.adamw.AdamWState`, a tensor, or a dict, list or
tuple of these. Keys are paths joined by ``/``: the port's own names, such as
``params/layers.0.ln1`` or ``opt/mu/layers.0.ln1``; a JAX checkpoint's keys
are ``repro``'s and are not read here. :func:`restore` writes into the
tensors of a template tree in place, so a model's parameters and an
optimizer's state keep their tensors.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch
from torch import nn


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    def key(k) -> str:
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(key(n), p) for n, p in tree.named_parameters()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    return [kv for k, sub in items for kv in _flatten_with_paths(sub, key(k))]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(path: str | pathlib.Path, tree, *, shardings: dict[str, str] | None = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = _flatten_with_paths(tree)
    arrays = {}
    for i, (_, leaf) in enumerate(leaves):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # numpy has no bf16: store as f32, cast on restore
            leaf = leaf.float()
        arrays[f"arr_{i}"] = leaf.cpu().numpy()
    manifest = {
        "keys": [k for k, _ in leaves],
        "dtypes": [_dtype_name(leaf) for _, leaf in leaves],
        "shardings": shardings or {},
    }
    np.savez(path, __manifest__=json.dumps(manifest), **arrays)


@torch.no_grad()
def restore(path: str | pathlib.Path, like) -> Any:
    """Restore into the tensors of ``like`` (a template tree), in place, each
    cast to its tensor's dtype; returns ``like``."""
    path = pathlib.Path(path)
    template = _flatten_with_paths(like)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        index = {k: i for i, k in enumerate(manifest["keys"])}
        missing = [k for k, _ in template if k not in index]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
        for k, t in template:
            a = data[f"arr_{index[k]}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {a.shape} in the checkpoint, {tuple(t.shape)} here")
            t.copy_(torch.from_numpy(a).to(t.dtype))
    return like
