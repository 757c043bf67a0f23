"""Carry a ``repro`` parameter tree into the port's modules.

The tree is what ``jax.tree_util.tree_map(np.asarray, params)`` gives for a
dense or MoE model: ``embed``, ``final_norm``, optional ``unembed`` (absent
when the embeddings are tied) and ``layers``, whose leaves are stacked over
the layer axis; ``layers["attn"]`` is the ``AttnParams`` NamedTuple, read by
its field names, with ``q_norm``/``k_norm`` ``None`` without qk-norm;
``layers["mlp"]`` holds a SwiGLU's ``w_gate``/``w_up``/``w_down``, or an
MoE's ``router``, expert weights and, with shared experts, a ``shared``
SwiGLU. Layer ``i`` of the port takes slice ``i`` of every stacked leaf. A
tree of another family than the model's (an MoE tree for a dense model, or
the other way round) is refused. Nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .moe import MoE
from .transformer import Transformer

_ATTN_FIELDS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_SWIGLU_FIELDS = ("w_gate", "w_up", "w_down")


def _put(dst: Optional[torch.Tensor], src: Any, name: str) -> None:
    if dst is None or src is None:
        if not (dst is None and src is None):
            raise ValueError(f"{name}: present on one side only")
        return
    arr = np.asarray(src)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.tensor(arr).to(dst.dtype))  # copies: the source may be read-only


@torch.no_grad()
def load_jax_params(model: Transformer, tree: dict) -> Transformer:
    """Copy ``tree`` into ``model`` in place; returns ``model``."""
    tree_moe = "router" in tree["layers"]["mlp"]
    model_moe = any(isinstance(blk.mlp, MoE) for blk in model.layers)
    if tree_moe != model_moe:
        kind = {True: "an MoE", False: "a dense"}
        raise ValueError(f"layers.mlp: the tree holds {kind[tree_moe]} FFN, the model "
                         f"{kind[model_moe]} one")
    _put(model.embed, tree["embed"], "embed")
    _put(model.final_norm, tree["final_norm"], "final_norm")
    _put(model.unembed, tree.get("unembed"), "unembed")
    layers = tree["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    n = np.asarray(layers["ln1"]).shape[0]
    if n != len(model.layers):
        raise ValueError(f"tree has {n} layers, the model {len(model.layers)}")
    for i, blk in enumerate(model.layers):
        _put(blk.ln1, layers["ln1"][i], f"layers[{i}].ln1")
        _put(blk.ln2, layers["ln2"][i], f"layers[{i}].ln2")
        for f in _ATTN_FIELDS:
            leaf = getattr(attn, f)
            _put(getattr(blk.attn, f), None if leaf is None else leaf[i], f"layers[{i}].attn.{f}")
        _put_mlp(blk.mlp, mlp, i, f"layers[{i}].mlp")
    return model


def _put_mlp(dst, mlp: dict, i: int, name: str) -> None:
    fields = ("router",) + _SWIGLU_FIELDS if isinstance(dst, MoE) else _SWIGLU_FIELDS
    for f in fields:
        _put(getattr(dst, f), mlp[f][i], f"{name}.{f}")
    if isinstance(dst, MoE):
        if (dst.shared is None) != ("shared" not in mlp):
            raise ValueError(f"{name}.shared: present on one side only")
        if dst.shared is not None:
            for f in _SWIGLU_FIELDS:
                _put(getattr(dst.shared, f), mlp["shared"][f][i], f"{name}.shared.{f}")
