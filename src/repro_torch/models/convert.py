"""Carry a ``repro`` parameter tree into the port's modules.

The tree is what ``jax.tree_util.tree_map(np.asarray, params)`` gives for a
dense or MoE model: ``embed``, ``final_norm``, optional ``unembed`` (absent
when the embeddings are tied) and ``layers``, whose leaves are stacked over
the layer axis; ``layers["attn"]`` is the ``AttnParams`` NamedTuple, read by
its field names, with ``q_norm``/``k_norm`` ``None`` without qk-norm;
``layers["mlp"]`` holds a SwiGLU's ``w_gate``/``w_up``/``w_down``, or an
MoE's ``router``, expert weights and, with shared experts, a ``shared``
SwiGLU. Layer ``i`` of the port takes slice ``i`` of every stacked leaf.

An encoder-decoder tree (whisper-small) holds ``embed``, ``encoder`` (``ln1``,
``attn``, ``ln2``, ``mlp``), ``enc_norm``, ``decoder`` (``ln1``,
``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``), ``final_norm``
and ``unembed``, stacked over the layer axis in the same way.

A hybrid tree (zamba2) holds ``embed``, ``mamba`` (each Mamba2 block's
leaves stacked over the layer axis), ``final_norm``, ``unembed`` and
``shared_attn``: ``ln1``, an unstacked ``AttnParams`` ``attn``, ``ln2`` and
a SwiGLU ``mlp``. An xLSTM tree holds ``embed``, ``final_norm``,
``unembed`` and ``groups``, one entry a plan group: an mLSTM group's dict
stacked over its blocks, or an sLSTM block's dict.

A tree of another family than the model's (an MoE tree for a dense model,
an encoder-decoder tree for a transformer, an xLSTM tree for a hybrid, or
the other way round) is refused. Nothing here imports ``jax`` or ``repro``.

:func:`reference_ndim` gives each port parameter the rank of its leaf in
``repro``'s tree: one more than the port tensor's where ``repro`` stacks the
leaf. AdamW decays a leaf by that rank (``repro/optim/adamw.py`` decays where
``master.ndim > 1``), so a per-layer vector such as ``layers.0.ln1`` is
decayed, as its stacked ``(L, d)`` leaf is in ``repro``, and ``final_norm``
is not.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from torch import nn

from .encdec import EncDec
from .hybrid import Zamba2
from .moe import MoE
from .transformer import Transformer
from .xlstm import XLSTM

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


_KINDS = {EncDec: "an encoder-decoder", Zamba2: "a hybrid (Mamba2)", XLSTM: "an xLSTM",
          Transformer: "a decoder-only transformer"}


def _family(tree: dict, model) -> None:
    tree_kind = (EncDec if "encoder" in tree else Zamba2 if "mamba" in tree
                 else XLSTM if "groups" in tree else Transformer)
    if not isinstance(model, tree_kind):
        model_kind = next(k for k in _KINDS if isinstance(model, k))
        raise ValueError(f"the tree holds {_KINDS[tree_kind]} model, the model is "
                         f"{_KINDS[model_kind]} one")


def _put_attn(dst, attn, i: int, name: str) -> None:
    for f in _ATTN_FIELDS:
        leaf = getattr(attn, f)
        _put(getattr(dst, f), None if leaf is None else leaf[i], f"{name}.{f}")


def _n_layers(stack: dict, modules, name: str) -> None:
    n = np.asarray(stack["ln1"]).shape[0]
    if n != len(modules):
        raise ValueError(f"{name}: the tree has {n} layers, the model {len(modules)}")


@torch.no_grad()
def load_jax_params(model: Union[Transformer, EncDec, Zamba2, XLSTM], tree: dict):
    """Copy ``tree`` into ``model`` in place; returns ``model``."""
    _family(tree, model)
    if isinstance(model, EncDec):
        return _load_encdec(model, tree)
    if isinstance(model, Zamba2):
        return _load_hybrid(model, tree)
    if isinstance(model, XLSTM):
        return _load_xlstm(model, tree)
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
    _n_layers(layers, model.layers, "layers")
    for i, blk in enumerate(model.layers):
        _put(blk.ln1, layers["ln1"][i], f"layers[{i}].ln1")
        _put(blk.ln2, layers["ln2"][i], f"layers[{i}].ln2")
        _put_attn(blk.attn, layers["attn"], i, f"layers[{i}].attn")
        _put_mlp(blk.mlp, layers["mlp"], i, f"layers[{i}].mlp")
    return model


def _load_encdec(model: EncDec, tree: dict) -> EncDec:
    for name in ("embed", "enc_norm", "final_norm", "unembed"):
        _put(getattr(model, name), tree[name], name)
    for stack, modules, attns in (("encoder", model.encoder, ("attn",)),
                                  ("decoder", model.decoder, ("self_attn", "cross_attn"))):
        layers = tree[stack]
        _n_layers(layers, modules, stack)
        for i, blk in enumerate(modules):
            for norm in ("ln1", "ln_x", "ln2"):
                if hasattr(blk, norm):
                    _put(getattr(blk, norm), layers[norm][i], f"{stack}[{i}].{norm}")
            for a in attns:
                _put_attn(getattr(blk, a), layers[a], i, f"{stack}[{i}].{a}")
            _put_mlp(blk.mlp, layers["mlp"], i, f"{stack}[{i}].mlp")
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


def _stacked_prefixes(model: Union[Transformer, EncDec, Zamba2, XLSTM]) -> tuple[str, ...]:
    """The name prefixes of the port parameters whose ``repro`` leaves are
    stacked: over the layers (``layers``, ``encoder``, ``decoder``,
    ``mamba``), or over an mLSTM group's blocks (``groups.{gi}``, even a
    group of one block). Zamba2's shared block and an sLSTM block are single."""
    if isinstance(model, EncDec):
        return ("encoder.", "decoder.")
    if isinstance(model, Zamba2):
        return ("mamba.",)
    if isinstance(model, XLSTM):
        return tuple(f"groups.{gi}." for gi, g in enumerate(model.groups)
                     if isinstance(g, nn.ModuleList))
    if isinstance(model, Transformer):
        return ("layers.",)
    raise TypeError(f"not a model of the port: {type(model).__name__}")


def reference_ndim(model: Union[Transformer, EncDec, Zamba2, XLSTM]) -> dict[str, int]:
    """Each parameter's name -> the rank of its leaf in ``repro``'s tree."""
    stacked = _stacked_prefixes(model)
    return {name: p.dim() + name.startswith(stacked) for name, p in model.named_parameters()}


def _put_fields(dst: nn.Module, src: dict, name: str, i: Optional[int] = None) -> None:
    """Every parameter of ``dst`` from the same-named leaf of ``src`` (its
    slice ``i`` where the leaves are stacked over blocks)."""
    params = dict(dst.named_parameters())
    if set(src) != set(params):
        raise ValueError(f"{name}: the tree's fields {sorted(src)} are not the model's "
                         f"{sorted(params)}")
    for f, w in params.items():
        _put(w, src[f] if i is None else src[f][i], f"{name}.{f}")


def _load_hybrid(model: Zamba2, tree: dict) -> Zamba2:
    for name in ("embed", "final_norm", "unembed"):
        _put(getattr(model, name), tree[name], name)
    n = np.asarray(tree["mamba"]["ln"]).shape[0]
    if n != len(model.mamba):
        raise ValueError(f"mamba: the tree has {n} layers, the model {len(model.mamba)}")
    for i, blk in enumerate(model.mamba):
        _put_fields(blk, tree["mamba"], f"mamba[{i}]", i)
    shared, dst = tree.get("shared_attn"), model.shared_attn
    if (shared is None) != (dst is None):
        raise ValueError("shared_attn: present on one side only")
    if dst is not None:
        _put(dst.ln1, shared["ln1"], "shared_attn.ln1")
        _put(dst.ln2, shared["ln2"], "shared_attn.ln2")
        for f in _ATTN_FIELDS:
            _put(getattr(dst.attn, f), getattr(shared["attn"], f), f"shared_attn.attn.{f}")
        _put_fields(dst.mlp, shared["mlp"], "shared_attn.mlp")
    return model


def _load_xlstm(model: XLSTM, tree: dict) -> XLSTM:
    for name in ("embed", "final_norm", "unembed"):
        _put(getattr(model, name), tree[name], name)
    if len(tree["groups"]) != len(model.groups):
        raise ValueError(f"groups: the tree has {len(tree['groups'])}, the model "
                         f"{len(model.groups)}")
    for gi, (src, group) in enumerate(zip(tree["groups"], model.groups)):
        if not isinstance(group, nn.ModuleList):  # an sLSTM block
            _put_fields(group, src, f"groups[{gi}]")
            continue
        ln = np.asarray(src["ln"])  # an mLSTM run, stacked over its blocks
        if ln.ndim != 2 or ln.shape[0] != len(group):
            raise ValueError(f"groups[{gi}]: the tree holds {ln.shape[0] if ln.ndim == 2 else 0} "
                             f"stacked mLSTM blocks where the model has {len(group)}")
        for j, blk in enumerate(group):
            _put_fields(blk, src, f"groups[{gi}][{j}]", j)
    return model
