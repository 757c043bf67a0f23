"""Logical-axis sharding for the port, bound to a ``torch.distributed``
``DeviceMesh`` (the counterpart of ``repro.distributed.sharding``).

Models annotate tensors with *logical* axis names; the launcher binds logical
names to the mesh's axes, whose ``mesh_dim_names`` are the reference's
(``"pod"``, ``"data"``, ``"model"``). Outside a mesh every call is a no-op
that returns its input, so the single-card paths run exactly as they did.

Logical axes used by the model zoo:
  "batch"    — data-parallel batch dim            -> ("pod", "data")
  "seq"      — sequence/context dim               -> None (baseline)
  "model"    — hidden size / head / expert shards -> "model"
  "vocab"    — embedding vocab shard              -> "model"
  "expert"   — MoE expert dim                     -> "model"
  "ff"       — MLP hidden dim                     -> "model"
  "heads"    — attention head dim                 -> "model"
  "kv_heads" — KV head dim (GQA)                  -> "model" when divisible

A spec is a tuple with one entry a tensor dim: a mesh-axis name, a tuple of
them, or None (replicated). :func:`placements` turns it into DTensor
``Shard``/``Replicate`` placements; nothing else does.

The port runs the *local* program of each rank (Megatron-style tensor
parallelism): parameters are placed as local blocks by
``repro_torch.launch.shardings``, activations stay plain local tensors, and
the models issue their collectives through :func:`all_reduce` and
:func:`all_gather`, which count them (``comm_counts``, ``comm_bytes``: wire
bytes by the reference's algorithm factors). So :func:`shard` acts only
where the reference's constraint changes a layout that the placement does not
give: on ``"expert"`` it takes the rank's block of a dim that is replicated
there. On every other axis the local tensor already has the layout (the
launcher splits the batch; the placed weights give local heads, ff columns
and vocab rows), and it returns its input. ``"seq"`` is no exception: where
the rules map it to the model axis (sequence parallelism), the transformer
and encoder-decoder programs split their residual stream themselves
(:func:`sequence_parallel`, :func:`enter`, :func:`leave`), and the recurrent
families keep their whole sequence.

A collective over an axis of size 1 moves nothing and is skipped (not
counted).

Under autograd the collectives are Megatron's operators: a sum
:func:`all_reduce` passes its gradient through unchanged, :func:`copy_to`
(the identity at the entry of a split region) all-reduces its gradient, and
:func:`all_gather`'s gradient is the rank's block. Korthikanti et al.'s pair
for a sequence-parallel stream: ``all_gather(..., sum_grad=True)``, whose
gradient is reduce-scattered, and :func:`reduce_scatter`, whose gradient is
all-gathered. :func:`data_mean` averages over the batch axes. Without grad
mode they are plain calls.

FSDP (:func:`gathered`): a module that the placement split over the data
axes lists those parameters in ``module.fsdp`` (field -> (dim, axes)), and a
program gathers them for the region that reads them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist

_state = threading.local()

Entry = Optional[Union[str, tuple]]

DEFAULT_RULES: dict[str, Entry] = {
    "batch": ("pod", "data"),
    "seq": None,
    "model": "model",
    "vocab": "model",
    "expert": "model",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "state": None,
}

# logical axes whose layout the local program does not already have
_ACTING = ("expert",)

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What the placement split of one module's weights over the model axis
    (``module.tp``; None on a module that was not placed). Attention:
    ``heads`` (wq, wo), ``kv`` (wk, wv) and ``cache_dim``, the dim of its
    per-layer ``(B, K, S, hd)`` cache that the model axis shards (1, 2, 3 or
    None); SwiGLU: ``ff``; MoE: ``experts``; the model: ``vocab`` (the
    embedding's rows) and ``out_vocab`` (the logits' columns).

    A recurrent block's parts split together or not at all: a Mamba2
    block's ``heads`` (its SSD state ``h`` over heads, the causal conv's
    channels: ``conv_w``, ``conv_b`` and the ``conv`` state, and the rows of
    ``w_out`` and ``ynorm``); an mLSTM block's ``inner`` (the columns of
    ``w_up``, the input P axis of ``wq``/``wk``/``wv``, the rows of ``w_i``,
    ``w_f``, ``w_down`` and ``hnorm``, the first P axis of its ``C`` and
    ``n``); an sLSTM block's ``inner`` (the rows of ``w_out`` and ``hnorm``,
    the P axis of its states)."""
    heads: bool = False
    kv: bool = False
    cache_dim: Optional[int] = None
    ff: bool = False
    experts: bool = False
    vocab: bool = False
    out_vocab: bool = False
    inner: bool = False


# the reference's collective kinds (repro/roofline/hlo.py)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
comm_counts: dict[str, int] = {k: 0 for k in COLLECTIVES}
comm_bytes: dict[str, float] = {k: 0.0 for k in COLLECTIVES}


def reset_comm_counters() -> None:
    for k in COLLECTIVES:
        comm_counts[k] = 0
        comm_bytes[k] = 0.0


def _current():
    return getattr(_state, "mesh", None), getattr(_state, "rules", DEFAULT_RULES)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Bind a ``DeviceMesh`` and logical->physical rules for the enclosed
    region. Rules entries may name mesh axes that don't exist on this mesh —
    they are dropped (so the same rules work for single- and multi-pod
    meshes)."""
    prev = _current()
    eff = dict(DEFAULT_RULES)
    if rules:
        eff.update(rules)
    names = _names(mesh)
    pruned: dict[str, Entry] = {}
    for k, v in eff.items():
        if v is None:
            pruned[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            pruned[k] = kept if kept else None
        else:
            pruned[k] = v if v in names else None
    _state.mesh, _state.rules = mesh, pruned
    try:
        with mesh:
            yield
    finally:
        _state.mesh, _state.rules = prev


def _axes(entry: Entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_size(mesh, entry: Entry) -> int:
    """Product of the sizes of the mesh axes ``entry`` names (1 for None)."""
    names = _names(mesh)
    n = 1
    for a in _axes(entry):
        n *= mesh.size(names.index(a))
    return n


def logical_to_spec(*logical_axes: Optional[str]) -> tuple:
    """Translate logical axis names (one per tensor dim; None = replicated)
    into a spec under the current rules."""
    _, rules = _current()
    return tuple(rules.get(a) if a is not None else None for a in logical_axes)


def guard(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """The divisibility guard of ``repro``'s ``shard``: an entry whose dim
    does not divide into its mesh axes (or is smaller) becomes None."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        size = mesh_size(mesh, entry)
        out.append(entry if entry is not None and dim % size == 0 and dim >= size else None)
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh axis that tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in _names(mesh):
        dims = [d for d, e in enumerate(spec) if name in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: ``jax.sharding.NamedSharding``'s counterpart."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def named_sharding(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    mesh, _ = _current()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(*logical_axes))


def current_mesh():
    return _current()[0]


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes the logical axis maps to (1 if unmapped)."""
    mesh, rules = _current()
    if mesh is None:
        return 1
    return mesh_size(mesh, rules.get(logical))


def coordinate(entry: Entry) -> int:
    """This rank's index along the mesh axes ``entry`` names, major first
    (the block it holds of a dim sharded over them)."""
    mesh, _ = _current()
    idx = 0
    for a in _axes(entry):
        idx = idx * mesh.size(_names(mesh).index(a)) + mesh.get_local_rank(a)
    return idx


def local_block(x: torch.Tensor, dim: int, entry: Entry) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` sharded over ``entry``."""
    mesh, _ = _current()
    n = mesh_size(mesh, entry)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, coordinate(entry) * size, size)


def block(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` placed by ``spec`` (one entry a dim)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = local_block(x, dim, entry)
    return x


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``repro``'s sharding constraint in the local program; no-op without a
    mesh. Dims whose size does not divide into the mapped mesh axes are left
    as they are. On ``"expert"`` (replicated in the local program) the rank's
    block is taken; other axes already have their layout."""
    mesh, _ = _current()
    if mesh is None:
        return x
    spec = guard(logical_to_spec(*logical_axes), tuple(x.shape), mesh)
    for dim, (axis, entry) in enumerate(zip(logical_axes, spec)):
        if axis in _ACTING and entry is not None:
            x = local_block(x, dim, entry)
    return x


def _group(entry: Entry):
    """The process group over the mesh axes ``entry`` names."""
    mesh, _ = _current()
    axes = _axes(entry)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Bytes a rank sends for a collective of ``kind`` whose result is
    ``nbytes`` over a group of ``g``: the algorithm factors of
    ``repro.roofline.hlo`` (all-reduce 2(g-1)/g; all-gather, reduce-scatter
    and all-to-all (g-1)/g; collective-permute 1)."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / max(g, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (g - 1) / max(g, 1)
    return float(nbytes)


def _count(kind: str, nbytes: int, g: int) -> None:
    comm_counts[kind] += 1
    comm_bytes[kind] += wire_bytes(kind, nbytes, g)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce(x: torch.Tensor, entry: Entry, op: str, g: int) -> torch.Tensor:
    dist.all_reduce(x, op=_OPS[op], group=_group(entry))
    _count("all-reduce", x.numel() * x.element_size(), g)
    return x


def _gather(x: torch.Tensor, dim: int, entry: Entry, g: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g)]
    dist.all_gather(parts, x, group=_group(entry))
    out = torch.cat(parts, dim=dim)
    _count("all-gather", out.numel() * out.element_size(), g)
    return out


def _scatter(x: torch.Tensor, dim: int, entry: Entry, g: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // g,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=_group(entry))
    _count("reduce-scatter", out.numel() * out.element_size(), g)
    return out.movedim(0, dim)


class _SumReduce(torch.autograd.Function):
    """Forward: the sum over the group; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, entry, g):
        return _reduce(x.clone(), entry, "sum", g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _MeanReduce(torch.autograd.Function):
    """Forward: the mean over the group; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, entry, g):
        return _reduce(x.clone(), entry, "sum", g) / g

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, entry, g):
        ctx.entry, ctx.g = entry, g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.clone(), ctx.entry, "sum", ctx.g), None, None


class _Gather(torch.autograd.Function):
    """Forward: every rank's block; backward: this rank's block of the
    gradient, or with ``sum_grad`` the gradient reduce-scattered."""

    @staticmethod
    def forward(ctx, x, dim, entry, g, sum_grad):
        ctx.dim, ctx.entry, ctx.g, ctx.sum_grad = dim, entry, g, sum_grad
        return _gather(x, dim, entry, g)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            out = _scatter(grad, ctx.dim, ctx.entry, ctx.g)
        else:
            out = local_block(grad, ctx.dim, ctx.entry).contiguous()
        return out, None, None, None, None


class _Scatter(torch.autograd.Function):
    """Forward: the sum over the group, this rank's block; backward: every
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, entry, g):
        ctx.dim, ctx.entry, ctx.g = dim, entry, g
        return _scatter(x, dim, entry, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.entry, ctx.g), None, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, entry: Entry = "model", op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the mesh axes ``entry`` names, counted: in place
    (returns ``x``), or under autograd a new tensor whose gradient passes
    through. Skipped at size 1."""
    mesh, _ = _current()
    g = mesh_size(mesh, entry)
    if g == 1:
        return x
    if _tracked(x):
        if op != "sum":
            raise ValueError(f"all_reduce({op!r}) has no gradient")
        return _SumReduce.apply(x, entry, g)
    return _reduce(x, entry, op, g)


def all_reduce_many(tensors: list, entry: Entry = "model") -> list:
    """Tensors of one dtype summed over the mesh axes ``entry`` names in one
    collective (flattened, concatenated, all-reduced, split back; as
    :func:`all_reduce` under autograd); as they are at size 1."""
    mesh, _ = _current()
    if mesh_size(mesh, entry) == 1:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), entry)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                               tensors)]


def data_mean(x: torch.Tensor, entry: Entry) -> torch.Tensor:
    """The mean of ``x`` over the batch axes ``entry`` names (a new tensor),
    counted; ``x`` as it is at size 1 or without a mesh. Under autograd its
    gradient passes through unchanged: the train step averages the ranks'
    gradients over the same axes, and that average is the mean's gradient."""
    mesh, _ = _current()
    g = mesh_size(mesh, entry) if mesh is not None else 1
    if g == 1:
        return x
    if _tracked(x):
        return _MeanReduce.apply(x, entry, g)
    return _reduce(x.clone(), entry, "sum", g) / g


def copy_to(x: torch.Tensor, entry: Entry = "model") -> torch.Tensor:
    """``x`` as it is, entering a region split over ``entry``: under
    autograd its gradient is summed over the group (Megatron's f)."""
    mesh, _ = _current()
    g = mesh_size(mesh, entry)
    if g == 1 or not _tracked(x):
        return x
    return _CopyTo.apply(x, entry, g)


def reduce_scatter(x: torch.Tensor, dim: int, entry: Entry = "model") -> torch.Tensor:
    """The sum over the group of ``x``, of which this rank keeps its block
    along ``dim``, counted (result bytes); under autograd its gradient is
    every rank's block, all-gathered. Skipped at size 1."""
    mesh, _ = _current()
    g = mesh_size(mesh, entry)
    if g == 1:
        return x
    if _tracked(x):
        return _Scatter.apply(x, dim, entry, g)
    return _scatter(x, dim, entry, g)


def all_gather(x: torch.Tensor, dim: int, entry: Entry = "model", *,
               sum_grad: bool = False) -> torch.Tensor:
    """The blocks of every rank along the mesh axes ``entry`` names,
    concatenated along ``dim`` in rank order, counted (result bytes).
    Skipped at size 1. Under autograd its gradient is this rank's block of
    the gradient (every rank computes the same one), or with ``sum_grad``
    the gradient reduce-scattered (each rank computes a part of it: a
    sequence-parallel region, an FSDP parameter)."""
    mesh, _ = _current()
    g = mesh_size(mesh, entry)
    if g == 1:
        return x
    if _tracked(x):
        return _Gather.apply(x, dim, entry, g, sum_grad)
    return _gather(x, dim, entry, g)


def gather_block(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under ``spec``,
    all-gathered dim by dim (counted)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = all_gather(x, dim, entry)
    return x


# ---------------------------------------------------------------------------
# Sequence parallelism and FSDP in the local program
# ---------------------------------------------------------------------------


def seq_parallel(seq_len: int) -> bool:
    """Whether a residual stream of ``seq_len`` positions is split over the
    model axis (Korthikanti et al.): the rules map ``"seq"`` to it, it is
    larger than 1, and ``seq_len`` divides into it."""
    mesh, rules = _current()
    if mesh is None or rules.get("seq") != MODEL_AXIS:
        return False
    m = mesh_size(mesh, MODEL_AXIS)
    return m > 1 and seq_len % m == 0


@contextlib.contextmanager
def sequence_parallel(on: bool):
    """Mark the enclosed region as running on the rank's block of the
    sequence (dim 1) when ``on``: :func:`enter` and :func:`leave` then
    gather and scatter over it. A remat body enters it itself, so that its
    recompute in the backward runs the same program."""
    prev = getattr(_state, "seq", False)
    _state.seq = on
    try:
        yield
    finally:
        _state.seq = prev


def seq_sharded() -> bool:
    return getattr(_state, "seq", False)


def enter(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The input of a region whose weights are split over the model axis
    (``split``): Megatron's f (:func:`copy_to`). In a sequence-parallel
    region (:func:`sequence_parallel`) the input of any region that mixes
    positions: the whole sequence, gathered, whose gradient (each rank's
    part of it) is reduce-scattered."""
    if seq_sharded():
        return all_gather(x, 1, MODEL_AXIS, sum_grad=True)
    return copy_to(x) if split else x


def leave(y: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The output of a region :func:`enter` opened: partial sums
    all-reduced (Megatron's g) where ``split``; in a sequence-parallel
    region reduce-scattered over the sequence, or where not ``split`` the
    rank's block of it."""
    if seq_sharded():
        return reduce_scatter(y, 1) if split else local_block(y, 1, MODEL_AXIS)
    return all_reduce(y) if split else y


@contextlib.contextmanager
def gathered(module, recurse: bool = True, fields: Optional[tuple[str, ...]] = None):
    """FSDP: inside, each parameter that the placement split over the data
    axes (listed in ``module.fsdp``, and in its submodules' with
    ``recurse``; only ``fields`` where given) reads as its all-gather over
    them, whose gradient is reduce-scattered back onto the block (summed
    over the data ranks); outside, the blocks. A remat body enters it
    itself, so its recompute gathers again."""
    swapped = []
    for mod in (module.modules() if recurse else (module,)):
        for field, (dim, entry) in vars(mod).get("fsdp", {}).items():
            if fields is not None and field not in fields:
                continue
            block = mod._parameters[field]
            mod._parameters[field] = all_gather(block, dim, entry, sum_grad=True)
            swapped.append((mod, field, block))
    try:
        yield
    finally:
        for mod, field, block in swapped:
            mod._parameters[field] = block
