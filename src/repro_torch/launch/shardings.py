"""Per-architecture sharding rules, the port of ``repro.launch.shardings``.

Logical->physical rules are computed per arch (divisibility-guarded), and
parameter/optimizer/cache/batch specs are derived from names. Anything that
cannot shard cleanly falls back to replication. A spec is a tuple with one
entry a tensor dim (a mesh-axis name, a tuple of them, or None);
``repro_torch.distributed.sharding.placements`` turns it into DTensor
placements.

The pure functions (:func:`make_rules`, :func:`_guard`, :func:`param_spec`,
:func:`cache_spec`, :func:`batch_spec`, :func:`dp_only_rules`,
:func:`add_fsdp_axes`) read only a mesh's axis names and sizes: a
``DeviceMesh``, or any object with ``.shape`` (a mapping of axis name to
size) and ``.axis_names``. The port's parameters are per-layer modules, not
stacked leaves: :func:`param_spec` gives a port parameter the reference's
spec for its leaf with the stack dim dropped (``models/convert.py::
reference_ndim`` says which leaves are stacked). The port's cache names are
the reference's, except xlstm's ``g{gi}.C/n/m`` and ``g{gi}.c/n/h/m``, which
stand for the reference's state-tuple indices ``"0".."3"``.

The tree helpers place a model on a mesh in the local program (Megatron-style
tensor parallelism): :func:`place_params` replaces each parameter with this
rank's block and tells the attention, FFN, MoE, recurrent-block and
embedding code what is split (a ``TensorParallel`` on each module),
:func:`place_cache` and :func:`local_shape` do the same for a cache. Every
family runs its local program on the placed blocks; no block split over the
model axis is gathered. :func:`gather_params` gathers an FSDP placement's
blocks over the data axes, for a prefill or decode step that reads them
whole.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..distributed import sharding as sh

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")

# Shard KV caches along LENGTH (the flash-decode path). Set by dryrun
# --decode-attn shard_map.
FORCE_SEQ_SHARD_CACHE = False

_MLSTM_STATE = ("C", "n", "m")
_SLSTM_STATE = ("c", "n", "h", "m")


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names else tuple(mesh.axis_names)


def _sizes(mesh) -> dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def _mesh_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def make_rules(cfg: ArchConfig, mesh) -> dict:
    """Logical-axis rules for this arch on this mesh (divisibility-guarded)."""
    msize = _mesh_size(mesh, MODEL_AXIS)
    data_axes = tuple(a for a in DATA_AXES if a in _axis_names(mesh))
    return {
        "batch": data_axes or None,
        "seq": None,
        "model": MODEL_AXIS if cfg.d_model % msize == 0 else None,
        "vocab": MODEL_AXIS if cfg.vocab % msize == 0 else None,
        "expert": MODEL_AXIS if (cfg.moe and cfg.moe.n_experts % msize == 0) else None,
        "ff": MODEL_AXIS,
        "heads": MODEL_AXIS if cfg.n_heads % msize == 0 else None,
        "kv_heads": MODEL_AXIS if cfg.n_kv_heads % msize == 0 else None,
        "state": None,
    }


def _guard(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop spec axes whose dim isn't divisible by the mesh-axis product."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or shape[i] % _mesh_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


def _leaf_param_spec(name: str, shape: tuple[int, ...], cfg: ArchConfig, mesh) -> tuple:
    """The reference's spec of a parameter leaf named ``name`` (layer-stacked
    leaves have a leading L dim; specs are right-aligned, leading dims
    replicate)."""
    M = MODEL_AXIS
    nd = len(shape)

    def tail(spec_tail: tuple) -> tuple:
        return (None,) * (nd - len(spec_tail)) + spec_tail

    experts = cfg.moe is not None and nd >= 3 and shape[-3] == cfg.moe.n_experts
    if name == "embed":
        spec = (M, None)
    elif name == "unembed":
        spec = (None, M)
    elif name in ("wq", "wk", "wv"):
        spec = tail((None, M, None))        # (d, H or K, hd)
    elif name == "wo" and nd >= 3:
        spec = tail((M, None, None))        # (H, hd, d)
    elif name in ("w_gate", "w_up"):
        spec = tail((M, None, None)) if experts else tail((None, M))
    elif name == "w_down":
        spec = tail((M, None, None)) if experts else tail((M, None))
    elif name in ("router", "w_in"):
        spec = tail((None, None))
    elif name == "w_out" and nd >= 2:
        spec = tail((M, None))              # (d_inner, d) row-parallel
    elif name in ("w_i", "w_f"):
        spec = tail((M, None))              # (d_inner, H)
    elif name == "R":
        spec = (None,) * nd
    elif name == "conv_w":
        spec = tail((None, M))              # (K, conv_dim) channel-sharded
    elif name in ("conv_b", "ynorm", "hnorm"):
        spec = tail((M,))
    else:
        spec = (None,) * nd
    spec = tuple(spec)[:nd] + (None,) * (nd - len(spec))
    return _guard(spec, shape, mesh)


def param_spec(name: str, shape: tuple[int, ...], cfg: ArchConfig, mesh, *,
               stacked: bool = False, fsdp: bool = False) -> tuple:
    """Spec of the port parameter ``name`` (dotted, as ``named_parameters``
    gives it) of ``shape``: the reference's spec for its leaf, with the stack
    dim dropped when the reference's leaf is ``stacked``; with ``fsdp`` also
    split over the data axes (:func:`add_fsdp_axes` through :func:`_guard`,
    as ``repro``'s ``shard_params_like``). A port layer is one slice of the
    stack, which stands here as a dim of 1, so the stack dim is never split."""
    leaf = name.split(".")[-1]
    full = ((1,) if stacked else ()) + tuple(shape)
    spec = _leaf_param_spec(leaf, full, cfg, mesh)
    if fsdp:
        spec = _guard(add_fsdp_axes(spec, full, mesh, data_axes_of(mesh)), full, mesh)
    return spec[1:] if stacked else spec


def _reference_cache_name(name: str) -> str:
    """The reference's leaf name of a port cache entry."""
    leaf = name.split(".")[-1]
    if name.startswith("g") and "." in name:  # xlstm: g{gi}.<state>
        states = _SLSTM_STATE if leaf in ("c", "h") else _MLSTM_STATE
        return str(states.index(leaf) if leaf in states else _SLSTM_STATE.index(leaf))
    return leaf


def cache_spec(name: str, shape: tuple[int, ...], cfg: ArchConfig, mesh, data_axes) -> tuple:
    """KV caches / recurrent state sharding for decode/prefill."""
    name = _reference_cache_name(name)
    M = MODEL_AXIS
    msize = _mesh_size(mesh, M)
    nd = len(shape)
    if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
        # (L, B, K, S, hd): batch on data; kv-heads on model if they divide;
        # else head_dim; else the cache LENGTH as last resort
        if FORCE_SEQ_SHARD_CACHE:
            spec = (None, data_axes, None, M, None)
        elif cfg.n_kv_heads % msize == 0:
            spec = (None, data_axes, M, None, None)
        elif cfg.head_dim % msize == 0:
            spec = (None, data_axes, None, None, M)
        else:
            spec = (None, data_axes, None, M, None)
    elif name == "h":                        # mamba state (L, B, H, N, P)
        spec = (None, data_axes, M, None, None)
    elif name == "conv":                     # (L, B, K-1, conv_dim)
        spec = (None, data_axes, None, M)
    elif name == "lengths":
        spec = (data_axes,)
    elif name in ("0", "1", "2", "3"):
        # xlstm states: mLSTM (count,B,H,P,P)/(count,B,H,P)/(count,B,H) or
        # sLSTM (B,H,P): shard batch; shard the first P axis on model
        if nd == 5:
            spec = (None, data_axes, None, M, None)
        elif nd == 4:
            spec = (None, data_axes, None, M)
        elif nd == 3:
            spec = (data_axes, None, M)
        else:
            spec = (None,) * nd
    else:
        spec = (None,) * nd
    spec = tuple(spec)[:nd] + (None,) * (nd - len(spec))
    return _guard(spec, shape, mesh)


def batch_spec(name: str, shape: tuple[int, ...], mesh, data_axes) -> tuple:
    return _guard((data_axes,) + (None,) * (len(shape) - 1), shape, mesh)


def dp_only_rules(mesh, global_batch: int | None = None) -> dict:
    """Pure data-parallel logical rules: batch over as many mesh axes as its
    size divides, no model parallelism."""
    axes: list[str] = []
    prod = 1
    sizes = _sizes(mesh)
    for a in _axis_names(mesh):
        if global_batch is not None and global_batch % (prod * sizes[a]) != 0:
            break
        axes.append(a)
        prod *= sizes[a]
    return {
        "batch": tuple(axes) or None, "seq": None, "model": None,
        "vocab": None, "expert": None, "ff": None, "heads": None,
        "kv_heads": None, "state": None,
    }


def add_fsdp_axes(spec: tuple, shape: tuple[int, ...], mesh, data_axes) -> tuple:
    """ZeRO/FSDP: additionally shard a parameter (or optimizer-state leaf)
    over the data axes on the first still-replicated dim that divides,
    walking from the trailing dims and never the leading (layer-stack) dim
    of a rank >= 3 leaf."""
    if data_axes is None:
        return spec
    dsize = _mesh_size(mesh, data_axes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    lo = 1 if len(shape) >= 3 else 0
    for i in range(len(entries) - 1, lo - 1, -1):
        if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
            entries[i] = data_axes
            return tuple(entries)
    return tuple(entries)


def data_axes_of(mesh):
    return tuple(a for a in DATA_AXES if a in _axis_names(mesh)) or None


# ---------------------------------------------------------------------------
# Tree helpers over the port's named parameters and cache dicts
# ---------------------------------------------------------------------------


def param_specs(params: nn.Module, cfg: ArchConfig, mesh, *, replicate: bool = False,
                fsdp: bool = False) -> dict:
    """name -> spec of every parameter of the port's model ``params``
    (``replicate`` wins over ``fsdp``, as in ``repro``)."""
    from ..models.convert import reference_ndim

    ndim = reference_ndim(params)
    out = {}
    for name, p in params.named_parameters():
        if replicate:
            out[name] = (None,) * p.dim()
        else:
            out[name] = param_spec(name, tuple(p.shape), cfg, mesh,
                                   stacked=ndim[name] > p.dim(), fsdp=fsdp)
    return out


def cache_specs(cache: dict, cfg: ArchConfig, mesh) -> dict:
    """name -> spec of every entry of the port's ``cache``: :func:`cache_spec`,
    except an mLSTM's stabiliser ``g{gi}.m`` (count, B, H). The reference's
    rank-3 rule assumes an sLSTM state (B, H, P); this ``m`` is one scalar a
    head, the same on every rank that holds a block of the head's P axis, so
    it splits over the batch alone."""
    data_axes = data_axes_of(mesh)
    out = {}
    for name, t in cache.items():
        if name.endswith(".m") and f"{name[:-2]}.C" in cache:
            out[name] = _guard((None, data_axes, None), tuple(t.shape), mesh)
        else:
            out[name] = cache_spec(name, tuple(t.shape), cfg, mesh, data_axes)
    return out


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's block under ``spec``."""
    return tuple(d // _mesh_size(mesh, e) for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _together(prefix: str, splits: dict) -> bool:
    """Whether a recurrent block's parts (name -> split over the model axis)
    are all split; the local program splits them together or not at all."""
    if len(set(splits.values())) > 1:
        raise ValueError(f"{prefix}: the model axis splits {sorted(k for k, v in splits.items() if v)}"
                         f" but not {sorted(k for k, v in splits.items() if not v)}; the local "
                         f"program splits a recurrent block's parts together")
    return all(splits.values())


def _tensor_parallel(params: nn.Module, specs: dict, cfg: ArchConfig, mesh) -> None:
    """Tell each module what the placement split (``module.tp``): a
    self-attention's cache is split as a cache of any length that divides, a
    cross-attention's as the encoder's frames allow. A recurrent block's
    state splits as :func:`cache_spec` places it (a Mamba2 state over its
    heads, an xLSTM state over its first P axis)."""
    from ..models.attention import Attention
    from ..models.hybrid import MambaBlock, _dims as mamba_dims
    from ..models.layers import SwiGLU
    from ..models.moe import MoE
    from ..models.xlstm import MLSTMBlock, SLSTMBlock

    model = sh.MODEL_AXIS
    m = _mesh_size(mesh, MODEL_AXIS)
    for prefix, mod in params.named_modules():
        def spec(field):
            return specs[f"{prefix}.{field}" if prefix else field]

        if isinstance(mod, Attention):
            cross = prefix.endswith("cross_attn")
            mod.tp = sh.TensorParallel(
                heads=spec("wq")[1] == model, kv=spec("wk")[1] == model,
                cache_dim=kv_cache_dim(cfg, mesh, cfg.encoder_frames if cross else None))
        elif isinstance(mod, SwiGLU):
            mod.tp = sh.TensorParallel(ff=spec("w_gate")[1] == model)
        elif isinstance(mod, MoE):
            mod.tp = sh.TensorParallel(experts=spec("w_gate")[0] == model)
        elif isinstance(mod, MambaBlock):
            split = _together(prefix, {
                "heads": mamba_dims(cfg)[1] % m == 0, "conv_w": spec("conv_w")[1] == model,
                "conv_b": spec("conv_b")[0] == model, "ynorm": spec("ynorm")[0] == model,
                "w_out": spec("w_out")[0] == model})
            mod.tp = sh.TensorParallel(heads=split)
        elif isinstance(mod, MLSTMBlock):
            split = _together(prefix, {
                "w_up": spec("w_up")[1] == model, "wq": spec("wq")[1] == model,
                "wk": spec("wk")[1] == model, "wv": spec("wv")[1] == model,
                "w_i": spec("w_i")[0] == model, "w_f": spec("w_f")[0] == model,
                "hnorm": spec("hnorm")[0] == model, "w_down": spec("w_down")[0] == model})
            mod.tp = sh.TensorParallel(inner=split)
        elif isinstance(mod, SLSTMBlock):
            split = _together(prefix, {
                "state": (cfg.d_model // cfg.n_heads) % m == 0, "hnorm": spec("hnorm")[0] == model,
                "w_out": spec("w_out")[0] == model})
            mod.tp = sh.TensorParallel(inner=split)
    unembed = getattr(params, "unembed", None)
    vocab = specs["embed"][0] == model
    params.tp = sh.TensorParallel(
        vocab=vocab, out_vocab=vocab if unembed is None else specs["unembed"][1] == model)


def _whole_kv_rows(mesh) -> bool:
    """Whether the decode kernel reads the caches placed on ``mesh`` (a mesh
    of CUDA devices): it needs every row's whole head_dim."""
    return getattr(mesh, "device_type", None) == "cuda"


def placed_kv_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """The spec an ``(L, B, K, S, hd)`` K/V cache is placed by:
    :func:`cache_spec`'s, except where the decode kernel reads the cache
    (:func:`_whole_kv_rows`): there a head_dim split moves to the length
    (the flash-decode merges the slices), or off the model axis where the
    length does not divide."""
    if not _whole_kv_rows(mesh) or spec[4] != MODEL_AXIS:
        return spec
    return _guard(spec[:3] + (MODEL_AXIS, None), shape, mesh)


def kv_cache_dim(cfg: ArchConfig, mesh, length: Optional[int] = None) -> Optional[int]:
    """The dim of a per-layer ``(B, K, S, hd)`` K/V cache of ``length`` rows
    (None: any length that divides) that the model axis shards as placed
    (1 kv heads, 2 length, 3 head_dim), or None."""
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, length or 1 << 20, cfg.head_dim)
    spec = placed_kv_spec(cache_spec("k", shape, cfg, mesh, None), shape, mesh)
    dims = [i - 1 for i, e in enumerate(spec) if e == MODEL_AXIS]
    return dims[0] if dims else None


def _module_field(params: nn.Module, name: str) -> tuple[nn.Module, str]:
    mod_name, _, field = name.rpartition(".")
    return (params.get_submodule(mod_name) if mod_name else params), field


def _replace(params: nn.Module, name: str, t: torch.Tensor, requires_grad: bool) -> None:
    mod, field = _module_field(params, name)
    mod._parameters[field] = nn.Parameter(t, requires_grad=requires_grad)


@torch.no_grad()
def place_params(params: nn.Module, cfg: ArchConfig, mesh, *, replicate: bool = False,
                 fsdp: bool = False) -> dict:
    """Replace every parameter of ``params`` with this rank's block under
    :func:`param_specs`, in place, and mark its modules for their local
    program (unless ``replicate``); returns the specs. With ``fsdp`` each module lists the
    parameters split over the data axes in ``module.fsdp`` (field -> (dim,
    axes)), which its program gathers where it reads them
    (``sharding.gathered``). Call inside ``use_mesh(mesh, ...)``."""
    specs = param_specs(params, cfg, mesh, replicate=replicate, fsdp=fsdp)
    data_axes = data_axes_of(mesh)
    for mod in params.modules():
        vars(mod).pop("fsdp", None)
    for name, p in list(params.named_parameters()):
        block = sh.block(p.data, specs[name])
        if block.shape != p.shape:
            _replace(params, name, block.contiguous().clone(), p.requires_grad)
        split = [(d, e) for d, e in enumerate(specs[name]) if e is not None and e == data_axes]
        if split:
            mod, field = _module_field(params, name)
            vars(mod).setdefault("fsdp", {})[field] = split[0]
    if not replicate:
        _tensor_parallel(params, specs, cfg, mesh)
    return specs


@torch.no_grad()
def place_cache(cache: dict, cfg: ArchConfig, mesh) -> tuple[dict, dict]:
    """(this rank's block of each entry of a full ``cache``, as a new
    contiguous tensor; the specs, K/V's as :func:`placed_kv_spec` places
    them). Call inside ``use_mesh``."""
    specs = cache_specs(cache, cfg, mesh)
    for name, length in (("k", None), ("v", None), ("attn_k", None), ("attn_v", None),
                         ("cross_k", cfg.encoder_frames), ("cross_v", cfg.encoder_frames)):
        if name in specs:
            specs[name] = placed_kv_spec(specs[name], tuple(cache[name].shape), mesh)
            dims = [i - 1 for i, e in enumerate(specs[name]) if e == MODEL_AXIS]
            if (dims[0] if dims else None) != kv_cache_dim(cfg, mesh, length):
                raise ValueError(f"cache {name}: its {cache[name].shape[3]} rows do not divide "
                                 f"into the model axis, as the attention's placement assumes")
    return {k: sh.block(t, specs[k]).contiguous().clone() for k, t in cache.items()}, specs


@torch.no_grad()
def gather_params(params: nn.Module, specs: dict) -> None:
    """Undo the data-axis split of an FSDP placement in place by all-gathers
    (counted), for a prefill or decode step that reads its parameters whole;
    the blocks split over the model axis stay this rank's."""
    for name, p in list(params.named_parameters()):
        t = sh.gather_block(p.data, tuple(None if e == MODEL_AXIS else e for e in specs[name]))
        if t.shape != p.shape:
            _replace(params, name, t, p.requires_grad)


def partial_grad_names(params: nn.Module, seq_len: Optional[int] = None) -> list[str]:
    """The replicated parameters that a split region reads, whose gradients
    are partial sums on each rank and need an all-reduce over the model axis:
    an attention's norms (and ``wk``/``wv`` where its kv heads are not split)
    when its heads are split; a split Mamba2 block's ``w_in`` (its product
    enters the split region) and ``A_log``, ``D``, ``dt_bias`` (each rank
    reads its heads' entries). (An mLSTM block enters its split region after
    its norm, and an sLSTM block after its whole scan: their replicated
    parameters see the whole gradient.) In a sequence-parallel stream
    (``sharding.seq_parallel``: the decoder's ``seq_len`` positions, the
    encoder's frames) also the norms that read the rank's block of the
    stream; the recurrent families keep their whole sequence. (An MoE's
    router reads the whole routing weights: its experts' part of them is
    all-reduced where it enters the split region.)"""
    from ..models.attention import Attention
    from ..models.encdec import EncDec
    from ..models.hybrid import MambaBlock
    from ..models.transformer import Transformer

    out = []
    for prefix, mod in params.named_modules():
        tp = getattr(mod, "tp", None)
        if isinstance(mod, Attention) and tp is not None and tp.heads:
            fields = ["q_norm", "k_norm"] + ([] if tp.kv else ["wk", "wv"])
            out += [f"{prefix}.{f}" for f in fields if getattr(mod, f) is not None]
        elif isinstance(mod, MambaBlock) and tp is not None and tp.heads:
            out += [f"{prefix}.{f}" for f in ("w_in", "A_log", "D", "dt_bias")]
    if seq_len is None or not isinstance(params, (Transformer, EncDec)):
        return out
    encoder = isinstance(params, EncDec) and sh.seq_parallel(params.cfg.encoder_frames)
    for name, p in params.named_parameters():
        if p.dim() != 1 or name.rsplit(".", 1)[-1] in ("q_norm", "k_norm"):
            continue
        on_encoder = name.startswith("encoder.") or name == "enc_norm"
        if (encoder if on_encoder else sh.seq_parallel(seq_len)):
            out.append(name)
    return out


def as_dtensors(tensors: dict, specs: dict, mesh) -> dict:
    """``DTensor``s of placed blocks (name -> local block), for a checkpoint
    or an inspection of the global layout; the models compute on the blocks."""
    from torch.distributed.tensor import DTensor

    return {name: DTensor.from_local(t, mesh, sh.placements(specs[name], mesh),
                                     run_check=False)
            for name, t in tensors.items()}
