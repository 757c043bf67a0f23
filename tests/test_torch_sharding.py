"""The port's sharding rules (``repro_torch.launch.shardings``,
``repro_torch.distributed.sharding``) against ``repro``'s pure functions.

For every arch of the registry at its full config, on mesh stand-ins of the
production sizes (16x16 and 2x16x16: an object with ``.shape``, ``.axis_names``
and ``.devices``, all that ``repro/launch/shardings.py`` reads), so no 256
JAX devices are needed:

- every parameter: the port's ``param_spec`` of its per-layer tensor is the
  reference's spec of the stacked leaf with the stack dim dropped (the
  reference's leaves come from ``jax.eval_shape`` of ``init``), and
  ``add_fsdp_axes`` of the reference's leaf spec is the reference's;
- every cache entry (decode_32k's cache, and with the length-sharded
  flash-decode's ``FORCE_SEQ_SHARD_CACHE``): ``cache_spec``;
- ``make_rules``, ``dp_only_rules``, ``batch_spec`` and ``_guard``.

``shard`` is a no-op outside a mesh; under a mesh (a ``"fake"`` process
group of 256 ranks, in a subprocess since a process group is process-global)
it keeps a dim that its mesh axes do not divide: the port's counterpart of
``tests/test_shardings.py::test_shard_divisibility_guard_noop``, which is red
in this container for the reference.
"""
from _torch_cpu import child_env
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS, get_config as jax_get_config
from repro.launch import shardings as ref
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shardings as port
from repro_torch.launch.specs import INPUT_SHAPES, input_specs
from repro_torch.models.convert import reference_ndim
from repro_torch.models.model import _FAMILIES, build_model

ROOT = Path(__file__).resolve().parents[1]


class _Mesh:
    """A production mesh as the reference's pure functions read it."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=np.int8)


MESHES = {"16x16": _Mesh({"data": 16, "model": 16}),
          "2x16x16": _Mesh({"pod": 2, "data": 16, "model": 16})}


def _norm(spec) -> tuple:
    """A spec as a tuple of axis tuples (None -> ())."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def _ref_leaves(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref._path_str(path): tuple(leaf.shape) for path, leaf in leaves}


def _ref_param_path(name: str) -> str:
    """The reference's leaf path of a port parameter: the layer index after
    a stacked prefix, and an mLSTM block's index in its group, dropped."""
    out: list[str] = []
    for part in name.split("."):
        if part.isdigit() and out and out[-1] in ("layers", "encoder", "decoder", "mamba"):
            continue
        if part.isdigit() and len(out) >= 2 and out[-2] == "groups" and out[-1].isdigit():
            continue
        out.append(part)
    return "/".join(out)


def _ref_cache_path(name: str, ref_paths: set) -> str:
    """xlstm's ``g{gi}.<state>`` -> ``states/{gi}/<tuple index>``."""
    if not name.startswith("g") or "." not in name:
        return name
    gi, field = name[1:].split(".")
    kind = ("c", "n", "h", "m") if f"states/{gi}/3" in ref_paths else ("C", "n", "m")
    return f"states/{gi}/{kind.index(field)}"


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """(arch, jax cfg, port cfg, reference param leaves, port params on meta)."""
    a = request.param
    jcfg, cfg = jax_get_config(a), get_config(a)
    jm = jax_build_model(jcfg)
    leaves = _ref_leaves(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    params = _FAMILIES[cfg.family][1](cfg, torch.device("meta"))
    return a, jcfg, cfg, leaves, params


@pytest.mark.parametrize("mesh", MESHES)
def test_param_specs_match_reference(arch, mesh):
    _, jcfg, cfg, leaves, params = arch
    m = MESHES[mesh]
    ndim = reference_ndim(params)
    data_axes = port.data_axes_of(m)
    seen = set()
    for name, p in params.named_parameters():
        path = _ref_param_path(name)
        assert path in leaves, f"{name} -> {path} is not a reference leaf"
        seen.add(path)
        shape = leaves[path]
        stacked = len(shape) == p.dim() + 1
        assert stacked == (ndim[name] > p.dim()), name
        assert shape[stacked:] == tuple(p.shape), name
        want = tuple(ref.param_spec(path, shape, jcfg, m))
        got = port.param_spec(name, tuple(p.shape), cfg, m, stacked=stacked)
        assert _norm(got) == _norm(want[1:] if stacked else want), name
        assert _norm(port.add_fsdp_axes(want, shape, m, data_axes)) == \
            _norm(ref.add_fsdp_axes(ref.param_spec(path, shape, jcfg, m), shape, m,
                                    data_axes)), name
    assert seen == set(leaves)


@pytest.mark.parametrize("force_seq", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_cache_specs_match_reference(arch, mesh, force_seq, monkeypatch):
    a, jcfg, cfg, _, _ = arch
    m = MESHES[mesh]
    monkeypatch.setattr(ref, "FORCE_SEQ_SHARD_CACHE", force_seq)
    monkeypatch.setattr(port, "FORCE_SEQ_SHARD_CACHE", force_seq)
    B, S = INPUT_SHAPES["decode_32k"].global_batch, INPUT_SHAPES["decode_32k"].seq_len
    jm = jax_build_model(jcfg)
    ref_cache = _ref_leaves(jax.eval_shape(lambda: jm.init_cache(B, S)))
    cache = build_model(cfg, device="meta").init_cache(B, S)
    data_axes = port.data_axes_of(m)
    assert port.data_axes_of(m) == (tuple(x for x in ("pod", "data") if x in m.axis_names))
    seen = set()
    for name, t in cache.items():
        path = _ref_cache_path(name, set(ref_cache))
        assert ref_cache[path] == tuple(t.shape), name
        seen.add(path)
        want = ref.cache_spec(path, ref_cache[path], jcfg, m, data_axes)
        assert _norm(port.cache_spec(name, tuple(t.shape), cfg, m, data_axes)) == _norm(want), \
            (a, name)
    assert seen == set(ref_cache)


class _CardMesh(_Mesh):
    device_type = "cuda"


@pytest.mark.parametrize("mesh", MESHES)
def test_card_places_whole_kv_rows(arch, mesh):
    """On a CUDA mesh a K/V cache keeps every row's head_dim whole: the
    reference's head_dim split moves to the length (the flash-decode's
    placement), or off the model axis where the length does not divide;
    any other spec is the reference's. A CPU mesh keeps the reference's."""
    a, jcfg, cfg, _, _ = arch
    m = MESHES[mesh]
    card = _CardMesh(m.shape)
    data_axes = port.data_axes_of(m)
    B, S = INPUT_SHAPES["decode_32k"].global_batch, INPUT_SHAPES["decode_32k"].seq_len
    cache = build_model(cfg, device="meta").init_cache(B, S)
    for name in ("k", "v", "cross_k", "cross_v"):
        if name not in cache:
            continue
        shape = tuple(cache[name].shape)
        want = ref.cache_spec(name, shape, jcfg, m, data_axes)
        got = port.cache_spec(name, shape, cfg, m, data_axes)
        assert _norm(port.placed_kv_spec(got, shape, m)) == _norm(want), (a, name)
        placed = _norm(port.placed_kv_spec(got, shape, card))
        assert placed[4] == (), (a, name)
        if _norm(want)[4] == ("model",):
            split = shape[3] % 16 == 0
            assert placed == _norm(want)[:3] + ((("model",) if split else ()), ()), (a, name)
        else:
            assert placed == _norm(want), (a, name)
        length = cfg.encoder_frames if name.startswith("cross") else None
        assert port.kv_cache_dim(cfg, card, length) != 3, (a, name)


@pytest.mark.parametrize("mesh", MESHES)
def test_rules_and_batch_specs_match_reference(mesh):
    m = MESHES[mesh]
    data_axes = port.data_axes_of(m)
    for a in ARCH_IDS:
        want = ref.make_rules(jax_get_config(a), m)
        got = port.make_rules(get_config(a), m)
        assert {k: _norm([v])[0] for k, v in got.items()} == \
            {k: _norm([v])[0] for k, v in want.items()}, a
        for shape_name in INPUT_SHAPES:
            spec = input_specs(get_config(a), shape_name)
            for name, t in spec["batch"].items():
                assert _norm(port.batch_spec(name, tuple(t.shape), m, data_axes)) == \
                    _norm(ref.batch_spec(name, tuple(t.shape), m, data_axes)), (a, name)
    for gb in (None, 512, 256, 32, 1):
        assert port.dp_only_rules(m, gb) == ref.dp_only_rules(m, gb)
    for spec, shape in (((None, "model"), (7, 48)), (("model", None), (32, 5)),
                        ((data_axes, None, "model"), (256, 3, 17))):
        assert _norm(port._guard(spec, shape, m)) == _norm(ref._guard(spec, shape, m))


def test_shard_is_a_noop_outside_a_mesh():
    x = torch.ones(2, 1, 8)
    assert sh.current_mesh() is None
    assert sh.shard(x, "batch", "seq", None) is x
    assert sh.shard(x, "batch", None, "expert") is x
    assert sh.named_sharding("batch") is None and sh.axis_size("model") == 1


_UNDER_A_MESH = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import _FAMILIES
from torch.distributed.tensor import Replicate, Shard
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device_type="cpu")
with sh.use_mesh(mesh, {"seq": "model", "batch": None}):
    x = torch.ones(2, 1, 8)
    assert sh.shard(x, "batch", "seq", None).shape == x.shape      # 1 row: kept whole
    # the programs split a sequence-parallel stream themselves (the recurrent
    # families keep theirs whole): shard leaves it as it is
    assert sh.shard(torch.ones(2, 32, 8), "batch", "seq", None).shape == (2, 32, 8)
    assert sh.seq_parallel(32) and not sh.seq_parallel(1) and not sh.seq_parallel(24)
    assert sh.logical_to_spec("batch", None, "heads", None) == (None, None, "model", None)
with sh.use_mesh(mesh):
    assert sh.shard(torch.ones(2, 3, 32, 5), "batch", None, "expert", None).shape == (2, 3, 2, 5)
    assert sh.shard(torch.ones(2, 3, 24, 5), "batch", None, "expert", None).shape == (2, 3, 24, 5)
    assert sh.named_sharding("batch", None, "vocab").placements == [Shard(0), Shard(2)]
    assert sh.placements((None, "model"), mesh) == [Replicate(), Shard(1)]
    cfg = get_config("llama3.2-1b")
    params = _FAMILIES[cfg.family][1](cfg, torch.device("meta"))
    specs = shardings.place_params(params, cfg, mesh)
    assert params.layers[0].attn.wq.shape == (2048, 2, 64)           # 32 heads / 16
    assert params.layers[0].attn.wk.shape == (2048, 8, 64)           # kv 8: replicated
    assert params.embed.shape == (128256 // 16, 2048)
    assert params.layers[0].attn.tp.cache_dim == 3                   # head_dim split
    full = shardings.as_dtensors(dict(params.named_parameters()), specs, mesh)
    assert tuple(full["layers.0.mlp.w_down"].shape) == (8192, 2048)
print("ok")
"""


def test_shard_under_a_production_mesh():
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _UNDER_A_MESH], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
