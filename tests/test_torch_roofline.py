"""The port's roofline counter (``repro_torch.roofline.count``) against
``repro.roofline.hlo``.

- The collective algorithm factors of the port's counted collectives
  (``sharding.wire_bytes``) equal ``analyze_hlo``'s on synthetic HLO of each
  kind and group size, and ``Roofline``'s terms equal the reference's on the
  same counts, with the reference's peaks passed in explicitly.
- The FLOPs the port counts for smoke llama3.2-1b's ``decode_step`` (batch
  2, cache 64) and ``prefill`` (8 tokens) equal ``analyze_hlo``'s on the
  reference's single-device compiled HLO (5,505,024 for the decode), dot
  for dot: no op accounts for a difference.
- On a 2-rank fake mesh (1, 2), smoke llama3.2-1b's and
  granite-moe-1b-a400m's local decode and prefill issue exactly the Megatron
  count: two forward all-reduces a layer (attention's ``wo``, the FFN's
  ``w_down`` or the MoE's combined experts) and one for the vocab-split
  embedding, and nothing else.
"""
from _torch_cpu import child_env
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.roofline import hlo
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model
from repro_torch.roofline.count import H100_SXM5, Peaks, Roofline, count

ROOT = Path(__file__).resolve().parents[1]
TPU_V5E = Peaks(flops=hlo.PEAK_FLOPS_BF16, hbm_bytes=hlo.HBM_BW, link_bytes=hlo.ICI_BW)

_OPS = {"all-reduce": "all-reduce(%p), replica_groups={G}, to_apply=%add",
        "all-gather": "all-gather(%p), replica_groups={G}, dimensions={0}",
        "reduce-scatter": "reduce-scatter(%p), replica_groups={G}, dimensions={0}, to_apply=%add",
        "all-to-all": "all-to-all(%p), replica_groups={G}, dimensions={0}",
        "collective-permute": "collective-permute(%p), source_target_pairs={{0,1},{1,0}}"}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", list(_OPS))
def test_collective_factors_match_reference(kind, g):
    n = 65536
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    text = ("HloModule m\n\nENTRY %main (p: f32[65536]) -> f32[65536] {\n"
            "  %p = f32[65536]{0} parameter(0)\n"
            f"  ROOT %c = f32[65536]{{0}} {_OPS[kind].replace('{G}', groups)}\n}}\n")
    st = hlo.analyze_hlo(text, default_group=g)
    assert st.count_by_kind[kind] == 1
    assert sh.wire_bytes(kind, n * 4, g) == pytest.approx(st.collective_bytes, rel=1e-12)


@pytest.mark.parametrize("counts", [(197e12, 819e9 * 2, 0.0, 1, 197e12),
                                    (3.1e15, 2.2e11, 7.5e10, 256, 1.1e17),
                                    (1.0e9, 1.0e6, 4.0e12, 16, 2.0e10)])
def test_roofline_terms_match_reference(counts):
    flops, hbm, coll, chips, model_flops = counts
    want = hlo.Roofline(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips,
                        model_flops=model_flops)
    got = Roofline(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips,
                   model_flops=model_flops, peaks=TPU_V5E)
    for term in ("t_compute", "t_memory", "t_collective", "useful_flops_ratio"):
        assert getattr(got, term) == pytest.approx(getattr(want, term), rel=1e-12), term
    assert got.bottleneck == want.bottleneck
    # the default peaks are the H100's data sheet, no TPU figure
    assert Roofline(flops, hbm, coll, chips, model_flops).peaks == H100_SXM5
    assert H100_SXM5.flops == 989e12 and H100_SXM5.hbm_bytes == 3.35e12


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_smoke_config("llama3.2-1b")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config("llama3.2-1b"), device="cpu")
    tp = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def test_decode_flops_match_analyze_hlo(llama):
    jm, jp, tm, tp = llama
    tokens = np.zeros((2, 1), np.int32)
    jcache = jm.init_cache(2, 64)
    text = jax.jit(jm.decode_step).lower(jp, jcache, jnp.asarray(tokens)).compile().as_text()
    want = hlo.analyze_hlo(text)
    _, got = count(tm.decode_step, tp, tm.init_cache(2, 64), torch.tensor(tokens))
    assert want.flops == 5_505_024
    assert got.flops == want.flops
    assert got.dot_count == want.dot_count


def test_prefill_flops_match_analyze_hlo(llama):
    jm, jp, tm, tp = llama
    tokens = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)
    jcache = jm.init_cache(2, 64)
    text = jax.jit(jm.prefill).lower(jp, {"tokens": jnp.asarray(tokens)},
                                     jcache).compile().as_text()
    want = hlo.analyze_hlo(text)
    _, got = count(tm.prefill, tp, {"tokens": torch.tensor(tokens)}, tm.init_cache(2, 64))
    assert got.flops == want.flops
    assert got.dot_count == want.dot_count


def test_hbm_bytes_count_results_twice():
    x = torch.ones(256, 256)
    _, st = count(lambda t: t * 2.0 + 1.0, x)
    assert st.hbm_bytes == 2 * 2 * 256 * 256 * 4  # two results, written and read once
    _, st = count(lambda t: t.view(-1).t() if t.dim() == 2 else t, x)
    assert st.hbm_bytes == 0  # views move nothing


_MEGATRON = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shardings
from repro_torch.models.model import build_model
from repro_torch.roofline.count import count
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
out = {}
for arch in ("llama3.2-1b", "granite-moe-1b-a400m"):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)):
        shardings.place_params(params, cfg, mesh)
        cache, _ = shardings.place_cache(model.init_cache(2, 32), cfg, mesh)
        tokens = torch.zeros((2, 8), dtype=torch.int32)
        _, pre = count(model.prefill, params, {"tokens": tokens}, cache)
        _, dec = count(model.decode_step, params, cache, tokens[:, :1])
    out[arch] = {"layers": cfg.n_layers, "prefill": pre.count_by_kind, "decode": dec.count_by_kind}
print(json.dumps(out))
"""


def test_megatron_collective_counts_on_a_fake_mesh():
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _MEGATRON], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for arch, c in json.loads(res.stdout.strip().splitlines()[-1]).items():
        want = {k: 0 for k in sh.COLLECTIVES}
        want["all-reduce"] = 2 * c["layers"] + 1
        assert c["prefill"] == want, arch
        assert c["decode"] == want, arch
