"""The port's dry-run (``python -m repro_torch.launch.dryrun``) in a
subprocess (a ``"fake"`` process group is process-global), with no device
and no JAX: the port's counterpart of
``tests/test_dryrun_integration.py``, whose 256/512-device compiles are red
in this container for the reference.

- qwen3-0.6b x decode_32k prints ``OK`` on the 16x16 mesh;
- whisper-small x long_500k prints ``SKIP`` (no long-context variant);
- through ``run_one`` in one child process: llama3.2-1b x train_4k counts
  the data-axis gradient all-reduces (one a parameter) beside the Megatron
  ones, the global norm's and the metrics' scalar all-reduces, and each of
  ``repro``'s hillclimb knobs (``dp_only``, ``fsdp``, both at once,
  ``accum_steps=2``, ``seq_parallel``) its own collectives by a formula
  derived by hand;
  decode_32k with ``decode_attn="shard_map"`` runs the length-sharded
  flash-decode (three merges a layer, q gathered);
- zamba2-1.2b and xlstm-1.3b at the four shapes run their own
  tensor-parallel program: rank 0's argument bytes are the blocks' sizes
  under the specs (parameters, batch, cache, AdamW's three f32 copies),
  and every all-gather is one of the program's activation gathers (a
  Mamba2 block's conv output, an mLSTM block's projection, in decode an
  sLSTM block's two gathers of h; in training each again in the remat
  recompute), so none gathers a parameter; xlstm's train_4k and
  prefill_32k each finish in under two minutes;
- the scans counted once (``count(..., scan_once=True)``, what the dry-run
  runs) against a full trace at a short length, depth cut: a prefill's
  FLOPs, bytes, matmuls and collectives are equal; a train step's
  collectives are equal, and its FLOPs and bytes are the full trace's or
  at most 15% more (each trip counted as a middle step's body, with the
  carried state's gradient, as a while loop's body times its trip count).
"""
from _torch_cpu import child_env
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_RUN = r"""
import runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    assert "jax" not in sys.modules, "the dry-run imported jax"
"""


def _dryrun(*args: str) -> subprocess.CompletedProcess:
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", _RUN, *args], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)


_LLAMA = r"""
import json, sys
from repro_torch.launch.dryrun import run_one
out = {tag: run_one("llama3.2-1b", shape, decode_attn=attn, save=False, verbose=False, **knob)
       for tag, shape, attn, knob in (
           ("train", "train_4k", "local", {}), ("local", "decode_32k", "local", {}),
           ("sm", "decode_32k", "shard_map", {}),
           ("dp_only", "train_4k", "local", {"dp_only": True}),
           ("fsdp", "train_4k", "local", {"fsdp": True}),
           ("dp_only_fsdp", "train_4k", "local", {"dp_only": True, "fsdp": True}),
           ("accum", "train_4k", "local", {"accum_steps": 2}),
           ("seq_parallel", "train_4k", "local", {"seq_parallel": True}))}
assert "jax" not in sys.modules, "the dry-run imported jax"
print(json.dumps(out))
"""


def _result(name: str) -> dict:
    return json.loads((ROOT / "build" / "dryrun" / name).read_text())


@pytest.fixture(scope="module")
def llama():
    """llama3.2-1b's train_4k, and decode_32k local and shard_map, through
    ``run_one`` in one child process."""
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _LLAMA], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_decode_combo_prints_ok():
    out = _dryrun("--arch", "qwen3-0.6b", "--shape", "decode_32k")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "OK   qwen3-0.6b x decode_32k x 1pod:" in out.stdout
    res = _result("qwen3-0.6b_decode_32k_1pod.json")
    assert res["chips"] == 256 and res["roofline"]["flops_per_dev"] > 0
    assert res["memory"]["argument_bytes"] > 0


def test_encdec_long_context_is_skipped():
    out = _dryrun("--arch", "whisper-small", "--shape", "long_500k")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SKIP whisper-small x long_500k x 1pod" in out.stdout


N_PARAMS, LAYERS = 2 + 16 * 9, 16  # embed, final_norm; 9 tensors a layer
PER_LAYER = 9
KV_GRADS = 2 * LAYERS              # wk, wv: whole on each rank, read by split heads
FORWARD = 2 * LAYERS + 1           # wo, w_down a layer; the vocab-split embedding
REMAT = LAYERS                     # the recompute stops after wo's (early stop)
BACKWARD = 2 * LAYERS + 1          # Megatron's f: attention and FFN entries, unembed
LOSS = 3                           # the vocab-split loss: max, sum, gold logit
NORM = 1                           # the global norm: model-split blocks' sum of squares
METRICS = 1                        # loss, ce, nll, aux: the batch's means, one all-reduce


def test_train_combo_counts_gradient_all_reduces(llama):
    res = llama["train"]
    assert res["status"] == "ok" and res["memory"]["temp_bytes"] > 0
    assert res["opts"] == {"dp_only": False, "fsdp": False, "accum_steps": 1,
                           "cache_update": "onehot", "decode_attn": "local",
                           "seq_parallel": False}
    counts = res["roofline"]["collective_counts"]
    data = N_PARAMS                    # a data-axis all-reduce a gradient
    assert counts["all-reduce"] == (data + KV_GRADS + FORWARD + REMAT + BACKWARD + LOSS
                                    + NORM + METRICS)
    assert counts["all-gather"] == 0


def test_dp_only_has_no_tensor_parallel_collective(llama):
    counts = llama["dp_only"]["roofline"]["collective_counts"]
    # the batch over every mesh axis: one all-reduce a gradient over all of
    # them, and the metrics'; every gradient is whole, so the norm needs none
    assert counts["all-reduce"] == N_PARAMS + METRICS
    assert counts["all-gather"] == counts["reduce-scatter"] == 0


def test_fsdp_gathers_each_parameter_and_reduce_scatters_its_gradient(llama):
    counts = llama["fsdp"]["roofline"]["collective_counts"]
    # every llama3.2-1b tensor splits over the data axis: gathered where its
    # layer reads it and again in the layer's recompute; the gather's
    # backward reduce-scatters the gradient, so no data-axis all-reduce
    assert counts["all-gather"] == N_PARAMS + PER_LAYER * LAYERS
    assert counts["reduce-scatter"] == N_PARAMS
    # blocks split over (data) and over (data, model): two norm all-reduces
    assert counts["all-reduce"] == KV_GRADS + FORWARD + REMAT + BACKWARD + LOSS + 2 + METRICS


def test_dp_only_fsdp_splits_the_optimizer_state_alone(llama):
    counts = llama["dp_only_fsdp"]["roofline"]["collective_counts"]
    # ZeRO-1: whole parameters, each gradient averaged over every mesh axis;
    # the state's blocks split over (data) and (data, model): two norm
    # all-reduces; each new parameter gathered from its master block dim by
    # dim: embed, wq, wo, w_gate, w_up and w_down split twice (vocab, heads
    # or ff on the model axis, another dim on the data axis), the norms and
    # wk, wv (8 kv heads do not split 16 ways) once
    gathers = 2 + 1 + LAYERS * (1 + 2 + 1 + 1 + 2 + 1 + 2 + 2 + 2)
    assert counts["all-gather"] == gathers
    assert counts["all-reduce"] == N_PARAMS + 2 + METRICS
    assert counts["reduce-scatter"] == 0
    res = llama["dp_only_fsdp"]["memory"]["argument_bytes"]
    assert res < llama["dp_only"]["memory"]["argument_bytes"] / 2


def test_accumulation_doubles_megatron_and_reduces_the_data_axis_once(llama):
    counts = llama["accum"]["roofline"]["collective_counts"]
    micro = FORWARD + REMAT + BACKWARD + LOSS  # each micro-batch's forward and backward
    # the gradient reductions (partial sums, the data axis) once, after the sum
    assert counts["all-reduce"] == 2 * micro + KV_GRADS + N_PARAMS + NORM + METRICS
    assert counts["all-gather"] == counts["reduce-scatter"] == 0


def test_seq_parallel_replaces_each_activation_all_reduce(llama):
    counts = llama["seq_parallel"]["roofline"]["collective_counts"]
    # forward: a reduce-scatter at each exit (wo, w_down, the embedding) and
    # an all-gather at each entry (attention, FFN, the unembedding)
    exits, entries = 2 * LAYERS + 1, 2 * LAYERS + 1
    remat_ag, remat_rs = 2 * LAYERS, LAYERS  # the recompute stops after w_down's product
    # backward: each all-gather's gradient reduce-scattered and each
    # reduce-scatter's all-gathered
    assert counts["all-gather"] == entries + remat_ag + exits
    assert counts["reduce-scatter"] == exits + remat_rs + entries
    # ln1, ln2 and final_norm read the rank's block of the stream: their
    # gradients are partial sums over the model axis
    norms = 2 * LAYERS + 1
    assert counts["all-reduce"] == N_PARAMS + KV_GRADS + norms + LOSS + NORM + METRICS


def test_shard_map_decode_runs_the_length_sharded_path(llama):
    c_local = llama["local"]["roofline"]["collective_counts"]
    c_sm = llama["sm"]["roofline"]["collective_counts"]
    # local (cache split over head_dim): the score all-reduce, q and o gathers
    assert c_local["all-reduce"] == 3 * 16 + 1 and c_local["all-gather"] == 2 * 16
    # shard_map: three merges, q gathered (kv heads are whole)
    assert c_sm["all-reduce"] == 5 * 16 + 1 and c_sm["all-gather"] == 16


_RECURRENT = r"""
import json, sys, time
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import INPUT_SHAPES, config_for_shape, input_specs
from repro_torch.models.model import _FAMILIES

def nbytes(shape, dtype_size):
    n = 1
    for d in shape:
        n *= d
    return n * dtype_size

def expected_args(arch, shape):
    # rank 0's blocks under the specs, from the whole shapes
    cfg = config_for_shape(get_config(arch), shape)
    dryrun._fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    params = _FAMILIES[cfg.family][1](cfg, dryrun.META)
    specs = shardings.param_specs(params, cfg, mesh)
    spec = input_specs(cfg, shape)
    axes = shardings.data_axes_of(mesh)
    if INPUT_SHAPES[shape].global_batch % shardings._mesh_size(mesh, axes):
        axes = None
    total = 0
    for name, p in params.named_parameters():
        local = shardings.local_shape(tuple(p.shape), specs[name], mesh)
        total += nbytes(local, p.element_size()) * (1 + (12 // p.element_size() if spec["kind"] == "train" else 0))
    for k, t in spec["batch"].items():
        total += nbytes(shardings.local_shape(tuple(t.shape), shardings.batch_spec(k, tuple(t.shape), mesh, axes), mesh), t.element_size())
    if spec["cache"] is not None:
        cspecs = shardings.cache_specs(spec["cache"], cfg, mesh)
        for k, t in spec["cache"].items():
            total += nbytes(shardings.local_shape(tuple(t.shape), cspecs[k], mesh), t.element_size())
    return total

out = {}
for arch in ("zamba2-1.2b", "xlstm-1.3b"):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        t0 = time.perf_counter()
        res = dryrun.run_one(arch, shape, save=False, verbose=False)
        res["wall_s"] = time.perf_counter() - t0
        res["expected_args"] = expected_args(arch, shape)
        out[f"{arch}/{shape}"] = res
assert "jax" not in sys.modules, "the dry-run imported jax"
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def recurrent():
    """zamba2-1.2b and xlstm-1.3b at the four shapes through ``run_one``,
    with the wall time of each, in one child process."""
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RECURRENT], capture_output=True, text=True,
                         env=env, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _activation_gathers(arch: str, kind: str) -> int:
    """The all-gathers of the recurrent programs (see the module docstring):
    zamba2-1.2b has 38 Mamba2 blocks (its shared attention's 32 kv heads
    split 16 ways, so its decode gathers nothing); xlstm-1.3b 42 mLSTM and 6
    sLSTM blocks."""
    if arch == "zamba2-1.2b":
        return 38 * (2 if kind == "train" else 1)
    return 42 * (2 if kind == "train" else 1) + (2 * 6 if kind == "decode" else 0)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_recurrent_families_run_their_local_program(recurrent, arch, shape):
    res = recurrent[f"{arch}/{shape}"]
    assert res["status"] == "ok", res
    assert res["memory"]["argument_bytes"] == res["expected_args"]
    counts = res["roofline"]["collective_counts"]
    kind = {"train_4k": "train", "prefill_32k": "prefill"}.get(shape, "decode")
    assert counts["all-gather"] == _activation_gathers(arch, kind), counts
    # every reduce-scatter is an activation gather's backward
    assert counts["reduce-scatter"] == (_activation_gathers(arch, kind) // 2
                                        if kind == "train" else 0), counts


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_xlstm_long_shapes_finish_in_two_minutes(recurrent, shape):
    assert recurrent[f"xlstm-1.3b/{shape}"]["wall_s"] < 120


_SCAN_ONCE = r"""
import dataclasses, json, sys
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, shardings, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.count import count

arch, shape, seq, layers = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
specs.INPUT_SHAPES[shape] = dataclasses.replace(specs.INPUT_SHAPES[shape], seq_len=seq)
dryrun._fake_world(256)
mesh = make_production_mesh(device_type="cpu")
cfg = dataclasses.replace(specs.config_for_shape(get_config(arch), shape), n_layers=layers)
out = {}
for once in (True, False):
    with sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)):
        fn, _ = dryrun.build_lowerable(cfg, shape, mesh)
        _, st = count(fn, scan_once=once)
    out[str(once)] = {"flops": st.flops, "bytes": st.hbm_bytes, "dots": st.dot_count,
                      "collectives": st.count_by_kind, "wire": st.collective_bytes}
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch,shape,seq,layers", [
    ("xlstm-1.3b", "prefill_32k", 512, 8), ("xlstm-1.3b", "train_4k", 512, 8),
    ("zamba2-1.2b", "prefill_32k", 1024, 6), ("zamba2-1.2b", "train_4k", 1024, 6)])
def test_scan_counted_once_matches_a_full_trace(arch, shape, seq, layers):
    """At ``seq`` tokens (2 and 4 chunks of 256; the sLSTM's 512 steps) and
    ``layers`` layers (one mLSTM group and its sLSTM; one Mamba2 group)."""
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _SCAN_ONCE, arch, shape, str(seq), str(layers)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    once, full = out["True"], out["False"]
    assert once["collectives"] == full["collectives"] and once["wire"] == full["wire"]
    if shape == "prefill_32k":
        assert once == full
    else:
        for key in ("flops", "bytes"):
            assert full[key] <= once[key] <= 1.15 * full[key], (key, once[key], full[key])
