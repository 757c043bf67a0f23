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
  flash-decode (three merges a layer, q gathered).
"""
import json
import os
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
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
