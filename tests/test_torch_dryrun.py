"""The port's dry-run (``python -m repro_torch.launch.dryrun``) in a
subprocess (a ``"fake"`` process group is process-global), with no device
and no JAX: the port's counterpart of
``tests/test_dryrun_integration.py``, whose 256/512-device compiles are red
in this container for the reference.

- qwen3-0.6b x decode_32k prints ``OK`` on the 16x16 mesh;
- whisper-small x long_500k prints ``SKIP`` (no long-context variant);
- through ``run_one`` in one child process: llama3.2-1b x train_4k counts
  the data-axis gradient all-reduces (one a parameter) beside the Megatron
  ones, and decode_32k with ``decode_attn="shard_map"`` runs the
  length-sharded flash-decode (three merges a layer, q gathered).
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
out = {tag: run_one("llama3.2-1b", shape, decode_attn=attn, save=False, verbose=False)
       for tag, shape, attn in (("train", "train_4k", "local"), ("local", "decode_32k", "local"),
                                ("sm", "decode_32k", "shard_map"))}
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


def test_train_combo_counts_gradient_all_reduces(llama):
    res = llama["train"]
    assert res["status"] == "ok" and res["memory"]["temp_bytes"] > 0
    counts = res["roofline"]["collective_counts"]
    n_params, layers = 2 + 16 * 9, 16  # embed, final_norm; 9 tensors a layer
    data = n_params                    # a data-axis all-reduce a gradient
    kv_grads = 2 * layers              # wk, wv: whole on each rank, read by split heads
    forward = 2 * layers + 1           # wo, w_down a layer; the vocab-split embedding
    remat = layers                     # the recompute stops after wo's (early stop)
    backward = 2 * layers + 1          # Megatron's f: attention and FFN entries, unembed
    loss = 3                           # the vocab-split loss: max, sum, gold logit
    assert counts["all-reduce"] == data + kv_grads + forward + remat + backward + loss
    assert counts["all-gather"] == 0


def test_shard_map_decode_runs_the_length_sharded_path(llama):
    c_local = llama["local"]["roofline"]["collective_counts"]
    c_sm = llama["sm"]["roofline"]["collective_counts"]
    # local (cache split over head_dim): the score all-reduce, q and o gathers
    assert c_local["all-reduce"] == 3 * 16 + 1 and c_local["all-gather"] == 2 * 16
    # shard_map: three merges, q gathered (kv heads are whole)
    assert c_sm["all-reduce"] == 5 * 16 + 1 and c_sm["all-gather"] == 16
