"""The harness is driven by files: a configuration, a traffic mix, a cell
and a per-layer metric added as new files and new ``BENCHMARK.json``
entries run with no edit to a file that is there; and what a run loads."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_config_cell_mix_and_metric_are_files_only(tree):
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    bench = tree / "portbench"
    # a new configuration: the small granite at 3 layers, under a new name
    cfg = json.loads((bench / "configs" / "granite-moe-1b-a400m.json").read_text())
    cfg.update(name="granite-3l", n_layers=3)
    (bench / "configs" / "granite-3l.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "granite-3l", "source": "https://example.org/granite-3l",
                            "file": "portbench/configs/granite-3l.json", "reduced": ["n_layers"],
                            "why": "a test"})
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"block": 3, "prompt": {"dist": "uniform", "low": 8, "high": 24, "multiple": 8},
         "output": {"dist": "uniform", "low": 2, "high": 4}, "pair_stride": 2,
         "profile_requests": 1}))
    (bench / "cells" / "granite3_tiny.json").write_text(json.dumps(
        {"sample": 2, "limits": {"gap_max": 0.5}}))
    spec["workloads"].append({"name": "granite3_tiny", "config": "granite-3l", "traffic": "tiny",
                              "chips": 1, "why": "a test"})
    (bench / "metrics" / "prompt_tokens.py").write_text(
        "def read(ctx):\n    return sum(len(d.req.prompt) for d in ctx['requests'])\n")
    spec["per_layer"].append({"name": "prompt_tokens", "unit": "tokens", "better": "higher",
                              "source": "program_counter", "layer": "serving engine",
                              "moves": "req_ms_p50", "workloads": ["granite3_tiny"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))

    torch.set_num_threads(2)
    res = harness.run(tree, "granite3_tiny", 9, 0.5, False, device="cpu")
    assert res["correct"] and res["attempted"] >= 1
    cell = harness.load_cell(tree, "granite3_tiny")
    assert cell.config["n_layers"] == 3 and cell.mix["block"] == 3
    assert [m["name"] for m in cell.per_layer] == ["prompt_tokens"]
    req = type("D", (), {"req": type("R", (), {"prompt": [1] * 8})(), "spans": [],
                         "wall_ms": 1.0})()
    out = harness.per_layer(cell, {"requests": [req, req], "profile": None})
    assert out == {"prompt_tokens": {"value": 16, "unit": "tokens"}}


def test_each_per_layer_metric_has_its_file_and_cells_report_what_it_moves():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in spec["workloads"]:
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").is_file()
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole small run in a fresh process, then the names it loaded."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}, {tests!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from conftest import make_tree\n"
        "from portbench import harness\n"
        "res = harness.run(make_tree(Path({tmp!r})), 'zamba2_docs', 4, 0.5, False, device='cpu')\n"
        "assert res['correct']\n"
        "res = harness.run(Path({tmp!r}), 'granite_chat', 4, 0.5, False, device='cpu')\n"
        "assert res['correct']\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
        "print(harness.forbidden_modules())\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"), tests=str(ROOT / "portbench" / "tests"),
             tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert f"'{name}'" not in loaded
    assert "'repro_torch'" in loaded


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "granite_chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 3 and out.stdout == ""
    assert "CUDA" in out.stderr
