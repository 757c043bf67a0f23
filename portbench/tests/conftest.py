"""Small copies of the benchmark's cells for the CPU tests: the same
files, families and mixes, at the family-preserving small sizes of the
program's ``smoke_variant`` (2 to 4 layers, d_model 256, f32) but the
published vocabularies (the gaps compared are measured against the best of
the whole vocabulary), with short prompts, built in a temporary checkout root next to a copy of the
benchmark's own files."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke_config(name: str, depth: int = 1) -> dict:
    """The configuration file ``name`` at small sizes (``depth`` times the
    smallest depth), its init scales worked out for them the way the
    file's are for the published widths."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    d, hd = 256, 64
    cfg.update(d_model=d, n_heads=4, head_dim=hd, dtype="float32")
    if cfg["family"] == "moe":
        cfg.update(n_layers=2 * depth, n_kv_heads=2, d_ff=128)
        cfg["moe"].update(n_experts=4, top_k=2, d_expert=128)
        de = 128
        cfg["init"] = [
            ["embed", "normal", 0.02], [".*ln[12]|final_norm", "const", 1.0],
            [".*attn\\.w[qkv]", "normal", d ** -0.5], [".*attn\\.wo", "normal", (4 * hd) ** -0.5],
            [".*mlp\\.router", "normal", 4 * d ** -0.5],
            [".*mlp\\.w_(gate|up)", "normal", d ** -0.5],
            [".*mlp\\.w_down", "normal", de ** -0.5]]
    else:
        cfg.update(n_layers=4 * depth, n_kv_heads=4, d_ff=512, hybrid_attn_every=2,
                   sliding_window=64)
        cfg["ssm"].update(d_state=16, chunk=32)
        scale = {".*w_in": d ** -0.5, ".*w_out": 0.5 * (2 * d) ** -0.5, "unembed": d ** -0.5,
                 ".*attn\\.w[qkv]": d ** -0.5, ".*attn\\.wo": (4 * hd) ** -0.5,
                 ".*mlp\\.w_(gate|up)": d ** -0.5, ".*mlp\\.w_down": 512 ** -0.5}
        cfg["init"] = [[p, k, scale.get(p, v)] for p, k, v in cfg["init"]]
    return cfg


SMOKE_MIXES = {
    "chat": {"block": 6, "prompt": {"dist": "uniform", "low": 16, "high": 40, "multiple": 8},
             "output": {"dist": "loguniform", "low": 4, "high": 16}, "pair_stride": 5,
             "profile_requests": 2},
    "docs": {"block": 4, "prompt": {"dist": "uniform", "low": 40, "high": 56, "multiple": 16},
             "output": {"dist": "uniform", "low": 2, "high": 6}, "pair_stride": 3,
             "profile_requests": 2},
}


# the control test's mixes: longer answers, so that a short window compares
# some hundreds of tokens, as a run at the cells' size does
LONG_MIXES = {
    "chat": dict(SMOKE_MIXES["chat"], output={"dist": "loguniform", "low": 16, "high": 64}),
    "docs": dict(SMOKE_MIXES["docs"], output={"dist": "uniform", "low": 16, "high": 48}),
}


def make_tree(root: Path, depth: int = 1, mixes: dict = SMOKE_MIXES) -> Path:
    """A checkout root holding a small copy of the benchmark: the real
    ``BENCHMARK.json``, harness code, references, metrics and cell files,
    with small configurations and mixes in place of the real ones."""
    bench = root / "portbench"
    for sub in ("reference", "metrics", "cells"):
        shutil.copytree(BENCH / sub, bench / sub, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs").mkdir()
    for c in spec["configs"]:
        (root / c["file"]).write_text(json.dumps(smoke_config(c["name"], depth)))
    (bench / "traffic").mkdir()
    for name, mix in mixes.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    return root


@pytest.fixture
def tree(tmp_path) -> Path:
    return make_tree(tmp_path)


@pytest.fixture
def deep_tree(tmp_path) -> Path:
    """Four times the small depth (8 granite layers, 16 Mamba2 layers and 8
    applications of the shared block), with the long answers."""
    return make_tree(tmp_path, depth=4, mixes=LONG_MIXES)
