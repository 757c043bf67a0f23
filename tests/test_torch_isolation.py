"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
``jax`` and nothing of ``repro``, the framework-free modules are copies of
``repro``'s (byte for byte once ``repro_torch`` is read as ``repro``), and the
entry points refuse to run quietly on the CPU when no card is present.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

VERBATIM = [
    "core/policy.py", "core/lifecycle.py", "core/queue.py", "core/cost.py",
    "core/elysium.py", "core/control.py", "core/substrate.py",
    "faults/__init__.py", "analysis/sanitizer.py", "sim/variation.py",
    "sim/platform.py", "sim/workload.py", "sim/metrics.py", "sim/experiment.py",
    "sim/arrivals.py", "sim/workflow_dag.py", "configs/registry.py",
    "fleet/__init__.py", "fleet/policies.py", "fleet/resilience.py", "fleet/router.py",
    "data/pipeline.py",
] + sorted(
    f"configs/{p.name}" for p in (REF / "configs").glob("*.py")
    if p.name not in ("base.py", "registry.py")
)


# near copies: the lines the port adds to the reference file, each exactly
# once; without them the file is a copy. serving/pipeline.py builds its two
# backends on the device the caller names (the card unless told otherwise)
NEAR_COPIES = {
    "serving/pipeline.py": ("    device=None,\n", "        device=device,\n"),
}


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _scanned_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_needs_no_jax_and_loads_no_repro():
    code = f"""
import importlib, sys
sys.modules["jax"] = None  # any import of jax now raises
for m in {_port_modules()!r}:
    importlib.import_module(m)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
for a in ARCH_IDS:
    get_config(a), get_smoke_config(a)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ok", len({_port_modules()!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _scanned_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
        # module paths built as strings (importlib) must name the port too
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.fullmatch(r"repro(\.\w+)+\.?", node.value), f"{path}: {node.value!r}"


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_equal_reference(rel):
    port = (PORT / rel).read_text()
    assert port.replace("repro_torch", "repro") == (REF / rel).read_text()


@pytest.mark.parametrize("rel", sorted(NEAR_COPIES))
def test_near_copies_differ_from_reference_only_by_their_added_lines(rel):
    port = (PORT / rel).read_text().replace("repro_torch", "repro")
    for line in NEAR_COPIES[rel]:
        assert port.count(line) == 1, line
        port = port.replace(line, "", 1)
    assert port == (REF / rel).read_text()


def test_scans_cover_every_module_of_the_port():
    scanned = {p.relative_to(PORT).as_posix() for p in _scanned_files() if p.is_relative_to(PORT)}
    new = {"models/encdec.py", "serving/pipeline.py", "models/ssm.py", "models/hybrid.py",
           "models/xlstm.py", "optim/adamw.py", "optim/schedule.py", "train/loop.py",
           "data/pipeline.py", "checkpoint/ckpt.py", "launch/train.py"}
    assert new <= scanned
    mods = _port_modules()
    assert {"repro_torch." + m[:-3].replace("/", ".") for m in new} <= set(mods)


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.benchmark import MatmulProbe
    from repro_torch.core.cost import Pricing
    from repro_torch.core.policy import MinosPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serving.backend import ModelServingBackend
    from repro_torch.serving.engine import MinosServingEngine
    from repro_torch.serving.pipeline import build_asr_llm_pipeline
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.loop import TrainConfig, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatmulProbe()
    for arch in ("llama3.2-1b", "zamba2-1.2b", "xlstm-1.3b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServingBackend(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_asr_llm_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, iter(TokenStream(cfg.vocab, 1, 8)), TrainConfig(), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinosServingEngine(cfg, MinosPolicy(elysium_threshold=200.0), Pricing.tpu_chip_seconds(4))
    # asking for the CPU is the way to run there
    for arch in ("llama3.2-1b", "zamba2-1.2b", "xlstm-1.3b"):
        assert build_model(get_smoke_config(arch), device="cpu").device.type == "cpu"
