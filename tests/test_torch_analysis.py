"""The port's static checker (``repro_torch.analysis``): ``repro.analysis``'s
engine and rules, read for CUDA-graph capture.

- each mutation fixture under ``tests/fixtures/analysis_torch/`` fires its
  rule and no other (R1 host RNG and the clock in a ``torch.cuda.graph``
  body and two local calls below a ``make_graphed_callables`` step; R2 host
  syncs in a ``capture_begin``/``capture_end`` block and the function it
  calls; R4 a capture in a loop, a capture keyed by ``data_ptr()``,
  ``torch.compile(f)(x)``; R5 state rebound in captured code);
- the clean fixtures, copies of the port's own idioms (``GraphCache``'s
  static buffers, ``_GraphScan``'s chunked capture, a cache written with
  ``copy_``), find nothing;
- R3 and R6, the reference's rules copied, give the same findings on every
  fixture of ``tests/fixtures/analysis/`` through both checkers;
- ``python -m repro_torch.analysis --ci`` is clean on the shipped tree and
  fails on a fixture and on a copy of ``models/graphs.py`` with a host sync
  in its capture; ``python -m repro.analysis --ci`` stays clean;
- fingerprints ignore line numbers, and a baseline written by
  ``--write-baseline`` grandfathers its findings and reports them stale
  once they are gone.
"""
from _torch_cpu import child_env
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.lint import analyze_file as ref_analyze_file
from repro_torch.analysis import Baseline, analyze_source
from repro_torch.analysis.lint import analyze_file

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "analysis"

BAD = {
    "bad_r1_capture_rng.py": ("R1", {"numpy.random.normal", "time.time"}),
    "bad_r1_indirect.py": ("R1", {"random.random"}),
    "bad_r2_host_sync.py": ("R2", {"int-on-tensor", "if-on-tensor", "item-on-tensor",
                                   "tolist-on-tensor", "numpy.asarray-on-tensor",
                                   "cpu-on-tensor"}),
    "bad_r4_recapture.py": ("R4", {"capture-in-loop", "per-call-key", "compile-immediate-call"}),
    "bad_r5_rebind.py": ("R5", {"rebind-attr", "rebind-item", "rebind-param"}),
}


def _findings(name: str):
    return analyze_file(str(FIXTURES / name), name)


def _cli(*args, cwd=ROOT, module="repro_torch.analysis"):
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("name", sorted(BAD))
def test_mutation_fixture_fires_its_rule_alone(name):
    rule, details = BAD[name]
    fs = _findings(name)
    assert {f.rule for f in fs} == {rule}, [f.render() for f in fs]
    got = {f.detail.split(":")[0] for f in fs}
    assert details <= got, got


def test_r1_reaches_through_local_calls_from_a_graphed_callable():
    (f,) = _findings("bad_r1_indirect.py")
    assert f.symbol == "_draw" and "called from captured _jitter" in f.message


def test_r2_covers_the_capture_begin_block_and_its_callee():
    symbols = {f.symbol for f in _findings("bad_r2_host_sync.py")}
    assert symbols == {"_body", "capture.<captured>"}


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("clean_*.py")))
def test_the_ports_idioms_stay_clean(name):
    assert _findings(name) == []


def test_the_port_captures_what_it_says():
    from repro_torch.analysis.lint import ModuleModel

    def captured(rel):
        path = ROOT / "src" / "repro_torch" / rel
        return set(ModuleModel(str(path), rel, path.read_text()).captured)

    assert captured("models/graphs.py") == {"GraphCache._capture.<captured>"}
    assert captured("sim/vectorized.py") == {"_GraphScan._capture.<captured>",
                                             "_GraphScan._body", "_advance", "_tree_copy",
                                             "_tree_map"}


@pytest.mark.parametrize("name", sorted(p.name for p in REF_FIXTURES.glob("*.py")))
def test_copied_rules_match_the_reference(name):
    def key(findings):
        return sorted((f.rule, f.path, f.line, f.symbol, f.detail, f.message) for f in findings)

    path = str(REF_FIXTURES / name)
    port = analyze_file(path, name, rules=["R3", "R6"])
    ref = ref_analyze_file(path, name, rules=["R3", "R6"])
    assert key(port) == key(ref)


def test_cli_is_clean_on_the_shipped_tree():
    out = _cli("--ci")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.analysis: clean (0 grandfathered, 0 stale)" in out.stdout
    assert json.loads((ROOT / "src" / "repro_torch" / "analysis" / "baseline.json")
                      .read_text())["findings"] == []


def test_reference_checker_stays_clean():
    out = _cli("--ci", module="repro.analysis")
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", sorted(BAD))
def test_cli_fails_on_a_mutation_fixture(name):
    out = _cli("--ci", str(FIXTURES / name))
    assert out.returncode == 1, out.stdout
    assert f"{BAD[name][0]} [" in out.stdout


def test_cli_fails_on_a_host_sync_in_the_ports_capture(tmp_path):
    src = (ROOT / "src" / "repro_torch" / "models" / "graphs.py").read_text()
    line = "                    output = body(static_inputs)\n"
    assert src.count(line) == 1
    mutated = tmp_path / "graphs.py"
    mutated.write_text(src.replace(line, line + "                    n = int(output.sum())\n"))
    out = _cli("--ci", str(mutated))
    assert out.returncode == 1
    assert "R2 [GraphCache._capture.<captured>]" in out.stdout and "int()" in out.stdout


def test_cli_usage_errors_exit_2(tmp_path):
    assert _cli("--rules", "R9").returncode == 2
    assert _cli(str(tmp_path / "missing.py")).returncode == 2


def test_fingerprints_ignore_line_numbers():
    src = (FIXTURES / "bad_r2_host_sync.py").read_text()
    a = analyze_source(src, "m.py")
    b = analyze_source("\n\n\n" + src, "m.py")
    assert [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert [f.line + 3 for f in a] == [f.line for f in b]


def test_baseline_round_trip(tmp_path):
    target = tmp_path / "mod.py"
    target.write_text((FIXTURES / "bad_r5_rebind.py").read_text())
    base = tmp_path / "baseline.json"
    assert _cli("--write-baseline", "--baseline", str(base), str(target)).returncode == 0
    loaded = Baseline.load(str(base))
    assert len(loaded.entries) == 3 and all(j.startswith("TODO justify")
                                           for j in loaded.entries.values())
    out = _cli("--ci", "--baseline", str(base), str(target))
    assert out.returncode == 0 and "clean (3 grandfathered, 0 stale)" in out.stdout
    assert _cli("--ci", "--no-baseline", "--baseline", str(base), str(target)).returncode == 1
    target.write_text((FIXTURES / "clean_cache_copy.py").read_text())
    out = _cli("--ci", "--baseline", str(base), str(target))
    assert out.returncode == 0 and out.stdout.count("# stale baseline entry") == 3
    loaded.save(str(tmp_path / "again.json"))
    assert Baseline.load(str(tmp_path / "again.json")).entries == loaded.entries


def test_json_output_lists_every_finding():
    out = _cli("--json", "--no-baseline", str(FIXTURES / "bad_r4_recapture.py"))
    rows = json.loads(out.stdout)
    assert out.returncode == 1 and {r["rule"] for r in rows} == {"R4"}
    assert {r["detail"].split(":")[0] for r in rows} == BAD["bad_r4_recapture.py"][1]
    assert len(rows) == len(_findings("bad_r4_recapture.py"))
