"""The port's fleet layer against ``repro.fleet`` on the same seeds.

``repro_torch.fleet`` is a copy of ``repro.fleet`` (``test_torch_isolation.py``
checks the bytes) on the copied substrate, simulator and faults, and draws
only numpy randomness. So the ``--smoke`` settings of
``benchmarks/fleet_sweep.py`` and ``benchmarks/fault_sweep.py``, run through
both packages, must give EXACTLY the same rows, headline and, arm by arm, the
same requests: every result of every ``run_fleet_open_loop`` call, and its
router's per-fleet counters. The conservation ledger is checked on every arm
(the sweeps call ``router.check_conservation()`` on each run; the test does so
again on what it kept).

The sweeps import ``repro``; the port's run is the same source with its
imports pointed at ``repro_torch``.
"""
import _torch_cpu  # noqa: F401
import types
from pathlib import Path

import pytest

from repro.analysis import sanitizer as jsan
from repro_torch.analysis import sanitizer as tsan
from test_torch_sim import _assert_same

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = ("fault_sweep", "fleet_sweep")


def _sweep_module(name: str, package: str) -> types.ModuleType:
    """``benchmarks/<name>.py`` with its imports of ``repro`` pointed at
    ``package``."""
    src = (ROOT / "benchmarks" / f"{name}.py").read_text()
    if package != "repro":
        src = src.replace("from repro.", f"from {package}.").replace(
            "from repro import", f"from {package} import")
    mod = types.ModuleType(f"{name}_{package}")
    mod.__file__ = str(ROOT / "benchmarks" / f"{name}.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _run_smoke(name: str, package: str):
    """(rows, headline, [(router, run) of every arm]) of the sweep's smoke
    settings, through ``package``."""
    mod = _sweep_module(name, package)
    assert mod.run_fleet_open_loop.__module__ == f"{package}.fleet.router"
    kept = []
    run_fleet = mod.run_fleet_open_loop

    def keeping(router, *args, **kwargs):
        run = run_fleet(router, *args, **kwargs)
        kept.append((router, run))
        return run

    mod.run_fleet_open_loop = keeping
    rows, headline, _ = getattr(mod, name)(smoke=True, report_timing=False)
    return rows, headline, kept


def _fleet_state(router):
    return [(e.instances_started, e.instances_terminated, e.cost.total,
             e.benchmark_observations, e.warm_pool_speeds) for e in router.engines]


@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_smoke_equals_reference(name, sanitize, monkeypatch):
    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        assert jsan.enabled() and tsan.enabled()
    ref_rows, ref_head, ref_runs = _run_smoke(name, "repro")
    port_rows, port_head, port_runs = _run_smoke(name, "repro_torch")
    assert port_rows == ref_rows
    assert port_head == ref_head
    assert len(port_runs) == len(ref_runs) > 0
    for (t_router, t_run), (j_router, j_run) in zip(port_runs, ref_runs):
        assert type(t_router).__module__ == "repro_torch.fleet.router"
        _assert_same(t_run, j_run)  # request by request
        _assert_same(_fleet_state(t_router), _fleet_state(j_router))
        t_router.check_conservation()
