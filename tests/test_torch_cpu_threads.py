"""``tests/_torch_cpu.py``: one torch thread pool per CPU share under xdist."""
import _torch_cpu
import pytest
import torch


@pytest.fixture
def threads():
    """Gives torch back the threads it had before the test."""
    before = torch.get_num_threads()
    yield before
    torch.set_num_threads(before)


def test_six_workers_on_eight_cpus_get_one_thread_each(monkeypatch, threads):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    monkeypatch.setattr(_torch_cpu.os, "cpu_count", lambda: 8)
    assert _torch_cpu.apply() == 1
    assert torch.get_num_threads() == 1
    env = _torch_cpu.child_env(PYTHONPATH="src")
    assert env["OMP_NUM_THREADS"] == "1" and env["PYTHONPATH"] == "src"
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
    assert _torch_cpu.apply() == 4 and torch.get_num_threads() == 4
    assert _torch_cpu.child_env()["OMP_NUM_THREADS"] == "4"


def test_outside_xdist_nothing_changes(monkeypatch, threads):
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    torch.set_num_threads(2)
    assert _torch_cpu.apply() is None
    assert torch.get_num_threads() == 2
    assert _torch_cpu.child_env()["OMP_NUM_THREADS"] == "3"
    monkeypatch.delenv("OMP_NUM_THREADS")
    assert "OMP_NUM_THREADS" not in _torch_cpu.child_env()
