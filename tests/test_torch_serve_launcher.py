"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against ``repro.launch.serve``: under the same arguments, with
``--device cpu`` on the port's side, both print the same summary line
(replicas started and terminated, pool speed, mean latency, cost). The gate
is simulated and draws the same numpy numbers, so the lines are equal."""
import _torch_cpu  # noqa: F401
import sys

import pytest

from repro.launch import serve as ref_serve
from repro_torch.launch import serve as port_serve

ARGVS = [
    [],                                                   # the defaults: qwen3-0.6b, 16 requests
    ["--arch", "granite-moe-1b-a400m", "--requests", "5", "--max-new-tokens", "4",
     "--pass-fraction", "0.2", "--speed-sigma", "0.3", "--no-minos"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_summary_line_equals_reference(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    port_serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert want.startswith("served ")
    assert got == want
