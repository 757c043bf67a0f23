"""The check can fail: a run whose timed path is broken underneath comes
out not correct, once for each fault a batch-1 serving cell on one chip can
have, and so does the float8 control. Run on the CPU at small sizes, with
the cell's own limit (the harness's look for a chip is skipped)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import control, harness

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 3


def _limits(workload) -> dict:
    return json.loads((BENCH / "cells" / f"{workload}.json").read_text())["limits"]


def _program_passes_control_fails(r: dict, workload: str) -> bool:
    """Every number compared within its limit for the program, and one at
    least beyond it for the control."""
    limits = _limits(workload)
    return all(r[k] <= lim for k, lim in limits.items()) and \
        any(r["control_" + k] > lim for k, lim in limits.items())


def token_altered(engine):
    """Every third token the decode loop produces is one id off."""
    import repro_torch.models.model as m

    calls = {"n": 0}
    argmax = m.greedy_token

    def altered(logits):
        tok = argmax(logits)
        calls["n"] += 1
        return (tok + 1) % logits.shape[-1] if calls["n"] % 3 == 0 else tok

    m.greedy_token = altered
    return lambda: setattr(m, "greedy_token", argmax)


def state_unchanged(engine):
    """A decode step that hands back its cache as it found it."""
    model = engine.model
    step = model.decode_step

    def frozen(params, cache, tokens):
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache = step(params, cache, tokens)
        for k, v in before.items():
            cache[k].copy_(v)
        return logits, cache

    object.__setattr__(model, "decode_step", frozen)
    return lambda: None


@pytest.mark.parametrize("fault", [token_altered, state_unchanged])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tree, workload, fault):
    torch.set_num_threads(2)
    undo = []
    res = harness.run(tree, workload, SEED, 1.0, False, device="cpu",
                      before_window=lambda e: undo.append(fault(e)), settle_s=(0.0, 0.0))
    for u in undo:
        u()
    assert {k: c["limit"] for k, c in res["check"].items() if c["limit"] is not None} \
        == _limits(workload)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_is_not_correct(deep_tree, workload):
    """On three seeds, the control fails the cell's limits where the
    program (f32 on the CPU) passes them."""
    torch.set_num_threads(2)
    for r in control.readings(deep_tree, workload, [SEED, SEED + 1, SEED + 2], 3.0,
                              device="cpu"):
        assert _program_passes_control_fails(r, workload), r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_is_not_correct_at_the_cells_size(workload):
    """The same at the cell's own size, on the card: the program (bf16)
    passes, the control fails, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for r in control.readings(BENCH.parent, workload, [SEED, SEED + 1, SEED + 2], 10.0):
        print(json.dumps({"workload": workload, **r}), flush=True)
        assert _program_passes_control_fails(r, workload), r
