"""The frozen references against the program's CPU path at small sizes:
the prompt's last logits from ``prefill`` and each decode step's logits
along the served tokens equal the reference's full forward over the served
sequence, to float32 rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import granite, zamba2
from portbench.reference.common import Precision, served_sequence

from .conftest import smoke_config

CASES = [("granite-moe-1b-a400m", granite, None, 40), ("zamba2-1.2b", zamba2, None, 40),
         ("zamba2-1.2b", zamba2, 16, 40), ("granite-moe-1b-a400m", granite, None, 72)]


def _served(name, window, S, T, seed):
    from repro_torch.models.model import build_model

    cfg = smoke_config(name)
    if window is not None:
        cfg["sliding_window"] = window
    model = build_model(harness.arch_config(cfg), device="cpu")
    params = model.init(0)
    specs = weights.write(params, cfg["init"], seed)
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg["vocab"], S), dtype=torch.int32)[None]
    cache = model.init_cache(1, S + T + 1)
    first, cache = model.prefill(params, {"tokens": prompt}, cache)
    tok, served, steps = prompt[:, -1:], [], []
    for _ in range(T):
        lg, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        served.append(int(tok[0, 0]))
        steps.append(lg[0, 0])
    W = weights.make(specs, cfg["init"], seed, "cpu")
    return cfg, W, prompt[0], torch.tensor(served), first[0, 0], torch.stack(steps)


@pytest.mark.parametrize("name,ref,window,S", CASES)
def test_reference_equals_the_served_path(name, ref, window, S):
    torch.manual_seed(0)
    cfg, W, prompt, served, first, steps = _served(name, window, S, 6, seed=3)
    lg = ref.logits(cfg, W, served_sequence(prompt, served), S)
    scale = float(lg.abs().max())
    torch.testing.assert_close(lg[S - 1], first, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(lg[S:S + 6], steps, rtol=0, atol=1e-4 * scale)
    assert torch.equal(lg[S:S + 6].argmax(-1), served)


def test_granite_capacity_rule_decides_the_logits(monkeypatch):
    """At 72 prompt tokens the small granite's expert queues overflow: the
    reference without the capacity rule misses the program's prefill
    logits, with it (the case above) it meets them."""
    cfg, W, prompt, served, first, _ = _served("granite-moe-1b-a400m", None, 72, 2, seed=3)
    monkeypatch.setattr(granite, "_capacity", lambda *a: 10**9)
    lg = granite.logits(cfg, W, served_sequence(prompt, served), 72)
    assert float((lg[71] - first).abs().max()) > 1e-2 * float(lg.abs().max())


def test_fp8_control_differs_from_f32():
    a = torch.randn(8, 64)
    w = torch.randn(64, 32)
    f32, fp8 = Precision().mm(a, w), Precision("fp8").mm(a, w)
    err = float((fp8 - f32).abs().max() / f32.abs().max())
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        Precision("int4")
