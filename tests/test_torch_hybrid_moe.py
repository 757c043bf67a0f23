"""The ``hybrid_moe`` family (granite-4.0-h: Mamba2 and NoPE attention
layers, each followed by an MoE FFN with a shared expert) against the
benchmark's plain float32 reference, ``portbench/reference/granite_hybrid.py``,
on the same seeded weights, at a small size on the CPU: d_model 256, four
layers ``mamba, attention, mamba, mamba``, d_state 32 with heads of 16 (so
N != P), 8 experts top-2 with a shared expert, and the published
multipliers (none of them 1). The family has no counterpart in ``repro``, so
the reference is the benchmark's.

Prefill and then decode through the cache must give the reference's full
forward over the served sequence within 1e-5 of the largest logit: both
sides compute in float32 and differ in the order of their sums only (the
dense expert dispatch against one product per expert, the chunked scan
against the reference's); the readings are about 3e-7.
"""
import _torch_cpu  # noqa: F401
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, weights  # noqa: E402
from portbench.reference import granite_hybrid, zamba2  # noqa: E402
from portbench.reference.common import served_sequence  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import hybrid_moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "granite-4.0-h-small.json"
REL = 1e-5


def small_config(**over) -> dict:
    """The benchmark's configuration file at a small size, its init scales
    worked out for it as the file's are for the published widths."""
    cfg = json.loads(CONFIG.read_text())
    d = 256
    cfg.update(n_layers=4, d_model=d, n_heads=4, n_kv_heads=2, head_dim=64, vocab=512,
               dtype="float32", layer_types=["mamba", "attention", "mamba", "mamba"])
    cfg["ssm"].update(d_state=32, head_dim=16, chunk=16)
    cfg["moe"].update(n_experts=8, top_k=2, d_expert=64, n_shared=1)
    scale = {".*w_in": d ** -0.5, ".*w_out": 0.5 * (2 * d) ** -0.5,
             ".*attn\\.w[qkv]": d ** -0.5, ".*attn\\.wo": 256 ** -0.5,
             ".*mlp\\.router": 4 * d ** -0.5, ".*mlp\\.w_(gate|up)": d ** -0.5,
             ".*mlp\\.w_down": 64 ** -0.5, ".*mlp\\.shared\\.w_(gate|up)": d ** -0.5,
             ".*mlp\\.shared\\.w_down": 64 ** -0.5}
    cfg["init"] = [[p, k, scale.get(p, v)] for p, k, v in cfg["init"]]
    cfg.update(over)
    return cfg


def _served(cfg: dict, S: int, T: int, seed: int):
    """The port's prefill logits and T decode steps' logits along its own
    greedy tokens, and the weights drawn again for the reference."""
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
    return model, params, W, prompt[0], torch.tensor(served), first[0, 0], torch.stack(steps)


@pytest.mark.parametrize("case", ["published", "whole_chunks"])
def test_prefill_then_decode_matches_the_reference(case):
    """Three chunks of the scan, the last ragged, expert queues that overflow
    in the prefill (40 tokens x 2 choices over 8 experts of capacity 12),
    NoPE attention at scale 1/128; and once with a prompt of three whole
    chunks (48 tokens, capacity 15)."""
    torch.manual_seed(0)
    cfg = small_config()
    S, T = (40, 6) if case == "published" else (48, 5)
    _, _, W, prompt, served, first, steps = _served(cfg, S, T, seed=3)
    lg = granite_hybrid.logits(cfg, W, served_sequence(prompt, served), S)
    scale = float(lg.abs().max())
    torch.testing.assert_close(lg[S - 1], first, rtol=0, atol=REL * scale)
    torch.testing.assert_close(lg[S:S + T], steps, rtol=0, atol=REL * scale)
    assert torch.equal(lg[S:S + T].argmax(-1), served)


def test_every_multiplier_and_the_attention_reach_the_logits():
    """Each multiplier and the attention layer's softmax scale change the
    logits: none is dropped on the way (the reference above holds them to
    their published values)."""
    cfg = small_config()
    S = 24
    _, _, W, prompt, served, first, _ = _served(cfg, S, 1, seed=4)
    base = granite_hybrid.logits(cfg, W, prompt, S)[S - 1]
    torch.testing.assert_close(base, first, rtol=0, atol=REL * float(base.abs().max()))
    for key, value in (("embedding_multiplier", 1.0), ("residual_multiplier", 1.0),
                       ("attention_multiplier", 0.0), ("logits_scaling", 1.0)):
        other = granite_hybrid.logits(dict(cfg, **{key: value}), W, prompt, S)[S - 1]
        assert float((other - base).abs().max()) > 1e-3 * float(base.abs().max()), key


def test_forward_equals_prefill_and_the_cache_follows_the_layer_types():
    cfg = small_config()
    model, params, _, prompt, _, first, _ = _served(cfg, 20, 1, seed=5)
    logits, aux = model.forward(params, {"tokens": prompt[None]})
    torch.testing.assert_close(logits[0, -1], first, rtol=0, atol=1e-5)
    assert float(aux) > 0  # the routers' load-balance and z-loss terms
    cache = model.init_cache(2, 64)
    assert tuple(cache["h"].shape) == (3, 2, 32, 32, 16)  # 3 Mamba2 layers, H 32, N 32, P 16
    assert tuple(cache["conv"].shape) == (3, 2, 3, 512 + 64)
    assert tuple(cache["attn_k"].shape) == (1, 2, 2, 64, 64)
    kinds = [type(m).__name__ for m in params.layers[1].children()]
    assert kinds == ["Attention", "MoE"] and params.layers[0].kind == "mamba"
    assert params.layers[0].mlp.shared is not None
    with pytest.raises(ValueError, match="layer_types"):
        hybrid_moe.layer_kinds(harness.arch_config(small_config(layer_types=["mamba", "mlp"])))


def test_plain_scan_with_a_head_narrower_than_the_state_matches_the_reference():
    """``ops.ssd_chunked`` on the CPU (the plain scan) at d_state 32 and
    heads of 16, a ragged last chunk, against the reference's scan."""
    gen = torch.Generator().manual_seed(9)
    S, H, P, N = 45, 4, 16, 32
    x = torch.randn(1, S, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(1, S, H, generator=gen))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = torch.randn(1, S, N, generator=gen), torch.randn(1, S, N, generator=gen)
    D = torch.randn(H, generator=gen)
    ops.reset_counters()
    y, h = ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=16)
    assert ops.plain["ssd_chunked"] == 1 and tuple(h.shape) == (1, H, N, P)
    want = zamba2.ssd(x[0], dt[0], A, Bm[0], Cm[0], D, 16)
    torch.testing.assert_close(y[0], want, rtol=0, atol=REL * float(want.abs().max()))
    ops.reset_counters()


def test_the_published_configuration_builds_the_published_shapes():
    """The benchmark's file at its published widths, on the meta device:
    36 Mamba2 and 4 attention layers, 128 heads of 64 over d_state 128, 72
    experts of 768 and a shared SwiGLU of 1536 in every layer, tied logits;
    32.2 billion parameters."""
    cfg = harness.arch_config(json.loads(CONFIG.read_text()))
    params = hybrid_moe.GraniteHybrid(cfg, torch.device("meta"))
    kinds = hybrid_moe.layer_kinds(cfg)
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [5, 15, 25, 35]
    m, a = params.layers[0], params.layers[5]
    assert tuple(m.mamba.w_in.shape) == (4096, 2 * 8192 + 2 * 128 + 128)
    assert tuple(m.mamba.A_log.shape) == (128,)
    assert tuple(a.attn.wq.shape) == (4096, 32, 128) and tuple(a.attn.wk.shape) == (4096, 8, 128)
    assert tuple(m.mlp.w_gate.shape) == (72, 4096, 768)
    assert tuple(m.mlp.shared.w_gate.shape) == (4096, 1536)
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() and 32.1e9 < n < 32.3e9
    assert cfg.attention_multiplier == 0.0078125
    assert json.loads(CONFIG.read_text())["position_embedding_type"] == "nope"


@pytest.mark.parametrize("use_kernels", [True, False])
def test_use_kernel_reaches_the_router_in_forward_prefill_and_decode(monkeypatch, use_kernels):
    """As ``test_torch_moe.py``'s test of the same name, for the family's
    own layer loop: one queue-position call a layer a forward and a prefill,
    one call of the decode step's experts a layer a decode step, to the
    kernels or to the plain versions as ``use_kernels`` says."""
    from test_torch_moe import _launched_as_on_card, served_calls

    _launched_as_on_card(monkeypatch)
    cfg = harness.arch_config(small_config())
    m = build_model(cfg, device="cpu", use_kernels=use_kernels)
    calls = (cfg.n_layers * 2, cfg.n_layers * 3)
    assert served_calls(m, m.init(0)) == ((calls, (0, 0)) if use_kernels else ((0, 0), calls))
