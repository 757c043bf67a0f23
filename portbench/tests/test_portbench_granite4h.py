"""granite-4.0-h-small's files: the configuration at its published widths,
the two cells that this configuration and zamba2's chat traffic added, and
the three per-layer metrics of ``granite4h_docs``, each read on a context
built by hand whose answer is worked out here."""
from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from portbench import harness, roofline

ROOT = Path(__file__).resolve().parents[2]
CATALOG_KEYS = ("attention_multiplier", "embedding_multiplier", "logits_scaling",
                "residual_multiplier", "mamba_d_state", "mamba_d_head", "mamba_n_heads",
                "num_local_experts", "num_experts_per_tok", "shared_intermediate_size")

# a tiny configuration of the family: one Mamba2 layer (d_inner 16 in 4
# heads of 4, d_state 4, chunk 4) and one attention layer (2 heads of 4
# over 1 kv head), 4 experts of 2, top-1, one shared expert of 2
TINY = {"d_model": 8, "vocab": 10, "n_layers": 2, "layer_types": ["mamba", "attention"],
        "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "dtype": "bfloat16",
        "ssm": {"d_state": 4, "head_dim": 4, "expand": 2, "d_conv": 2, "chunk": 4},
        "moe": {"n_experts": 4, "top_k": 1, "n_shared": 1, "d_expert": 2}}


def _metric(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name).read


def _done(S, T, spans=()):
    return types.SimpleNamespace(req=types.SimpleNamespace(prompt=[0] * S), tokens=[0] * T,
                                 spans=list(spans))


def test_the_configuration_is_the_published_one():
    cfg = json.loads((ROOT / "portbench" / "configs" / "granite-4.0-h-small.json").read_text())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "granite-4.0-h-small")
    assert entry["reduced"] == [] == cfg["reduced"] and entry["source"] == cfg["source"]
    assert cfg["family"] == "hybrid_moe" and cfg["reference"] == "granite_hybrid"
    assert cfg["layer_types"].count("attention") == 4 and len(cfg["layer_types"]) == 40
    arch = harness.arch_config(cfg)
    assert (arch.n_layers, arch.d_model, arch.vocab, arch.head_dim) == (40, 4096, 100352, 128)
    assert (arch.ssm.d_state, arch.ssm.head_dim, arch.ssm.chunk) == (128, 64, 256)
    assert (arch.moe.n_experts, arch.moe.top_k, arch.moe.d_expert * arch.moe.n_shared) \
        == (72, 10, cfg["shared_intermediate_size"])
    for key in CATALOG_KEYS:
        assert key in cfg
    assert (arch.embedding_multiplier, arch.residual_multiplier, arch.logits_scaling) \
        == (12, 0.22, 16)


@pytest.mark.parametrize("workload,metrics", [
    ("granite4h_docs", ["engine_host_ms", "decode_step_ms", "prefill_ms_per_ktok",
                        "device_idle_share", "ssd_roofline", "serve_mfu.granite4h",
                        "decode_roofline.granite4h"]),
    ("zamba2_chat", ["engine_host_ms", "decode_step_ms", "device_idle_share"]),
])
def test_the_new_cells_load_with_their_metrics(workload, metrics):
    cell = harness.load_cell(ROOT, workload)
    assert [m["name"] for m in cell.per_layer] == metrics
    assert cell.check["sample"] >= 8 and cell.check["limits"]
    assert {m["name"] for m in cell.end_to_end} == {"req_ms_p50", "req_ms_p90",
                                                    "out_tok_per_s", "setup_s"}


def test_ssd_roofline_reads_the_least_time_over_the_kernels_time():
    """One Mamba2 layer, a prompt of 6 tokens: chunks of 4 and 2. C.B on
    10 + 3 pairs over N 4; in each of 4 heads the scores times x over P 4
    and the read-out and state at 4 N P a position: 2*4*13 + 4*(2*4*13 + 4*6*4*4)
    = 1,744 operations; x and y 6 x 16, B and C 6 x 4, in bf16, dt in f32,
    the state in f32: 480 + 96 + 256 = 832 bytes, which bound it."""
    least = 832 / roofline.PEAK_BYTES_PER_S
    spent_us = 4 * least * 1e6  # the three kernels took four times that
    profile = {"kernels": [("ssd_state_kernel<>", 0, spent_us / 2), ("ssd_pass_kernel<>", 0,
                                                                      spent_us / 4),
                           ("ssd_out_kernel<>", 0, spent_us / 4), ("flash_kernel", 0, 9.0)],
               "requests": [_done(6, 1, [("prefill", 6, 1.0), ("decode", 8, 1.0)])]}
    read = _metric("ssd_roofline")
    assert read({"config": TINY, "profile": profile, "roofline": roofline}) \
        == pytest.approx(25.0)
    assert read({"config": TINY, "profile": None, "roofline": roofline}) is None
    profile["kernels"] = profile["kernels"][-1:]
    assert read({"config": TINY, "profile": profile, "roofline": roofline}) is None


def test_serve_mfu_counts_the_useful_operations_of_the_window():
    """A token through the tiny stack: the Mamba2 layer 2*8*(32+8+4) + 2*2*24
    + 6*4*4*4 + 2*16*8 = 1,440, the attention layer's projections 2*8*4*4 +
    2*8*8 = 384, two FFNs of a router 2*8*4 and 2 experts 6*8*2*2 = 256;
    scores 4*2*4 = 32 a key. A request of 3 prompt and 2 decoded tokens: 5
    tokens, 15 keys and 3 rows of logits at 2*8*10."""
    flops = 5 * (1440 + 384 + 2 * 256) + 32 * 15 + 3 * 160
    ctx = {"config": TINY, "requests": [_done(3, 2)], "window_s": 2.0, "roofline": roofline}
    assert _metric("serve_mfu.granite4h")(ctx) == pytest.approx(
        100 * flops / 2.0 / roofline.PEAK_FLOPS["bfloat16"])


def test_decode_roofline_counts_a_top_k_step_and_the_states():
    """A step of the tiny stack reads, in bf16 unless said: the Mamba2
    layer's in-projection 8*44, conv 3*24, out-projection 16*8 and norms
    16 + 8, with A_log, D and dt_bias 3*4 in f32; its state 4*4*4 f32 and
    conv context 1*24 read and written; the attention layer's 2*8*8 +
    2*8*4 + 8; the valid and new K and V rows 2*4*(rows + 1); in each
    layer the f32 router 8*4*4 and 2 experts 3*8*2 with a norm 8; the tied
    embedding 10*8 and the final norm 8."""
    b = 2
    mamba = (8 * 44 + 3 * 24 + 16 * 8 + 16 + 8) * b + 12 * 4 + 2 * (64 * 4 + 24 * b)
    attn = (2 * 8 * 8 + 2 * 8 * 4 + 8) * b
    ffn = 8 * 4 * 4 + (3 * 8 * 2 * 2 + 8) * b
    fixed = mamba + attn + 2 * ffn + (10 * 8 + 8) * b

    def step(pos):
        return fixed + 2 * 4 * (pos + 1) * b

    least = (step(3) + step(4)) / roofline.PEAK_BYTES_PER_S
    ctx = {"config": TINY, "roofline": roofline,
           "requests": [_done(3, 1, [("prefill", 3, 5.0), ("decode", 2, least * 1e3 * 2)])]}
    assert _metric("decode_roofline.granite4h")(ctx) == pytest.approx(50.0)
    assert _metric("decode_roofline.granite4h")(dict(ctx, requests=[_done(3, 1)])) is None


def test_the_rounding_probe_holds_the_f32_program_to_the_reference():
    """``rounding_probe.py`` on a small configuration of the family on the
    CPU: the program in float32 reads the float32 reference's logits within
    1e-5 (both differ in the order of their sums only), and every variant
    is read on every served token."""
    from portbench import rounding_probe

    cfg = json.loads((ROOT / "portbench" / "configs" / "granite-4.0-h-small.json").read_text())
    d = 128
    cfg.update(n_layers=2, d_model=d, n_heads=2, n_kv_heads=1, head_dim=64, vocab=256,
               layer_types=["mamba", "attention"])
    cfg["ssm"].update(d_state=16, head_dim=8, chunk=8)
    cfg["moe"].update(n_experts=4, top_k=2, d_expert=32, n_shared=1)
    scale = {".*w_in": d ** -0.5, ".*w_out": 0.5 * (2 * d) ** -0.5,
             ".*attn\\.w[qkv]": d ** -0.5, ".*attn\\.wo": 128 ** -0.5,
             ".*mlp\\.router": 4 * d ** -0.5, ".*mlp\\.w_(gate|up)": d ** -0.5,
             ".*mlp\\.w_down": 32 ** -0.5, ".*mlp\\.shared\\.w_(gate|up)": d ** -0.5,
             ".*mlp\\.shared\\.w_down": 32 ** -0.5}
    cfg["init"] = [[p, k, scale.get(p, v)] for p, k, v in cfg["init"]]
    out = rounding_probe.probe(cfg, [5], prompts=2, new=3, device="cpu", lengths=[20])
    assert set(out) == {"program_bf16", "program_f32", *rounding_probe.STAGES}
    assert all(r["tokens"] == 6 for r in out.values())
    assert out["program_f32"]["rel_err"] < 1e-5 and out["program_f32"]["gap_mean"] == 0
    assert 0 < out["program_bf16"]["rel_err"] < 0.1
