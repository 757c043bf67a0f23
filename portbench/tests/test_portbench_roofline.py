"""The yardstick's operation and byte counts against counts by hand, for
both configurations at their published widths."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GRANITE = json.loads((CONFIGS / "granite-moe-1b-a400m.json").read_text())
ZAMBA = json.loads((CONFIGS / "zamba2-1.2b.json").read_text())

# granite: per layer, q/k/v/o 2*1024*(16+8+8)*64 + 2*16*64*1024, experts
# 8 of 32 at 6*1024*512 each, router 2*1024*32; 24 layers
GRANITE_TOKEN = 24 * (4_194_304 + 2_097_152 + 8 * 3_145_728 + 65_536)
GRANITE_LOGITS = 2 * 1024 * 49155
# zamba2: per Mamba2 layer in_proj 2*2048*(2*4096+2*64+64), conv 2*4*4224,
# recurrence 6*64*64*64, out_proj 2*4096*2048; 38 layers; the shared block
# 2*2048*(32+64)*64 + 2*32*64*2048 + 6*2048*8192, 6 applications
ZAMBA_TOKEN = 38 * (34_340_864 + 33_792 + 1_572_864 + 16_777_216) + 6 * (
    25_165_824 + 8_388_608 + 100_663_296)
ZAMBA_LOGITS = 2 * 2048 * 32000


def test_token_counts():
    assert roofline._token_flops(GRANITE) == GRANITE_TOKEN == 756_547_584
    assert roofline._token_flops(ZAMBA) == ZAMBA_TOKEN == 2_808_846_336


@pytest.mark.parametrize("cfg,token,logits,apps,heads", [
    (GRANITE, GRANITE_TOKEN, GRANITE_LOGITS, 24, 16), (ZAMBA, ZAMBA_TOKEN, ZAMBA_LOGITS, 6, 32)])
def test_request_counts(cfg, token, logits, apps, heads):
    S, T = 3, 2
    # causal prefill: positions 0..2 attend to 1, 2, 3 rows; decode steps at
    # positions 3 and 4 attend to 4 and 5 rows
    scores = lambda rows: apps * 4 * heads * 64 * rows  # noqa: E731
    prefill = S * token + scores(1 + 2 + 3) + logits
    decode = T * (token + logits) + scores(4 + 5)
    assert roofline.prefill_flops(cfg, S) == prefill
    assert roofline.decode_flops(cfg, S, T) == decode
    assert roofline.request_flops(cfg, S, T) == prefill + decode


def test_window_limits_the_rows():
    cfg = dict(ZAMBA, sliding_window=2)
    assert roofline._keys(cfg, 0) == 1 and roofline._keys(cfg, 9) == 2
    assert roofline.request_decode_attention_bound_s(cfg, 10, 3) == \
        3 * 6 * roofline.decode_attention_bound_s(cfg, 2)


def test_decode_attention_bound_is_bytes():
    # granite at 1024 rows: q and out 2*16*64 elements, K and V 2*8*1024*64,
    # 2 bytes each; 4*16*64*1024 operations
    nbytes = (2 * 16 * 64 + 2 * 8 * 1024 * 64) * 2
    assert nbytes == 2_101_248
    assert roofline.decode_attention_bound_s(GRANITE, 1024) == pytest.approx(nbytes / 3.35e12)
    assert 4 * 16 * 64 * 1024 / 989e12 < nbytes / 3.35e12
    assert roofline.request_decode_attention_bound_s(GRANITE, 1023, 1) == \
        pytest.approx(24 * nbytes / 3.35e12)


def test_prefill_attention_bound_is_operations_at_long_prompts():
    # zamba2 at S = 2048: 4*32*64*S(S+1)/2 operations against
    # (2*32 + 2*32)*S*64*2 bytes
    S = 2048
    flops = 4 * 32 * 64 * S * (S + 1) // 2
    nbytes = (2 * 32 + 2 * 32) * S * 64 * 2
    assert roofline.prefill_attention_bound_s(ZAMBA, S) == pytest.approx(flops / 989e12)
    assert flops / 989e12 > nbytes / 3.35e12
    assert roofline.request_prefill_attention_bound_s(ZAMBA, S) == pytest.approx(
        6 * flops / 989e12)


def test_window_mfu():
    class D:
        def __init__(self, S, T):
            self.req = type("R", (), {"prompt": [0] * S})()
            self.tokens = [0] * T
    reqs = [D(3, 2), D(4, 1)]
    flops = roofline.request_flops(GRANITE, 3, 2) + roofline.request_flops(GRANITE, 4, 1)
    assert roofline.window_mfu(GRANITE, reqs, 2.0) == pytest.approx(100 * flops / 2.0 / 989e12)
