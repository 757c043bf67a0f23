"""The SSD kernel (``csrc/ssd_chunk.cu``) on the card, against the plain
chunked scan (``models/ssm.py::ssd_chunked``) on the same inputs.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Inputs are made as zamba2's Mamba2 block hands them over: ``x``, ``Bm`` and
``Cm`` slices of one packed tensor (strided, as the conv's output is), ``dt``
a softplus, ``A`` the initial ``-linspace(1, 16, H)``, all values
bf16-representable. granite-4.0-h's shape (128 heads of 64, d_state 128) is
run also with ``dt`` a hundredth of that, so that the state carried from
earlier chunks reaches every row of the later ones. Both sides run in f32, and y and the final state are held
to test_torch_ssm.py's rule: max |diff| <= REL x max |want| (the two sides
sum the products in different orders; csum and the decays are the same bit
for bit). A bf16 call must give the f32 call's y rounded to bf16 and its
state, bit for bit: the kernel widens bf16 inputs exactly and computes in
f32.
"""
import _torch_cpu  # noqa: F401
import dataclasses

import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.models.ssm import ssd_chunked as plain_scan

pytestmark = pytest.mark.cuda

REL = 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _inputs(B, S, H, N, seed, dtype=torch.float32, P=None, dt_scale=1.0):
    """(x, dt, A, Bm, Cm, D) on the card; x, Bm and Cm views of one packed
    (B, S, H * P + 2 N) tensor in ``dtype`` (P = N unless given)."""
    P = P or N
    gen = torch.Generator(device="cuda").manual_seed(seed)
    packed = torch.randn(B, S, H * P + 2 * N, generator=gen, device="cuda")
    packed = packed.to(torch.bfloat16).to(dtype)
    x = packed[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = packed[..., H * P:H * P + N], packed[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    dt = dt * dt_scale
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    D = torch.randn(H, generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, D


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


CASES = {  # name: (B, S, H, N, P, chunk, with h0, dt scale)
    "zamba2_2048": (1, 2048, 64, 64, 64, 256, False, 1.0),
    "zamba2_3840": (1, 3840, 64, 64, 64, 256, False, 1.0),
    "ragged": (1, 600, 64, 64, 64, 256, False, 1.0),
    "shorter_than_chunk": (1, 100, 64, 64, 64, 256, False, 1.0),
    "batch_2": (2, 520, 8, 64, 64, 256, False, 1.0),
    "h0": (2, 300, 8, 64, 64, 256, True, 1.0),
    "d_state_16": (2, 80, 8, 16, 16, 32, True, 1.0),
    "d_state_16_ragged": (1, 45, 4, 16, 16, 32, False, 1.0),
    "granite4h_2048": (1, 2048, 128, 128, 64, 256, False, 0.01),
    "granite4h_3840": (1, 3840, 128, 128, 64, 256, False, 0.01),
    "granite4h_3840_dt1": (1, 3840, 128, 128, 64, 256, False, 1.0),
    "granite4h_ragged_h0": (2, 600, 8, 128, 64, 256, True, 0.01),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_plain_scan(case):
    B, S, H, N, P, chunk, with_h0, dt_scale = CASES[case]
    args = _inputs(B, S, H, N, seed=len(case), P=P, dt_scale=dt_scale)
    h0 = (torch.randn(B, H, N, P, generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda") if with_h0 else None)
    with torch.no_grad():
        want_y, want_h = plain_scan(*args, chunk=chunk, h0=h0)
        ops.reset_counters()
        y, h = ops.ssd_chunked(*args, chunk=chunk, h0=h0)
        y2, h2 = ops.ssd_chunked(*args, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
    assert ops.launches["ssd_chunked"] == 2 and ops.plain["ssd_chunked"] == 0
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert torch.equal(y, y2) and torch.equal(h, h2)  # no order that changes run to run
    err_y, err_h = _rel(y, want_y), _rel(h, want_h)
    print(f"{case}: y {err_y:.3e}, h {err_h:.3e} of max |want|")
    assert err_y <= REL and err_h <= REL
    # the same values in bf16: y rounded once from the f32 result, the same state
    x, dt, A, Bm, Cm, D = args
    with torch.no_grad():
        y16, h16 = ops.ssd_chunked(x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
                                   Cm.to(torch.bfloat16), D, chunk=chunk, h0=h0)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y.to(torch.bfloat16)) and torch.equal(h16, h)


def test_kernel_refuses_what_it_is_not_built_for():
    x, dt, A, Bm, Cm, D = _inputs(1, 64, 4, 32, seed=1)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=32)
    x, dt, A, Bm, Cm, D = _inputs(1, 64, 4, 16, seed=1)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_chunked(x, dt.double(), A, Bm, Cm, D, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=0)
    shifted = torch.zeros(1, 64, 4 * 16 + 1, device="cuda")[..., 1:].reshape(1, 64, 4, 16)
    with pytest.raises(ValueError, match="4-element"):
        ops.ssd_chunked(shifted, dt, A, Bm, Cm, D, chunk=32)


def test_captured_call_replays_to_the_eager_result():
    """A call captured in a CUDA graph, replayed on new inputs written into
    the captured tensors, gives the eager call's output bit for bit."""
    args = _inputs(1, 1024, 64, 64, seed=3, dtype=torch.bfloat16)
    static = [t.clone() for t in args]
    with torch.no_grad():
        ops.ssd_chunked(*static, chunk=256)  # loads the kernel outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y, h = ops.ssd_chunked(*static, chunk=256)
        fresh = _inputs(1, 1024, 64, 64, seed=4, dtype=torch.bfloat16)
        for s, t in zip(static, fresh):
            s.copy_(t)
        graph.replay()
        want_y, want_h = ops.ssd_chunked(*fresh, chunk=256)
        torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_one_zamba2_prefill_calls_the_kernel_once_a_layer():
    """zamba2-1.2b at full width and depth: one prefill launches the SSD
    kernel once in each of its 38 Mamba2 layers and calls no plain scan;
    the plain path (``use_kernels=False``) calls the plain scan as often."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("zamba2-1.2b")
    assert (cfg.ssm.d_state, cfg.ssm.head_dim or cfg.ssm.d_state) in _build.SSD_SHAPES
    m = build_model(cfg)
    params = m.init(0)
    tokens = torch.randint(0, cfg.vocab, (1, 512), device="cuda", dtype=torch.int32)
    ops.reset_counters()
    with torch.no_grad():
        m.prefill(params, {"tokens": tokens}, m.init_cache(1, 1024))
        torch.cuda.synchronize()
    assert cfg.n_layers == 38
    assert ops.launches["ssd_chunked"] == 38 and ops.plain["ssd_chunked"] == 0
    ops.reset_counters()
    plain = build_model(dataclasses.replace(cfg, n_layers=2), use_kernels=False)
    with torch.no_grad():
        plain.prefill(plain.init(0), {"tokens": tokens}, plain.init_cache(1, 1024))
    assert ops.launches["ssd_chunked"] == 0 and ops.plain["ssd_chunked"] == 2


def test_one_granite4h_prefill_calls_the_kernel_once_a_mamba2_layer():
    """granite-4.0-h-small at its published widths and its first 6 layers
    (5 Mamba2, then attention): one prefill launches the SSD kernel at d_state
    128 and heads of 64 once in each Mamba2 layer, K2 once and the MoE's
    queue positions once a layer, and calls no plain version."""
    import json
    import sys
    from pathlib import Path

    from repro_torch.models.model import build_model

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from portbench.harness import arch_config

    spec = json.loads((root / "portbench" / "configs" / "granite-4.0-h-small.json").read_text())
    cfg = arch_config(dict(spec, n_layers=6))
    assert (cfg.ssm.d_state, cfg.ssm.head_dim) in _build.SSD_SHAPES
    m = build_model(cfg)
    params = m.init(0)
    tokens = torch.randint(0, cfg.vocab, (1, 600), device="cuda", dtype=torch.int32)
    ops.reset_counters()
    with torch.no_grad():
        logits, _ = m.prefill(params, {"tokens": tokens}, m.init_cache(1, 1024))
        torch.cuda.synchronize()
    assert ops.launches == _build.counts(ssd_chunked=5, flash_attention=1, moe_positions=6)
    assert ops.plain == _build.counts()
    assert torch.isfinite(logits).all()
