"""The port's CUDA kernels and the paths through them, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX, so it runs
on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs.
Tolerances: f32 2e-3 (rtol and atol; matmul atol x10, as test_kernels.py:
the two sides sum in different orders), bf16 5e-2 (8 mantissa bits). TF32
is off for the plain side, so f32 products there are IEEE f32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _rand(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.tensor(x, device="cuda").to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (256, 1024, 256), (100, 300, 77)])
def test_matmul_kernel_matches_plain(m, k, n, dtype):
    a, b = _rand((m, k), dtype, 0), _rand((k, n), dtype, 1)
    tol = TOL[dtype]
    torch.testing.assert_close(ops.matmul(a, b).float(), ref.matmul_ref(a, b).float(),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,seq,d", [
    (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (2, 4, 1, 128, 128),
    (1, 32, 8, 77, 64), (1, 8, 2, 200, 96),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(batch, qh, kvh, seq, d, causal, dtype):
    q = _rand((batch, qh, seq, d), dtype, 0)
    k, v = _rand((batch, kvh, seq, d), dtype, 1), _rand((batch, kvh, seq, d), dtype, 2)
    tol = TOL[dtype]
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=causal).float(),
                               ref.attention_ref(q, k, v, causal=causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,S,d", [
    (2, 4, 2, 512, 64), (1, 8, 8, 1024, 128), (3, 4, 1, 256, 64), (1, 32, 8, 300, 96),
])
def test_decode_kernel_matches_plain(batch, qh, kvh, S, d, dtype):
    q = _rand((batch, qh, 1, d), dtype, 0)
    k, v = _rand((batch, kvh, S, d), dtype, 1), _rand((batch, kvh, S, d), dtype, 2)
    lengths = np.random.RandomState(3).randint(1, S + 1, size=batch)
    lengths[-1] = 1  # a length-1 row: only the first block contributes
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tol = TOL[dtype]
    torch.testing.assert_close(ops.decode_attention(q, k, v, lens).float(),
                               ref.decode_attention_ref(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


def test_decode_kernel_zeros_at_length_zero():
    q = _rand((2, 4, 1, 64), "float32", 0)
    k, v = _rand((2, 2, 256, 64), "float32", 1), _rand((2, 2, 256, 64), "float32", 2)
    out = ops.decode_attention(q, k, v, torch.tensor([0, 1], dtype=torch.int32, device="cuda"))
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out[1, :, 0], v[1].repeat_interleave(2, dim=0)[:, 0])


def test_model_kernel_path_matches_plain_path():
    """A smoke-size llama (f32) on the card: the kernel path's logits and
    greedy tokens against the plain path's, on the same weights."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model

    cfg = get_smoke_config("llama3.2-1b")
    mk, mp = build_model(cfg), build_model(cfg, use_kernels=False)
    params = mk.init(0)
    tokens = torch.tensor(np.random.RandomState(1).randint(0, cfg.vocab, size=(2, 77)),
                          dtype=torch.int32, device="cuda")
    out = {}
    ops.reset_counters()
    for name, m in (("kernel", mk), ("plain", mp)):
        cache = m.init_cache(2, 96)
        logits, cache = m.prefill(params, {"tokens": tokens}, cache)
        toks, _ = m.decode_tokens(params, cache, tokens[:, -1:], 8)
        out[name] = (logits, toks)
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(out["kernel"][1], out["plain"][1])
    n = cfg.n_layers
    assert ops.launches == {"matmul": 0, "flash_attention": n, "decode_attention": 8 * n}
    assert ops.plain == {"matmul": 0, "flash_attention": n, "decode_attention": 8 * n}


def test_engine_and_probe_default_to_the_card():
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.benchmark import MatmulProbe
    from repro_torch.core.cost import Pricing
    from repro_torch.core.policy import MinosPolicy
    from repro_torch.serving.engine import MinosServingEngine, ServeRequest

    ops.reset_counters()
    probe = MatmulProbe(n=256, repeats=2)
    assert probe.run() > 0.0
    eng = MinosServingEngine(get_smoke_config("llama3.2-1b"),
                             MinosPolicy(elysium_threshold=190.0, max_retries=5),
                             Pricing.tpu_chip_seconds(1), seed=2, max_pool=2)
    assert eng.params.embed.is_cuda
    res = eng.serve([ServeRequest(prompt=np.arange(1, 70, dtype=np.int32), max_new_tokens=5,
                                  request_id=i) for i in range(3)])
    assert [r.tokens.shape for r in res] == [(5,)] * 3
    assert min(ops.launches.values()) > 0
    assert sum(ops.plain.values()) == 0
