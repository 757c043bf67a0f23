"""The port's CUDA kernels and the paths through them, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX, so it runs
on a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
and called twice to show that it returns bitwise the same output.
Tolerances (rtol = atol), as in chip_smoke.py: f32 2e-3 (matmul atol x10, as
test_kernels.py: the two sides sum in different orders). bf16 flash 3.125e-2:
the kernel rounds P to bf16 before PV, as the Pallas kernel does, and the
plain version does not; its largest error on the card, 1.5625e-2, is one
bf16 ulp at |out| in [2, 4), and the tolerance is twice that. bf16 decode
2e-2. bf16 matmul 5e-2 (8 mantissa bits over a K-long sum). TF32 is off for
the plain side, so f32 products there are IEEE f32. Attention's outputs
shrink as the keys grow (about 0.2 at most over whisper's 1,500 keys), so
attention is held per output row (``_row_limits``): where a row's largest
|plain| is below the |out| the limits were set at, to two bf16 ulps at that
value (the measured worst error is one) or, in f32, to the limit times it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {
    "matmul": {"float32": 2e-3, "bfloat16": 5e-2},
    "flash_attention": {"float32": 2e-3, "bfloat16": 3.125e-2},
    "decode_attention": {"float32": 2e-3, "bfloat16": 2e-2},
}
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


def _row_limits(want, dtype, tol):
    """rtol = atol for each row (last axis) of an attention output, as
    chip_smoke.py's ``row_limits``: ``tol``, or less where the row's largest
    |want| is small. A row of zeros must match exactly."""
    top = want.float().abs().amax(-1, keepdim=True)
    if dtype == "bfloat16":
        scaled = 2 * torch.exp2(torch.floor(torch.log2(top)) - 7)
    else:
        scaled = tol * top
    return torch.clamp(scaled, max=tol)


def _assert_rows_close(got, want, dtype, tol):
    lim = _row_limits(want, dtype, tol)
    diff = (got.float() - want.float()).abs()
    over = diff > lim + lim * want.float().abs()
    assert not over.any(), (
        f"{int(over.sum())} of {over.numel()} elements outside the per-row limit; "
        f"max |diff| {diff.max().item():.3e}, at most {lim.max().item():.3e} a row")


def _rand(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.tensor(x, device="cuda").to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [
    (512, 512, 512), (256, 1024, 256),
    (100, 300, 77),   # B's rows 308 bytes: 4-byte copies for B
    (1, 512, 512),    # one row of A
    (512, 1, 512),    # K = 1: A's rows 4 bytes
])
def test_matmul_kernel_matches_plain(m, k, n, dtype):
    a, b = _rand((m, k), dtype, 0), _rand((k, n), dtype, 1)
    tol = TOL["matmul"][dtype]
    out = ops.matmul(a, b)
    torch.testing.assert_close(out.float(), ref.matmul_ref(a, b).float(), rtol=tol, atol=tol * 10)
    assert torch.equal(ops.matmul(a, b), out)


# (batch, q_heads, kv_heads, q_seq, kv_seq, d)
FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 256, 256, 64), (2, 4, 1, 128, 128, 128),
    (1, 32, 8, 77, 77, 64), (1, 8, 2, 200, 200, 96),
    # the edges of the bf16 body: one row, a partial tile, one tile, one
    # past it, the longest serving prompt; GQA 32:8 and 4:1 at batch 2
    *[(batch, qh, kvh, s, s, d)
      for batch, qh, kvh in ((1, 32, 8), (2, 8, 2))
      for s in (1, 15, 64, 65, 250)
      for d in (64, 96, 128)],
    # fewer queries than keys: the causal mask is end-aligned
    (1, 32, 8, 65, 250, 64), (2, 8, 2, 1, 200, 128), (1, 8, 2, 100, 129, 96),
    # whisper-small: the encoder over 1,500 frames (23 full tiles and a
    # 28-row tail), and a decoder's queries over them
    (1, 12, 12, 1500, 1500, 64), (1, 12, 12, 9, 1500, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,q_seq,kv_seq,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(batch, qh, kvh, q_seq, kv_seq, d, causal, dtype):
    q = _rand((batch, qh, q_seq, d), dtype, 0)
    k, v = _rand((batch, kvh, kv_seq, d), dtype, 1), _rand((batch, kvh, kv_seq, d), dtype, 2)
    out = ops.flash_attention(q, k, v, causal=causal)
    _assert_rows_close(out, ref.attention_ref(q, k, v, causal=causal), dtype,
                       TOL["flash_attention"][dtype])
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), out)


# (batch, q_heads, kv_heads, q_seq, kv_seq, d): GQA group 1 and 4, ragged
# tails, fewer queries than keys, and zamba2's shared attention (32/32 heads)
WINDOW_SHAPES = [
    (1, 8, 8, 200, 200, 64), (2, 8, 2, 130, 130, 128), (1, 32, 8, 77, 250, 64),
    (1, 4, 4, 65, 65, 96), (1, 32, 32, 250, 250, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,q_seq,kv_seq,d", WINDOW_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 37, 64, 100, 4096])
def test_flash_kernel_window_matches_plain(batch, qh, kvh, q_seq, kv_seq, d, causal, window,
                                           dtype):
    """The sliding window: below the sequence, a multiple of the 64-key tile
    and not, 1 (each row its own key), and past the sequence (vacuous:
    zamba2's 4096 at served prompts, which must equal the unwindowed call)."""
    q = _rand((batch, qh, q_seq, d), dtype, 3)
    k, v = _rand((batch, kvh, kv_seq, d), dtype, 4), _rand((batch, kvh, kv_seq, d), dtype, 5)
    ops.reset_counters()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launches["flash_attention"] == 1 and ops.plain["flash_attention"] == 0
    _assert_rows_close(out, ref.attention_ref(q, k, v, causal=causal, window=window), dtype,
                       TOL["flash_attention"][dtype])
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), out)
    if window >= kv_seq + max(q_seq - kv_seq, 0):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal), out)
    ops.reset_counters()


def test_flash_kernel_refuses_a_window_below_one():
    q = _rand((1, 4, 64, 64), "bfloat16", 6)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)


# (batch, q_heads, kv_heads, S, d, lengths); lengths None: random in [1, S], the last 1
DECODE_CASES = [
    (2, 4, 2, 512, 64, None), (1, 8, 8, 1024, 128, None), (3, 4, 1, 256, 64, None),
    (1, 32, 8, 300, 96, None),
    (1, 16, 1, 2048, 128, None),          # group 16
    (1, 32, 8, 4096, 64, [4000]),         # a long prefix: several tiles a split
    (2, 32, 8, 512, 64, [3, 20]),         # fewer keys than splits: most splits empty
    (4, 8, 2, 300, 64, [300, 17, 1, 150]),  # per-batch lengths that differ
    (1, 12, 12, 1500, 64, [1500]),        # whisper's cross cache: 6 empty splits
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,S,d,lengths", DECODE_CASES)
def test_decode_kernel_matches_plain(batch, qh, kvh, S, d, lengths, dtype):
    q = _rand((batch, qh, 1, d), dtype, 0)
    k, v = _rand((batch, kvh, S, d), dtype, 1), _rand((batch, kvh, S, d), dtype, 2)
    if lengths is None:
        lengths = np.random.RandomState(3).randint(1, S + 1, size=batch)
        lengths[-1] = 1  # a length-1 row: only the first block contributes
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = ops.decode_attention(q, k, v, lens)
    _assert_rows_close(out, ref.decode_attention_ref(q, k, v, lens), dtype,
                       TOL["decode_attention"][dtype])
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)


def test_decode_kernel_in_cuda_graph_reads_lengths_on_device():
    """One captured launch, replayed with lengths changed in place: the split
    plan is read on the device, and the tickets are reset by every call."""
    q = _rand((2, 32, 1, 64), "bfloat16", 0)
    k, v = _rand((2, 8, 512, 64), "bfloat16", 1), _rand((2, 8, 512, 64), "bfloat16", 2)
    lens = torch.tensor([266, 5], dtype=torch.int32, device="cuda")
    ops.decode_attention(q, k, v, lens)  # builds the kernel and zeroes the tickets
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, lens)
    tol = TOL["decode_attention"]["bfloat16"]
    for lengths in ([266, 5], [1, 512], [17, 300], [0, 100], [512, 1], [266, 5]):
        lens.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, lens).float()
        for b, length in enumerate(lengths):
            if length == 0:
                assert torch.all(out[b] == 0)
            else:
                torch.testing.assert_close(out[b].float(), want[b], rtol=tol, atol=tol)
        assert torch.equal(out, ops.decode_attention(q, k, v, lens))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,qh,kvh,S,d,lengths", DECODE_CASES + [(2, 32, 8, 128, 64, [0, 77])])
def test_decode_kernel_lse_form_matches_plain(batch, qh, kvh, S, d, lengths, dtype):
    """K3's log-sum-exp form: the same output as without it, and each head's
    log-sum-exp within 1e-4 of the plain version's (f32 on both sides; -inf
    at length 0); launches counted as ``decode_attention_lse``."""
    q = _rand((batch, qh, 1, d), dtype, 0)
    k, v = _rand((batch, kvh, S, d), dtype, 1), _rand((batch, kvh, S, d), dtype, 2)
    if lengths is None:
        lengths = np.random.RandomState(3).randint(1, S + 1, size=batch)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ops.reset_counters()
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    assert ops.form_launches["decode_attention_lse"] == 1 and ops.launches["decode_attention"] == 0
    assert torch.equal(out, ops.decode_attention(q, k, v, lens))
    _, want = ref.decode_attention_ref(q, k, v, lens, return_lse=True)
    empty = lens == 0
    assert torch.all(lse[empty] == float("-inf"))
    torch.testing.assert_close(lse[~empty], want[~empty], rtol=1e-4, atol=1e-4)


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
    assert ops.launches == ops.counts(flash_attention=n, decode_attention=8 * n)
    assert ops.plain == ops.counts(flash_attention=n, decode_attention=8 * n)


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
    assert min(ops.launches[k] for k in ("matmul", "flash_attention", "decode_attention")) > 0
    assert ops.launches["ssd_chunked"] == 0  # llama has no SSD
    assert sum(ops.plain.values()) == 0


def test_probe_run_is_host_time_at_least_the_device_time():
    """``MatmulProbe.run()`` is the host clock around the launches and a
    device synchronize, so it holds the device time of the same work (CUDA
    events around the same launches) and the launch and sync cost besides."""
    from repro_torch.core.benchmark import MatmulProbe

    probe = MatmulProbe(n=512, repeats=8)
    probe.run()  # builds and loads the kernel
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    compute = probe._compute

    def timed():
        start.record()
        out = compute()
        end.record()
        return out

    probe._compute = timed
    for _ in range(3):
        host = probe.run()
        end.synchronize()
        device = start.elapsed_time(end)
        print(f"probe run() {host:.4f} ms host, {device:.4f} ms between CUDA events")
        assert host >= device > 0.0


def test_flash_kernel_refuses_misaligned_bf16():
    """The bf16 body copies 16-byte rows; a view that starts mid-row is refused."""
    q = _rand((1, 2, 65, 64), "bfloat16", 0).flatten()[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, q, q)
