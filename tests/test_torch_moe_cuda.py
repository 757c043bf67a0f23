"""The MoE's queue-position kernel (``csrc/moe_positions.cu``) on the card,
against its plain cumsum form (``kernels/ref.py::moe_positions_ref``) on the
same indices.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Indices are drawn on the card as the router gives them: the top K of
uniform draws, K distinct experts a token. The positions are integer counts,
exact in the plain form's f32 below 2**24 pairs, so the kernel must give them
bit for bit (``torch.equal``), and so must the dispatch and combine masks
that ``dispatch_combine`` builds from them.
"""
import _torch_cpu  # noqa: F401
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.moe_positions import CHUNK, MAX_EXPERTS
from repro_torch.models import moe

pytestmark = pytest.mark.cuda

# (B, S, E, K): granite-4.0-h-small's router at a decode step and at its docs
# prompts, granite-moe-1b-a400m's at a decode step and at its longest chat
# prompt, deepseek-moe-16b's, the smoke configs', the most experts the kernel
# takes, and three rows
SHAPES = [(1, 1, 72, 10), (1, 2048, 72, 10), (1, 3840, 72, 10), (1, 1, 32, 8), (1, 896, 32, 8),
          (1, 700, 64, 6), (2, 45, 4, 2), (1, 300, 256, 8), (3, 1000, 72, 10)]
# S * K not a multiple of the chunk: just over one chunk, under a warp, and
# nine whole chunks and 784 pairs
RAGGED = [(1, 103, 72, 10), (2, 7, 8, 3), (1, 1000, 72, 10)]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    ops.reset_counters()
    yield
    ops.reset_counters()


def _routes(B, S, E, K, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(B, S, E, generator=gen, device="cuda").topk(K, dim=-1).indices


def _held(idx, E):
    """The kernel's positions, held to the plain form's bit for bit."""
    got = ops.moe_positions(idx, E)
    want = ref.moe_positions_ref(idx, E)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("B,S,E,K", SHAPES + RAGGED)
def test_positions_equal_the_cumsum_form(B, S, E, K):
    _held(_routes(B, S, E, K, S * E + K), E)
    assert ops.launches == _build.counts(moe_positions=1)
    assert ops.plain == _build.counts()


def test_rows_are_routed_as_each_would_be_alone():
    idx = _routes(3, 1000, 72, 10, 5)
    pos = _held(idx, 72)
    for b in range(3):
        assert torch.equal(pos[b:b + 1], ops.moe_positions(idx[b:b + 1].clone(), 72))


@pytest.mark.parametrize("S", [1, 3840])
def test_every_pair_on_one_expert_queues_them_all_in_order(S):
    """The longest queue: every pair on expert 5, so its positions are
    0 .. S·K - 1 in (s, k) order and the pairs past the capacity drop."""
    E, K = 72, 10
    idx = torch.full((1, S, K), 5, dtype=torch.int64, device="cuda")
    pos = _held(idx, E)
    assert torch.equal(pos.flatten(), torch.arange(S * K, dtype=torch.int32, device="cuda"))
    C = moe._capacity(S, K, E, 1.25)
    assert int((pos >= C).sum()) == max(S * K - C, 0)


def test_indices_outside_the_experts_get_zero_and_count_nowhere():
    idx = _routes(1, 300, 72, 10, 8)
    idx[0, ::7, 3] = -1
    idx[0, ::5, 0] = 72
    _held(idx, 72)


def test_the_kernel_refuses_what_it_cannot_take():
    idx = _routes(1, 4, 8, 2, 1)
    with pytest.raises(ValueError, match="experts"):
        ops.moe_positions(idx, MAX_EXPERTS + 1)
    with pytest.raises(TypeError, match="int64"):
        ops.moe_positions(idx.to(torch.int32), 8)
    with pytest.raises(ValueError, match=r"\(B, S, K\)"):
        ops.moe_positions(idx[0], 8)
    assert ops.launches == _build.counts()


def test_a_captured_call_replays_on_new_indices_and_counts_each_replay():
    B, S, E, K = 1, 2048, 72, 10
    idx = _routes(B, S, E, K, 1).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.moe_positions(idx, E)  # loads the kernel before the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    ops.reset_counters()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as recorded, torch.cuda.graph(graph):
        out = ops.moe_positions(idx, E)
    assert recorded["launches"] == _build.counts(moe_positions=1)
    assert ops.launches == _build.counts()
    for seed in (2, 3, 4):
        idx.copy_(_routes(B, S, E, K, seed))
        graph.replay()
        _build.replayed(recorded)
        torch.cuda.synchronize()
        assert torch.equal(out, ref.moe_positions_ref(idx, E))
    assert ops.launches == _build.counts(moe_positions=3)
    assert ops.plain == _build.counts()


@pytest.mark.parametrize("S,E,K", [(1, 72, 10), (2048, 72, 10), (3840, 72, 10), (1, 32, 8),
                                   (896, 32, 8), (103, 72, 10)])
def test_dispatch_and_combine_equal_the_plain_paths(S, E, K):
    m = MoEConfig(n_experts=E, top_k=K)
    gen = torch.Generator(device="cuda").manual_seed(S + E)
    probs = torch.softmax(torch.randn(1, S, E, generator=gen, device="cuda") * 3, dim=-1)
    with torch.no_grad():
        got = moe.dispatch_combine(m, probs)
        with ops.plain_path():
            want = moe.dispatch_combine(m, probs)
    assert ops.launches == _build.counts(moe_positions=1)
    assert ops.plain == _build.counts(moe_positions=1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_under_autograd_the_kernel_runs_and_the_gate_gradient_is_the_plain_paths():
    m = MoEConfig(n_experts=72, top_k=10)
    gen = torch.Generator(device="cuda").manual_seed(11)
    logits = torch.randn(1, 600, 72, generator=gen, device="cuda")
    grads = []
    for plain in (False, True):
        x = logits.clone().requires_grad_(True)
        with ops.plain_path(plain):
            _, combine = moe.dispatch_combine(m, torch.softmax(x, dim=-1))
        (combine * torch.arange(combine.shape[-1], device="cuda")).sum().backward()
        grads.append(x.grad)
    assert ops.launches == _build.counts(moe_positions=1)
    assert ops.plain == _build.counts(moe_positions=1)
    assert torch.equal(grads[0], grads[1])


def test_a_granite_prefill_and_decode_call_it_once_a_layer():
    """The smoke granite-moe-1b-a400m on the card: one kernel call a layer in
    the prefill and in each decode step, none with ``use_kernels=False``."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"), dtype="bfloat16")
    L, T = cfg.n_layers, 4
    prompt = torch.randint(0, cfg.vocab, (1, 40), dtype=torch.int32, device="cuda")
    for use_kernels in (True, False):
        m = build_model(cfg, use_kernels=use_kernels)
        params = m.init(0)
        ops.reset_counters()
        cache = m.init_cache(1, 64)
        m.prefill(params, {"tokens": prompt}, cache)
        m.decode_tokens(params, cache, prompt[:, -1:], T)
        torch.cuda.synchronize()
        calls = (ops.launches if use_kernels else ops.plain)["moe_positions"]
        assert calls == L * (1 + T)
        assert (ops.plain if use_kernels else ops.launches)["moe_positions"] == 0
