"""The MoE's kernels on the card: the queue positions
(``csrc/moe_positions.cu``) against their plain cumsum form
(``kernels/ref.py::moe_positions_ref``) on the same indices, and the decode
step's experts (``csrc/moe_decode.cu``) against the dense dispatch
(``kernels/ref.py::moe_experts_ref``) on the same tensors.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Indices are drawn on the card as the router gives them: the top K of
uniform draws, K distinct experts a token. The positions are integer counts,
exact in the plain form's f32 below 2**24 pairs, so the kernel must give them
bit for bit (``torch.equal``), and so must the dispatch and combine masks
that ``dispatch_combine`` builds from them.

The decode kernel sums in another order than the dense dispatch and rounds
less: the dense path rounds h, u, silu(h), each expert's output and the gate
values to bf16, the kernel only the activation and the result. So in bf16
each is held to the dense dispatch in f32 on the same (bf16) tensors: the
kernel may be no farther from it than the dense bf16 path is. In f32 the two
differ in summation order only: 1e-5 of the largest output.
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
    """The smoke granite-moe-1b-a400m on the card: one queue-position call a
    layer in the prefill; a decode step's MoE goes to the decode kernel, once
    a layer, and computes no positions. With ``use_kernels=False`` the plain
    versions are called instead."""
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
        if use_kernels:
            assert ops.launches == _build.counts(flash_attention=L, decode_attention=L * T,
                                                 moe_positions=L, moe_decode=L * T)
            assert ops.plain == _build.counts()
        else:
            assert ops.plain == _build.counts(flash_attention=L, decode_attention=L * T,
                                              moe_positions=L, moe_decode=L * T)
            assert ops.launches == _build.counts()


# ---------------------------------------------------------------------------
# the decode step's experts: csrc/moe_decode.cu against the dense dispatch
# ---------------------------------------------------------------------------

# (E, K, d, d_e): granite-moe-1b-a400m's and granite-4.0-h-small's experts
GRANITE, GRANITE4H = (32, 8, 1024, 512), (72, 10, 4096, 768)


def _experts(E, d, d_e, dtype, seed):
    """w_gate, w_up (E, d, d_e) and w_down (E, d_e, d) at ``init_moe``'s
    scales, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, scale):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    return (w(E, d, d_e, scale=d ** -0.5), w(E, d, d_e, scale=d ** -0.5),
            w(E, d_e, d, scale=d_e ** -0.5))


def _decode_inputs(B, E, K, d, dtype, seed):
    """x (B, 1, d) and the router's choices, as ``moe.gates`` gives them
    from a softmax over E experts."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, 1, d, generator=gen, device="cuda").to(dtype)
    probs = torch.softmax(torch.randn(B, 1, E, generator=gen, device="cuda") * 2, dim=-1)
    vals, idx = moe.gates(MoEConfig(n_experts=E, top_k=K), probs)
    return x, idx, vals


def _dense(x, idx, vals, ws, dtype=None):
    """The dense dispatch at the decode capacity (4 slots, or K where K
    pairs may share an expert), in ``dtype`` (x's by default)."""
    dtype = dtype or x.dtype
    C = max(4, idx.shape[-1])
    return ref.moe_experts_ref(x.to(dtype), idx, vals, *(w.to(dtype) for w in ws), C)


def _decode_held(x, idx, vals, ws):
    """The kernel's output, held to the dense dispatch as the module
    docstring says; returns it."""
    with torch.no_grad():
        got = ops.moe_decode(x, idx, vals, *ws, capacity=4)
        want32 = _dense(x, idx, vals, ws, torch.float32)
        assert got.dtype == x.dtype and got.shape == x.shape
        if x.dtype == torch.float32:
            err = (got - want32).abs().max().item()
            assert err <= 1e-5 * want32.abs().max().item(), err
        else:
            dense = _dense(x, idx, vals, ws)
            err = (got.float() - want32).abs().max().item()
            dense_err = (dense.float() - want32).abs().max().item()
            assert err <= dense_err, (err, dense_err)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("E,K,d,d_e", [GRANITE, GRANITE4H], ids=["granite", "granite4h"])
def test_decode_kernel_equals_the_dense_dispatch(E, K, d, d_e, B, dtype):
    ws = _experts(E, d, d_e, dtype, E + d)
    _decode_held(*_decode_inputs(B, E, K, d, dtype, B), ws)
    assert ops.launches == _build.counts(moe_decode=1)
    assert ops.plain == _build.counts()


def test_rows_that_choose_the_same_experts():
    """Eight rows on the same ten experts, and a row whose pairs all name one
    expert (what no top-k gives, and what the dense dispatch keeps whole at
    K slots): each pair counts once, with its own gate value."""
    E, K, d, d_e = GRANITE4H
    ws = _experts(E, d, d_e, torch.bfloat16, 3)
    x, idx, vals = _decode_inputs(8, E, K, d, torch.bfloat16, 4)
    idx = idx[:1].expand(8, 1, K).contiguous()
    _decode_held(x, idx, vals, ws)
    _decode_held(x[:2], torch.full((2, 1, K), 7, dtype=torch.int64, device="cuda"), vals[:2], ws)


def test_a_pair_routed_nowhere_adds_nothing():
    E, K, d, d_e = GRANITE
    ws = _experts(E, d, d_e, torch.float32, 5)
    x, idx, vals = _decode_inputs(2, E, K, d, torch.float32, 6)
    idx[0, 0, 3], idx[1, 0, 0] = -1, E
    _decode_held(x, idx, vals, ws)


def test_a_captured_decode_call_replays_on_new_choices_and_counts_each_replay():
    E, K, d, d_e = GRANITE4H
    ws = _experts(E, d, d_e, torch.bfloat16, 7)
    x, idx, vals = _decode_inputs(1, E, K, d, torch.bfloat16, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        ops.moe_decode(x, idx, vals, *ws, capacity=4)  # loads the kernel before the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    ops.reset_counters()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as recorded, torch.cuda.graph(graph), torch.no_grad():
        out = ops.moe_decode(x, idx, vals, *ws, capacity=4)
    assert recorded["launches"] == _build.counts(moe_decode=1)
    assert ops.launches == _build.counts()
    for seed in (9, 10, 11):
        x2, idx2, vals2 = _decode_inputs(1, E, K, d, torch.bfloat16, seed)
        x.copy_(x2)
        idx.copy_(idx2)
        vals.copy_(vals2)
        graph.replay()
        _build.replayed(recorded)
        torch.cuda.synchronize()
        with torch.no_grad():
            eager = ops.moe_decode(x, idx, vals, *ws, capacity=4)
        assert torch.equal(out, eager)  # fixed summation order: the same bits
    assert ops.launches == _build.counts(moe_decode=6)
    assert ops.plain == _build.counts()


def test_the_decode_kernel_refuses_what_it_cannot_take():
    from repro_torch.kernels.moe_decode import moe_decode

    E, K, d, d_e = GRANITE
    ws = _experts(E, d, d_e, torch.bfloat16, 12)
    x, idx, vals = _decode_inputs(1, E, K, d, torch.bfloat16, 13)
    with pytest.raises(ValueError, match="shapes do not fit"):
        moe_decode(x, idx, vals, ws[0][:, :, :256], *ws[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_decode(x[:1].half(), idx[:1], vals[:1], *(w.half() for w in ws))
    with pytest.raises(TypeError, match="int64"):
        moe_decode(x[:1], idx[:1].int(), vals[:1], *ws)
    w_gate = ws[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        moe_decode(x[:1], idx[:1], vals[:1], w_gate, *ws[1:])
    with pytest.raises(ValueError, match=r"\(B, 1, d\)"):
        moe_decode(x[:1].expand(1, 2, d), idx[:1], vals[:1], *ws)
    assert ops.launches == _build.counts()


def test_under_autograd_the_dispatcher_takes_the_dense_dispatch():
    E, K, d, d_e = GRANITE
    ws = [w.requires_grad_(True) for w in _experts(E, d, d_e, torch.float32, 14)]
    x, idx, vals = _decode_inputs(1, E, K, d, torch.float32, 15)
    ops.moe_decode(x, idx, vals, *ws, capacity=4).sum().backward()
    assert ops.launches == _build.counts()
    assert ops.plain == _build.counts(moe_decode=1)
    assert all(w.grad is not None for w in ws)


def test_a_granite4h_decode_step_launches_it_once_a_layer_and_a_prefill_not_at_all():
    """The small granite-4.0-h of ``test_torch_hybrid_moe.py`` in bf16, with
    a state and heads of 64 that the SSD kernel takes: its prefill computes
    the queue positions once a layer and no decode kernel, each decode step
    the decode kernel once a layer and no positions."""
    import dataclasses

    from portbench import harness
    from repro_torch.models.model import build_model
    from test_torch_hybrid_moe import small_config

    spec = small_config()
    spec["ssm"].update(d_state=64, head_dim=64)
    cfg = dataclasses.replace(harness.arch_config(spec), dtype="bfloat16")
    assert (cfg.ssm.d_state, cfg.ssm.head_dim) in _build.SSD_SHAPES
    L, T = cfg.n_layers, 3
    m = build_model(cfg)
    params = m.init(0)
    prompt = torch.randint(0, cfg.vocab, (1, 40), dtype=torch.int32, device="cuda")
    cache = m.init_cache(1, 64)
    ops.reset_counters()
    m.prefill(params, {"tokens": prompt}, cache)
    assert ops.launches["moe_positions"] == L and ops.launches["moe_decode"] == 0
    ops.reset_counters()
    m.decode_tokens(params, cache, prompt[:, -1:], T)
    torch.cuda.synchronize()
    assert ops.launches["moe_decode"] == L * T and ops.launches["moe_positions"] == 0
    assert ops.plain == _build.counts()
