"""The port's kernels module by module: plain PyTorch versions against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode (the
sweep of test_kernels.py), and the dispatcher on CPU tensors. The CUDA
kernels against their plain versions are in test_torch_kernels_cuda.py,
which imports no JAX so that it runs on the machine with the card.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: f32 2e-3 (rtol and atol, as test_kernels.py: the two sides sum
in different orders and the Pallas side runs blockwise online softmax);
bf16 matmul 5e-2 (inputs and outputs rounded to 8 mantissa bits); bf16
attention 2e-2 (the Pallas kernel also rounds P to bf16).
"""
import _torch_cpu  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.matmul_probe import matmul as pallas_matmul
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(x, dtype):
    """The same values in both frameworks (bf16 rounding done once, by jnp)."""
    j = jnp.asarray(x, JDT[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# plain versions against repro.kernels.ref and the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (256, 1024, 256), (128, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    aj, at = _both(_np((m, k), 0), dtype)
    bj, bt = _both(_np((k, n), 1), dtype)
    out = ops.matmul(at, bt)
    assert out.dtype == TDT[dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(pallas_matmul(aj, bj, interpret=True), np.float32),
        rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jref.matmul_ref(aj, bj), np.float32),
        rtol=tol, atol=tol * 10)


def test_matmul_ragged_needs_no_padding():
    """(100,300)x(300,77): the JAX wrapper pads; the port's takes it as is."""
    a, b = _np((100, 300), 2), _np((300, 77), 3)
    out = ops.matmul(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("batch,qh,kvh,seq,d", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 256, 64),     # GQA 4:1
    (2, 4, 1, 128, 128),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(batch, qh, kvh, seq, d, causal):
    qj, qt = _both(_np((batch, qh, seq, d), 0), "float32")
    kj, kt = _both(_np((batch, kvh, seq, d), 1), "float32")
    vj, vt = _both(_np((batch, kvh, seq, d), 2), "float32")
    out = ops.flash_attention(qt, kt, vt, causal=causal)
    _close(out, pallas_flash(qj, kj, vj, causal=causal, block_q=64, block_k=64,
                             interpret=True), 2e-3)
    _close(out, jref.attention_ref(qj, kj, vj, causal=causal), 2e-3)


@pytest.mark.parametrize("batch,qh,kvh,seq,d,block", [
    (1, 4, 2, 128, 64, 128),
    (1, 8, 2, 256, 64, 64),  # the serving path's 4:1 grouping, the CUDA kernel's 64 blocks
])
def test_flash_plain_bf16_matches_pallas(batch, qh, kvh, seq, d, block):
    """bf16 at 2e-2: the Pallas kernel rounds P to bf16 before PV (as the
    CUDA kernel's bf16 body does) and the plain version does not; the two
    differ by up to about two output ulps."""
    qj, qt = _both(_np((batch, qh, seq, d), 0), "bfloat16")
    kj, kt = _both(_np((batch, kvh, seq, d), 1), "bfloat16")
    vj, vt = _both(_np((batch, kvh, seq, d), 2), "bfloat16")
    out = ops.flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == torch.bfloat16
    _close(out, pallas_flash(qj, kj, vj, causal=True, block_q=block, block_k=block,
                             interpret=True), 2e-2)


@pytest.mark.parametrize("seq,d", [(77, 64), (200, 96), (200, 128), (64, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_and_d96_match_oracle(seq, d, causal):
    """Shapes the Pallas wrapper sends to the oracle: ragged S, d=96."""
    qj, qt = _both(_np((1, 8, seq, d), 4), "float32")
    kj, kt = _both(_np((1, 2, seq, d), 5), "float32")
    vj, vt = _both(_np((1, 2, seq, d), 6), "float32")
    _close(ops.flash_attention(qt, kt, vt, causal=causal),
           jref.attention_ref(qj, kj, vj, causal=causal), 2e-3)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_ref_window_and_lengths_match_oracle(window):
    qj, qt = _both(_np((2, 4, 1, 64), 7), "float32")
    kj, kt = _both(_np((2, 2, 48, 64), 8), "float32")
    vj, vt = _both(_np((2, 2, 48, 64), 9), "float32")
    lengths = np.array([48, 20], np.int32)
    _close(ref.attention_ref(qt, kt, vt, causal=True, window=window,
                             lengths=torch.tensor(lengths)),
           jref.attention_ref(qj, kj, vj, causal=True, window=window,
                              lengths=jnp.asarray(lengths)), 2e-3)


@pytest.mark.parametrize("window", [1, 17, 64, 100, 500])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("qh,kvh,q_seq,kv_seq", [(4, 4, 130, 130), (8, 2, 130, 130),
                                                 (8, 2, 45, 130)])
def test_flash_dispatch_window_matches_oracle(window, causal, qh, kvh, q_seq, kv_seq):
    """``ops.flash_attention(window=)`` on the CPU (the kernel's plain
    version) against the oracle ``repro``'s windowed prefill calls: windows
    below, at and past the sequence, GQA 1 and 4, fewer queries than keys."""
    qj, qt = _both(_np((2, qh, q_seq, 64), 10), "float32")
    kj, kt = _both(_np((2, kvh, kv_seq, 64), 11), "float32")
    vj, vt = _both(_np((2, kvh, kv_seq, 64), 12), "float32")
    ops.reset_counters()
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert ops.plain["flash_attention"] == 1 and sum(ops.launches.values()) == 0
    ops.reset_counters()
    _close(got, jref.attention_ref(qj, kj, vj, causal=causal, window=window), 2e-3)
    if window < kv_seq:  # the window really masks
        full = ops.flash_attention(qt, kt, vt, causal=causal)
        assert not torch.allclose(got, full)
        ops.reset_counters()


@pytest.mark.parametrize("batch,qh,kvh,S,d,block_k", [
    (2, 4, 2, 512, 64, 256),
    (1, 8, 8, 1024, 128, 128),
    (3, 4, 1, 256, 64, 64),
])
def test_decode_plain_matches_pallas(batch, qh, kvh, S, d, block_k):
    qj, qt = _both(_np((batch, qh, 1, d), 0), "float32")
    kj, kt = _both(_np((batch, kvh, S, d), 1), "float32")
    vj, vt = _both(_np((batch, kvh, S, d), 2), "float32")
    lengths = np.random.RandomState(3).randint(1, S + 1, size=batch).astype(np.int32)
    out = ops.decode_attention(qt, kt, vt, torch.tensor(lengths))
    _close(out, pallas_decode(qj, kj, vj, jnp.asarray(lengths), block_k=block_k,
                              interpret=True), 2e-3)
    _close(out, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths)), 2e-3)


def test_decode_plain_length_one_is_first_value_row():
    q, k, v = (torch.tensor(_np(s, i)) for i, s in enumerate(
        [(1, 2, 1, 64), (1, 2, 512, 64), (1, 2, 512, 64)]))
    out = ops.decode_attention(q, k, v, torch.tensor([1], dtype=torch.int32))
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, :, 0].numpy(), rtol=1e-4, atol=1e-4)


def test_decode_length_zero_difference_is_pinned():
    """At length 0 the Pallas kernel (and the port's CUDA kernel) return
    zeros, because l is clamped; the oracle and the port's plain version
    return the mean of V. Serving never asks for length 0."""
    qj, qt = _both(_np((1, 2, 1, 64), 0), "float32")
    kj, kt = _both(_np((1, 2, 256, 64), 1), "float32")
    vj, vt = _both(_np((1, 2, 256, 64), 2), "float32")
    zero = np.zeros(1, np.int32)
    pallas = np.asarray(pallas_decode(qj, kj, vj, jnp.asarray(zero), interpret=True))
    assert np.all(pallas == 0.0)
    plain = ops.decode_attention(qt, kt, vt, torch.tensor(zero))
    np.testing.assert_allclose(plain[0, :, 0].numpy(), vt[0].mean(dim=1).numpy(),
                               rtol=1e-5, atol=1e-5)
    _close(plain, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(zero)), 1e-5)


# ---------------------------------------------------------------------------
# the CUDA decode kernel's split plan, on the CPU (no kernel runs here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,kvh,S", [(1, 8, 512), (1, 8, 300), (2, 2, 4096), (1, 1, 1024),
                                         (4, 8, 16), (64, 8, 512)])
def test_decode_split_plan_covers_prefix_once(batch, kvh, S):
    """Each share of the valid prefix is a KEY_GRAN multiple (the last may be
    cut by the prefix); together they cover [0, len) once, in split order."""
    splits = kd.n_splits(batch, kvh, S)
    assert 1 <= splits <= kd.MAX_SPLITS
    assert splits <= -(-S // kd.KEY_GRAN)
    for length in sorted({0, 1, splits - 1, 266, S, S + 5, -3}):
        n = max(0, min(length, S))
        ranges = [kd.split_range(length, S, splits, s) for s in range(splits)]
        covered = []
        for start, end in ranges:
            assert 0 <= start <= end <= n
            covered.extend(range(start, end))
        assert covered == list(range(n))
        sizes = [end - start for start, end in ranges if end > start]
        assert all(size % kd.KEY_GRAN == 0 for size in sizes[:-1])


def test_decode_n_splits_fills_the_card_from_shapes_only():
    assert kd.SMS <= kd.n_splits(1, 8, 4096) * 8 <= 2 * kd.SMS  # a long cache at batch 1
    assert kd.n_splits(1, 8, 512) == 512 // kd.KEY_GRAN  # llama3.2-1b serving: a share a KEY_GRAN
    assert kd.n_splits(64, 8, 512) == 1
    assert kd.n_splits(1, 1, 16) == 1  # less than one KEY_GRAN share of the cache
    assert kd.n_splits(1, 1, 1 << 20) == kd.MAX_SPLITS


def _split_merge(q, k, v, lengths):
    """The kernel's arithmetic in f32 on the CPU: per-split m, l and PV sums
    over split_range's keys (empty splits give m = -inf, l = 0), merged in
    split order, zeros where the prefix is empty."""
    batch, qh, _, d = q.shape
    _, kvh, S, _ = k.shape
    group = qh // kvh
    splits = kd.n_splits(batch, kvh, S)
    qg = q.float().reshape(batch, kvh, group, d)
    out = torch.zeros(batch, kvh, group, d)
    for b in range(batch):
        for h in range(kvh):
            parts = []
            for s in range(splits):
                start, end = kd.split_range(int(lengths[b]), S, splits, s)
                if start == end:
                    parts.append((torch.full((group,), -torch.inf), torch.zeros(group), None))
                    continue
                x = qg[b, h] @ k[b, h, start:end].float().T / np.sqrt(d)
                m = x.max(dim=1).values
                p = torch.exp(x - m[:, None])
                parts.append((m, p.sum(dim=1), p @ v[b, h, start:end].float()))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            total, acc = torch.zeros(group), torch.zeros(group, d)
            for m, l, a in parts:
                if a is None:
                    continue
                f = torch.exp(m - mx)
                total += l * f
                acc += a * f[:, None]
            out[b, h] = acc / total.clamp_min(1e-20)[:, None]
    return out.reshape(batch, qh, 1, d)


@pytest.mark.parametrize("batch,qh,kvh,S,d,block_k,lengths", [
    (2, 4, 2, 512, 64, 256, [266, 1]),
    (3, 4, 1, 256, 64, 64, [0, 1, 3]),       # length 0 gives zeros
    (1, 8, 2, 300, 64, 100, [299]),          # S not a multiple of the share
    (1, 4, 1, 1024, 64, 256, [5]),           # fewer keys than splits
])
def test_decode_split_merge_matches_pallas_and_oracle(batch, qh, kvh, S, d, block_k, lengths):
    qj, qt = _both(_np((batch, qh, 1, d), 10), "float32")
    kj, kt = _both(_np((batch, kvh, S, d), 11), "float32")
    vj, vt = _both(_np((batch, kvh, S, d), 12), "float32")
    lens = np.asarray(lengths, np.int32)
    out = _split_merge(qt, kt, vt, lens)
    pallas = np.asarray(pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=block_k,
                                      interpret=True), np.float32)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-3, atol=2e-3)
    oracle = np.asarray(jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens)), np.float32)
    live = lens > 0  # the oracle gives the mean of V at length 0
    np.testing.assert_allclose(out.numpy()[live], oracle[live], rtol=2e-3, atol=2e-3)
    assert np.all(out.numpy()[~live] == 0.0)


# ---------------------------------------------------------------------------
# the dispatcher on CPU tensors
# ---------------------------------------------------------------------------


def test_dispatcher_on_cpu_counts_plain_calls_and_no_launches():
    ops.reset_counters()
    a = torch.ones(8, 8)
    q = torch.ones(1, 2, 4, 64)
    ops.matmul(a, a)
    with ops.plain_path():
        ops.matmul(a, a)
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :, :1], q, q, torch.tensor([2], dtype=torch.int32))
    ssd = _ssd_args(1, 6, 2, 16, 0)
    ops.ssd_chunked(*ssd, chunk=4)
    with ops.plain_path():
        ops.ssd_chunked(*ssd, chunk=4)
    assert ops.plain == ops.counts(matmul=2, flash_attention=1, decode_attention=1, ssd_chunked=2)
    assert ops.launches == ops.counts()
    ops.reset_counters()
    assert sum(ops.plain.values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never runs its plain version: CPU tensors are refused."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul
    from repro_torch.kernels.moe_positions import moe_positions
    from repro_torch.kernels.ssd_chunk import ssd_chunked

    a = torch.ones(4, 4)
    q = torch.ones(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        matmul(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked(*_ssd_args(1, 6, 2, 16, 0), chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, :, :1], q, q, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        moe_positions(torch.zeros((1, 4, 2), dtype=torch.int64), 8)


# ---------------------------------------------------------------------------
# the SSD scan's route: the kernel on the card without a gradient, the plain
# scan (models/ssm.py) otherwise
# ---------------------------------------------------------------------------


def _ssd_args(B, S, H, N, seed, grad=False):
    """x (B, S, H, N), dt, A, Bm, Cm, D as zamba2's block hands them over."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(B, S, H, N).astype(np.float32), requires_grad=grad)
    dt = torch.nn.functional.softplus(torch.tensor(rs.randn(B, S, H).astype(np.float32)))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.tensor(rs.randn(B, S, N).astype(np.float32)) for _ in range(2))
    return x, dt, A, Bm, Cm, torch.ones(H)


def test_ssd_dispatch_on_cpu_is_the_plain_scan():
    from repro_torch.models.ssm import ssd_chunked

    args = _ssd_args(2, 37, 3, 16, 1)
    h0 = torch.tensor(_np((2, 3, 16, 16), 2))
    ops.reset_counters()
    for kw in ({}, {"h0": h0}):
        got, want = ops.ssd_chunked(*args, chunk=16, **kw), ssd_chunked(*args, chunk=16, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.plain["ssd_chunked"] == 2 and ops.launches["ssd_chunked"] == 0
    ops.reset_counters()


def test_ssd_dispatch_on_the_card_route_launches_only_without_a_gradient(monkeypatch):
    """With ``_on_card`` patched, a call without a gradient goes to the
    kernel's launcher (patched to count); in ``ops.plain_path()``, and any
    input that requires grad under grad mode (zamba2's training), to the
    plain scan, which autograd can differentiate."""
    from repro_torch.kernels import _build

    calls = []

    def launcher(*args, chunk, h0=None):
        calls.append(chunk)
        _build.check("ssd_chunked", 0)
        return args[0], None

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_ssd_chunked", launcher)
    ops.reset_counters()
    args = _ssd_args(1, 10, 2, 16, 3)
    ops.ssd_chunked(*args, chunk=4)
    ops.ssd_chunked(*_ssd_args(1, 10, 2, 16, 3, grad=True), chunk=4, h0=None)
    with torch.no_grad():  # grad mode off: the kernel, whatever requires grad
        ops.ssd_chunked(*_ssd_args(1, 10, 2, 16, 3, grad=True), chunk=4)
    with ops.plain_path():
        ops.ssd_chunked(*args, chunk=4)
    h0 = torch.zeros(1, 2, 16, 16, requires_grad=True)
    y, h = ops.ssd_chunked(*args, chunk=4, h0=h0)
    assert calls == [4, 4]
    assert ops.launches["ssd_chunked"] == 2 and ops.plain["ssd_chunked"] == 3
    h.sum().backward()
    assert h0.grad is not None
    ops.reset_counters()


def test_ssd_kernel_is_built_with_the_others_and_names_no_attention_kernel():
    """``prepare_capture`` builds every entry of ``KERNELS``; the benchmark's
    K2 and K3 rooflines (and the trace test) find attention kernels by
    ``flash`` and ``decode_kernel`` in a kernel's name, so no SSD kernel may
    carry either."""
    import re

    from repro_torch.kernels import _build

    assert "ssd_chunked" in _build.KERNELS and _build.SOURCES["ssd_chunked"] == "ssd_chunk.cu"
    assert _build.SSD_SHAPES == ((16, 16), (64, 64), (128, 64))
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert sorted(names) == ["ssd_out_kernel", "ssd_pass_kernel", "ssd_state_kernel"]
    assert not any("flash" in n or "decode_kernel" in n for n in names)
    assert _build._SIGNATURES["ssd_chunked"][0] in src


def test_counts_names_every_kernel_and_refuses_others():
    """Expected counter dicts are built by ``_build.counts``: every entry of
    ``KERNELS``, 0 unless named, and a name that is no kernel raises."""
    from repro_torch.kernels import _build

    assert _build.counts() == dict.fromkeys(_build.KERNELS, 0) == ops.counts()
    assert _build.counts(ssd_chunked=3) == {**dict.fromkeys(_build.KERNELS, 0), "ssd_chunked": 3}
    assert _build.counts() is not _build.counts()
    with pytest.raises(KeyError, match="ssd"):
        _build.counts(ssd=1)


def test_ssd_kernel_reads_the_conv_outputs_slices_as_they_are():
    """The conv output's slices meet the kernel's vector loads as views; a
    view whose rows do not start on 4-element groups does not (the wrapper
    refuses it)."""
    from repro_torch.kernels.ssd_chunk import vector_rows

    packed = torch.zeros(2, 40, 4 * 16 + 2 * 16)
    xs, Bm = packed[..., :64].reshape(2, 40, 4, 16), packed[..., 64:80]
    assert vector_rows(xs) and vector_rows(Bm)
    assert not vector_rows(torch.zeros(2, 40, 83)[..., 1:81])
    assert not vector_rows(torch.zeros(2, 40, 16).transpose(1, 2))


# ---------------------------------------------------------------------------
# K3's log-sum-exp form: the local half of the length-sharded flash-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,qh,kvh,S,d,lengths", [
    (2, 4, 2, 96, 64, [96, 37]),
    (3, 8, 2, 200, 128, [1, 200, 64]),
    (1, 6, 6, 50, 64, [0]),  # length 0: -inf, the output pinned as before
])
def test_decode_plain_lse_matches_oracle_scores(batch, qh, kvh, S, d, lengths):
    """The plain version's log-sum-exp is ``logsumexp`` of the reference
    oracle's scaled scores over each row's valid prefix; its output is the
    output without the log-sum-exp."""
    q, k, v = _np((batch, qh, 1, d), 0), _np((batch, kvh, S, d), 1), _np((batch, kvh, S, d), 2)
    lens = np.array(lengths, dtype=np.int32)
    tq, tk, tv, tl = map(torch.tensor, (q, k, v, lens))
    out, lse = ref.decode_attention_ref(tq, tk, tv, tl, return_lse=True)
    assert torch.equal(out, ref.decode_attention_ref(tq, tk, tv, tl))
    qg = jnp.asarray(q).reshape(batch, kvh, qh // kvh, d)
    s = jnp.einsum("bkgd,bksd->bkgs", qg, jnp.asarray(k)) / np.sqrt(d)
    for b, n in enumerate(lengths):
        got = lse[b].numpy()
        if n == 0:
            assert np.all(got == -np.inf)
            continue
        want = np.asarray(jnp.log(jnp.sum(jnp.exp(s[b, ..., :n] - s[b, ..., :n].max(-1, keepdims=True)),
                                          -1)) + s[b, ..., :n].max(-1)).reshape(qh)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decode_lse_slices_merge_to_the_whole():
    """Outputs and log-sum-exps of slices of one cache, merged by the
    reference's algebra (max, weights, weighted sum), equal the unsliced
    output: an empty slice has weight 0."""
    batch, qh, kvh, S, d = 2, 4, 2, 128, 64
    q, k, v = _np((batch, qh, 1, d), 5), _np((batch, kvh, S, d), 6), _np((batch, kvh, S, d), 7)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    valid = torch.tensor([40, 100], dtype=torch.int32)
    whole = ref.decode_attention_ref(tq, tk, tv, valid)
    parts = []
    for start in range(0, S, S // 4):
        n = (valid - start).clamp(0, S // 4).to(torch.int32)
        parts.append(ref.decode_attention_ref(tq, tk[:, :, start:start + S // 4].contiguous(),
                                              tv[:, :, start:start + S // 4].contiguous(), n,
                                              return_lse=True))
    lse = torch.stack([p[1] for p in parts])
    m = lse.max(dim=0).values
    w = torch.where(lse > -np.inf, torch.exp(lse - m), torch.zeros_like(lse))
    merged = sum(w_i[:, :, None, None] * o for w_i, (o, _) in zip(w, parts)) / w.sum(0)[:, :, None, None]
    torch.testing.assert_close(merged, whole, rtol=1e-5, atol=1e-6)


def test_dispatcher_counts_the_lse_form_apart():
    ops.reset_counters()
    q = torch.ones(1, 2, 4, 64)
    out, lse = ops.decode_attention(q[:, :, :1], q, q, torch.tensor([2], dtype=torch.int32),
                                    return_lse=True)
    assert lse.shape == (1, 2) and lse.dtype == torch.float32
    assert ops.plain["decode_attention"] == 0 and ops.form_plain["decode_attention_lse"] == 1
    ops.reset_counters()
    assert ops.form_plain["decode_attention_lse"] == 0
