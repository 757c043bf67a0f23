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
    ops.matmul(a, a, use_kernel=False)
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :, :1], q, q, torch.tensor([2], dtype=torch.int32))
    assert ops.plain == {"matmul": 2, "flash_attention": 1, "decode_attention": 1}
    assert ops.launches == {"matmul": 0, "flash_attention": 0, "decode_attention": 0}
    ops.reset_counters()
    assert sum(ops.plain.values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never runs its plain version: CPU tensors are refused."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_probe import matmul

    a = torch.ones(4, 4)
    q = torch.ones(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        matmul(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, :, :1], q, q, torch.tensor([1], dtype=torch.int32))
