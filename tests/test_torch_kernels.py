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
