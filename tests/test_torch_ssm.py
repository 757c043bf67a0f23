"""The port's recurrent cells (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same numpy inputs, at the shapes and ``(S,
chunk)`` cases of test_ssm_cells.py: padding (S not a multiple of the
chunk), S < chunk and several chunks.

Tolerance: outputs and final states within 1e-5 of the largest value of the
reference's (f32; the two sides sum in different orders). Step chains are
held to the port's own chunked prefix at the reference's 2e-4 / 2e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

REL = 1e-5


def _rel_close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max |diff| {err:.3e} > {rel} x max |want| {scale:.3e}"


def _ssd_inputs(B, S, H, P, N, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = (np.abs(rs.randn(B, S, H)) * 0.5).astype(np.float32)
    A = -np.abs(rs.randn(H)).astype(np.float32)
    Bm = rs.randn(B, S, N).astype(np.float32)
    Cm = rs.randn(B, S, N).astype(np.float32)
    D = rs.randn(H).astype(np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 16), (33, 8), (16, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches(S, chunk, with_h0):
    B, H, P, N = 2, 3, 8, 5
    args = _ssd_inputs(B, S, H, P, N, 0)
    h0 = np.random.RandomState(1).randn(B, H, N, P).astype(np.float32) if with_h0 else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(torch.tensor, args), chunk=chunk,
                              h0=None if h0 is None else torch.tensor(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _rel_close(ty, jy)
    _rel_close(th, jh)


def test_ssd_step_chain_matches_reference_and_chunked():
    B, S, H, P, N = 1, 12, 2, 4, 3
    x, dt, A, Bm, Cm, D = _ssd_inputs(B, S, H, P, N, 1)
    D = np.zeros(H, np.float32)
    ty_c, th_c = tssm.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm, D)), chunk=4)
    jh, th = jnp.zeros((B, H, N, P)), torch.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        jy, jh = jssm.ssd_step(*map(jnp.asarray, (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)),
                               jh)
        ty, th = tssm.ssd_step(*map(torch.tensor, (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)),
                               th)
        _rel_close(ty, jy)
        ys.append(ty)
    _rel_close(th, jh)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), ty_c.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(th.numpy(), th_c.numpy(), rtol=2e-4, atol=2e-4)


def _mlstm_inputs(B, S, H, P, seed, f_shift=2.0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, P).astype(np.float32) for _ in range(3))
    ig = rs.randn(B, S, H).astype(np.float32)
    fg = rs.randn(B, S, H).astype(np.float32) + f_shift
    return q, k, v, ig, fg


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16), (30, 8), (12, 32)])
def test_mlstm_chunked_matches(S, chunk):
    args = _mlstm_inputs(2, S, 2, 8, 2)
    jh, jstate = jssm.mlstm_chunked(*map(jnp.asarray, args), chunk=chunk)
    th, tstate = tssm.mlstm_chunked(*map(torch.tensor, args), chunk=chunk)
    _rel_close(th, jh)
    for t, j in zip(tstate, jstate, strict=True):
        _rel_close(t, j)


def test_mlstm_chunked_continues_from_a_given_state():
    """Two halves with the state carried equal the reference's, and the
    port's own single pass."""
    args = _mlstm_inputs(2, 40, 2, 8, 3)
    first = [a[:, :24] for a in args]
    second = [a[:, 24:] for a in args]
    _, jst = jssm.mlstm_chunked(*map(jnp.asarray, first), chunk=8)
    jh, jst = jssm.mlstm_chunked(*map(jnp.asarray, second), chunk=8, state=jst)
    _, tst = tssm.mlstm_chunked(*map(torch.tensor, first), chunk=8)
    th, tst = tssm.mlstm_chunked(*map(torch.tensor, second), chunk=8, state=tst)
    _rel_close(th, jh)
    for t, j in zip(tst, jst, strict=True):
        _rel_close(t, j)
    whole, _ = tssm.mlstm_chunked(*map(torch.tensor, args), chunk=8)
    np.testing.assert_allclose(th.numpy(), whole[:, 24:].numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("S,chunk", [(1, 4), (13, 4), (17, 16), (30, 7)])
def test_mlstm_step_chain_matches_reference_and_chunked_prefix(S, chunk):
    B, H, P = 1, 2, 4
    args = _mlstm_inputs(B, S, H, P, S * 100 + chunk, f_shift=1.0)
    chunked, _ = tssm.mlstm_chunked(*map(torch.tensor, args), chunk=chunk)
    jstate = (jnp.zeros((B, H, P, P)), jnp.zeros((B, H, P)), jnp.full((B, H), -1e30))
    tstate = tssm.mlstm_init_state(B, H, P, "cpu")
    outs = []
    for t in range(S):
        jh, jstate = jssm.mlstm_step(*[jnp.asarray(a[:, t]) for a in args], jstate)
        th, tstate = tssm.mlstm_step(*[torch.tensor(a[:, t]) for a in args], tstate)
        _rel_close(th, jh)
        outs.append(th)
    for t, j in zip(tstate, jstate, strict=True):
        _rel_close(t, j)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), chunked.numpy(), rtol=2e-3, atol=2e-3)


def _slstm_inputs(B, S, H, P, seed):
    rs = np.random.RandomState(seed)
    xg = (rs.randn(B, S, 4, H, P) * 0.5).astype(np.float32)
    R = (rs.randn(4, H, P, P) * 0.1).astype(np.float32)
    return xg, R


@pytest.mark.parametrize("S", [1, 20])
def test_slstm_scan_matches(S):
    xg, R = _slstm_inputs(2, S, 2, 4, 3)
    jh, jstate = jssm.slstm_scan(jnp.asarray(xg), jnp.asarray(R))
    th, tstate = tssm.slstm_scan(torch.tensor(xg), torch.tensor(R))
    _rel_close(th, jh)
    for t, j in zip(tstate, jstate, strict=True):
        _rel_close(t, j)


def test_slstm_state_carry_matches():
    """Scanning in two halves with the state carried: the reference's, and
    the port's own single scan."""
    xg, R = _slstm_inputs(2, 20, 2, 4, 4)
    full, _ = tssm.slstm_scan(torch.tensor(xg), torch.tensor(R))
    _, jst = jssm.slstm_scan(jnp.asarray(xg[:, :10]), jnp.asarray(R))
    jh2, jst = jssm.slstm_scan(jnp.asarray(xg[:, 10:]), jnp.asarray(R), state=jst)
    h1, tst = tssm.slstm_scan(torch.tensor(xg[:, :10]), torch.tensor(R))
    h2, tst = tssm.slstm_scan(torch.tensor(xg[:, 10:]), torch.tensor(R), state=tst)
    _rel_close(h2, jh2)
    for t, j in zip(tst, jst, strict=True):
        _rel_close(t, j)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_softplus_is_logaddexp_where_torch_switches_to_the_identity():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0, 90.0], np.float32)
    got = tssm.softplus(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.logaddexp(jnp.asarray(x), 0.0)),
                               rtol=1e-6, atol=0)
    assert torch.isfinite(got).all()
