"""The port's batched estimator states (``repro_torch.core.estimators``:
``WelfordState``, ``P2State`` and their functions) against the reference's
JAX forms (``repro.core.estimators``), on the same seeded numpy streams.

The JAX forms work on one lane and are ``vmap``-ed over the lanes, as
``repro.sim.vectorized`` uses them; the port's take the lane axis leading.
Integer fields must be equal, floats within rtol 1e-6 (one f32 ulp is about
6e-8; the P² marker arithmetic chains a few divisions).
"""
import _torch_cpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.estimators as R
import repro_torch.core.estimators as T

RTOL = 1e-6
LANES = 16


def _stream(seed, n, lanes=LANES):
    rng = np.random.RandomState(seed)
    # lognormal probe durations around 300 ms, as the simulator feeds them
    return (300.0 * np.exp(0.2 * rng.randn(n, lanes))).astype(np.float32)


def _assert_state(got, want, what):
    for name in type(want)._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=f"{what}.{name}")


def _welford_pair(xs, mask=None):
    """Fold ``xs`` (n, lanes) through both forms; ``mask`` (n, lanes) picks
    the masked update."""
    upd = jax.jit(jax.vmap(R.welford_update))
    upd_m = jax.jit(jax.vmap(R.welford_update_masked))
    lanes = xs.shape[1]
    rs = R.welford_init((lanes,))
    ts = T.welford_init((lanes,))
    for i in range(xs.shape[0]):
        if mask is None:
            rs = upd(rs, jnp.asarray(xs[i]))
            ts = T.welford_update(ts, torch.from_numpy(xs[i]))
        else:
            rs = upd_m(rs, jnp.asarray(xs[i]), jnp.asarray(mask[i]))
            ts = T.welford_update_masked(ts, torch.from_numpy(xs[i]), torch.from_numpy(mask[i]))
    return rs, ts


def test_welford_update_std_and_variance_match_jax():
    xs = _stream(0, 40)
    rs, ts = _welford_pair(xs)
    _assert_state(ts, rs, "welford")
    np.testing.assert_allclose(T.welford_std(ts).numpy(), np.asarray(jax.vmap(R.welford_std)(rs)),
                               rtol=RTOL)
    np.testing.assert_allclose(T.welford_variance(ts).numpy(),
                               np.asarray(jax.vmap(R.welford_variance)(rs)), rtol=RTOL)


def test_welford_masked_update_matches_jax():
    """Some lanes take every observation, some none, the rest about half."""
    xs = _stream(1, 40)
    mask = np.random.RandomState(2).rand(*xs.shape) < 0.5
    mask[:, 0] = True
    mask[:, 1] = False
    rs, ts = _welford_pair(xs, mask)
    _assert_state(ts, rs, "welford_masked")
    assert ts.count[1].item() == 0.0 and ts.mean[1].item() == 0.0
    # one observation gives variance 0 in both (count < 2)
    one = np.zeros_like(mask)
    one[0, :] = True
    rs1, ts1 = _welford_pair(xs[:3], one[:3])
    np.testing.assert_array_equal(T.welford_std(ts1).numpy(), np.zeros(LANES, np.float32))
    _assert_state(ts1, rs1, "welford_one")


@pytest.mark.parametrize("sides", ["both", "left_empty", "right_empty", "both_empty"])
def test_welford_merge_matches_jax(sides):
    xs = _stream(3, 30)
    mask_a = np.random.RandomState(4).rand(*xs.shape) < 0.6
    mask_b = ~mask_a
    if sides in ("left_empty", "both_empty"):
        mask_a[:] = False
    if sides in ("right_empty", "both_empty"):
        mask_b[:] = False
    ra, ta = _welford_pair(xs, mask_a)
    rb, tb = _welford_pair(xs, mask_b)
    rm = jax.vmap(R.welford_merge)(ra, rb)
    tm = T.welford_merge(ta, tb)
    _assert_state(tm, rm, f"merge[{sides}]")
    if sides == "both_empty":
        assert float(tm.count.sum()) == 0.0 and float(tm.mean.abs().sum()) == 0.0


def test_p2_through_warmup_and_steady_state_matches_jax():
    """Lanes observe on their own schedules, so in one batch some lanes are
    still in warm-up (< 5 observations) while others are in the steady state,
    and some cross the switch at the fifth observation in the same update."""
    n = 60
    xs = _stream(5, n)
    rng = np.random.RandomState(6)
    # lane j observes with probability rate[j]: from every step to almost never
    rate = np.linspace(1.0, 0.05, LANES)
    mask = rng.rand(n, LANES) < rate[None, :]
    p = np.linspace(0.1, 0.9, LANES).astype(np.float32)

    upd = jax.jit(jax.vmap(lambda s, x, m: jax.tree_util.tree_map(
        lambda a, b: jnp.where(m, a, b), R.p2_update(s, x), s)))
    val = jax.jit(jax.vmap(R.p2_value))
    rs = jax.vmap(R.p2_init)(jnp.asarray(p))
    ts = T.p2_init(torch.from_numpy(p))
    _assert_state(ts, rs, "p2_init")
    mixed = 0
    for i in range(n):
        rs = upd(rs, jnp.asarray(xs[i]), jnp.asarray(mask[i]))
        new = T.p2_update(ts, torch.from_numpy(xs[i]))
        m = torch.from_numpy(mask[i])
        ts = T.P2State(*[torch.where(m.view(m.shape + (1,) * (b.dim() - 1)), a, b)
                         for a, b in zip(new, ts)])
        _assert_state(ts, rs, f"p2 step {i}")
        # the value is read in warm-up from the first observation on
        nobs = ts.n_obs.numpy()
        seen = nobs > 0
        np.testing.assert_allclose(T.p2_value(ts).numpy()[seen], np.asarray(val(rs))[seen],
                                   rtol=RTOL, err_msg=f"p2_value step {i}")
        mixed += int(((nobs < 5) & seen).any() and (nobs >= 5).any())
    assert mixed > 10
    assert (ts.n_obs.numpy() >= 6).any() and (ts.n_obs.numpy() < 5).any()


def test_p2_update_in_steady_state_writes_no_warmup_slot():
    """A steady-state lane keeps its five heights ordered: the warm-up write
    at ``n_obs`` (>= 5, out of range) must not land anywhere."""
    ts = T.p2_init(torch.full((3,), 0.4))
    for x in (5.0, 1.0, 4.0, 2.0, 3.0, 0.5, 9.0):
        ts = T.p2_update(ts, torch.full((3,), x))
    h = ts.heights.numpy()
    assert (np.diff(h, axis=-1) >= 0).all()
    assert h[0, 0] == 0.5 and h[0, 4] == 9.0
