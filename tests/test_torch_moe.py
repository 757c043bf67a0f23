"""The port's MoE FFN and MoE models against ``repro.models`` on shared weights.

Weights are initialised by JAX and carried over with ``load_jax_params``;
inputs are made from a seed with numpy. Everything is f32 on the CPU (the
smoke configs are f32), so outputs agree to rtol/atol 1e-4 (the two sides
differ only in summation order), and the routing (the experts each token
chose) and greedy tokens are identical.

granite-moe-1b-a400m's smoke config has no shared experts, deepseek-moe-16b's
has one. Capacity is covered both ways: the configs' own factor 1.25, with
inputs whose tokens crowd the same experts so that tokens really are dropped,
and ``capacity_factor = n_experts``, where no token can be.
"""
import _torch_cpu  # noqa: F401
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import _put_mlp, load_jax_params
from repro_torch.models.model import build_model
from repro_torch.serving.backend import ModelServingBackend, ServeRequest

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _configs(arch, capacity):
    """(jax cfg, port cfg) of the smoke config, with ``capacity`` "config"
    (its own 1.25) or "no-drop" (capacity_factor = n_experts)."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if capacity == "no-drop":
        e = float(tcfg.moe.n_experts)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=e))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=e))
    return jcfg, tcfg


def _moe_pair(jcfg, tcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = tmoe.MoE(tcfg, torch.device("cpu"))
    stacked = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], jp)
    with torch.no_grad():
        _put_mlp(tp, stacked, 0, "mlp")
    return jp, tp


def _crowded_x(B, S, d, seed):
    """Inputs sharing one common direction, so the router prefers the same
    few experts for most tokens and their queues overflow."""
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, d) + 3.0 * rs.randn(1, 1, d)).astype(np.float32)


@pytest.mark.parametrize("capacity", ["config", "no-drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, capacity):
    jcfg, tcfg = _configs(arch, capacity)
    jp, tp = _moe_pair(jcfg, tcfg)
    B, S = 3, 24
    x = _crowded_x(B, S, tcfg.d_model, 1)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.tensor(x))
    _close(ty, jy)
    _close(taux, jaux)
    assert taux.shape == () and taux.dtype == torch.float32
    # the routing itself, not only its result: the same experts in the same order
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jvals, jidx = jax.lax.top_k(jprobs, jcfg.moe.top_k)
    _, tprobs = tmoe.router_probs(tp, torch.tensor(x))
    tvals, tidx = tmoe.gates(tcfg.moe, tprobs)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tvals, jvals / jvals.sum(-1, keepdims=True))
    # dropped (token, choice) pairs: some with the config's capacity, none without
    dispatch, _ = tmoe.dispatch_combine(tcfg.moe, tprobs)
    C = tmoe._capacity(S, tcfg.moe.top_k, tcfg.moe.n_experts, tcfg.moe.capacity_factor)
    assert dispatch.shape == (B, S, tcfg.moe.n_experts, C)
    dropped = B * S * tcfg.moe.top_k - int(dispatch.sum())
    assert (dropped > 0) if capacity == "config" else (dropped == 0), dropped
    assert float(dispatch.sum(dim=1).max()) <= 1.0  # a slot holds at most one token
    assert float(dispatch.sum(dim=(2, 3)).max()) <= tcfg.moe.top_k


def test_dropped_token_falls_through_with_zero_ffn_output():
    """A token whose every choice overflowed gets no routed output (the
    residual carries it): its one-hot position row is zeros, not an error."""
    jcfg, tcfg = _configs("granite-moe-1b-a400m", "config")
    _, tp = _moe_pair(jcfg, tcfg)
    x = torch.tensor(_crowded_x(1, 32, tcfg.d_model, 2))
    _, probs = tmoe.router_probs(tp, x)
    dispatch, combine = tmoe.dispatch_combine(tcfg.moe, probs)
    lost = dispatch.sum(dim=(2, 3)) == 0                   # (B, S) tokens with no slot
    assert bool(lost.any())
    y = tmoe.apply_moe(tcfg, tp, x)[0]
    assert torch.all(y[lost] == 0)
    assert torch.all(combine[lost] == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_route_independently(arch):
    """Capacity is per row: a batch of rows gives each row what it gives alone."""
    jcfg, tcfg = _configs(arch, "config")
    _, tp = _moe_pair(jcfg, tcfg)
    x = torch.tensor(_crowded_x(3, 20, tcfg.d_model, 3))
    y = tp(x)
    for b in range(3):
        torch.testing.assert_close(y[b:b + 1], tp(x[b:b + 1]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tmoe.apply_moe(tcfg, tp, x)[0], y, rtol=0, atol=0)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax model, jax params, torch model, torch params) per arch."""
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch), device="cpu")
    tp = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def test_forward_logits_and_aux_match(pair):
    jcfg, jm, jp, tm, tp = pair
    tokens = np.random.RandomState(8).randint(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jlog, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    tlog, taux = tm.forward(tp, {"tokens": torch.tensor(tokens)})
    _close(tlog, jlog)
    _close(taux, jaux)
    assert float(taux) > 0.0  # the router's terms, summed over the layers


def test_prefill_decode_step_and_decode_tokens_match(pair):
    jcfg, jm, jp, tm, tp = pair
    B, S, T = 2, 11, 6
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jcache = jm.init_cache(B, 32)
    tcache = tm.init_cache(B, 32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcache)
    tlog, tcache = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, tcache)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    tok = tokens[:, -1:]
    jlog, jcache2 = jm.decode_step(jp, jcache, jnp.asarray(tok))
    tlog, _ = tm.decode_step(tp, tcache, torch.tensor(tok))
    _close(tlog, jlog)
    _close(tcache["v"], jcache2["v"])
    jtoks, jcache3 = jm.decode_tokens(jp, jcache2, jnp.asarray(tok), T)
    ttoks, tcache3 = tm.decode_tokens(tp, tcache, torch.tensor(tok), T)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tcache3["k"], jcache3["k"])
    assert tcache3["lengths"].tolist() == np.asarray(jcache3["lengths"]).tolist()


def test_load_refuses_a_tree_of_another_family(pair):
    jcfg, _, jp, tm, _ = pair
    dense = jax_build_model(jax_smoke_config("llama3.2-1b"))
    dense_tree = jax.tree_util.tree_map(np.asarray, dense.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="FFN"):
        load_jax_params(build_model(get_smoke_config("llama3.2-1b"), device="cpu").init(0),
                        jax.tree_util.tree_map(np.asarray, jp))
    with pytest.raises(ValueError, match="FFN"):
        load_jax_params(tm.init(2), dense_tree)


def test_batched_streams_do_not_change_tokens():
    be = ModelServingBackend(get_smoke_config("granite-moe-1b-a400m"), seed=0, device="cpu")
    req = ServeRequest(prompt=np.arange(1, 21, dtype=np.int32), max_new_tokens=4)
    solo = be.run_model(req, load=1)
    for load in (2, 3, 4):
        np.testing.assert_array_equal(solo, be.run_model(req, load=load))


# ---------------------------------------------------------------------------
# the queue positions: ops.moe_positions, the kernel on the card and the
# cumsum form (kernels/ref.py) on the CPU
# ---------------------------------------------------------------------------


def _jax_positions(jidx, E):
    """The queue positions as ``repro.models.moe.apply_moe`` computes them
    from the router's choices (before it clips them to the capacity)."""
    B, S, K = jidx.shape
    onehot = jax.nn.one_hot(jidx, E, dtype=jnp.float32)
    pos_in_e = jnp.cumsum(onehot.reshape(B, S * K, E), axis=1).reshape(B, S, K, E)
    pos_in_e = (pos_in_e - 1.0) * onehot
    return np.asarray(jnp.sum(pos_in_e * onehot, axis=-1).astype(jnp.int32))


def _counted(idx, E):
    """Each pair's position by counting the earlier pairs of its row on its
    expert, one at a time."""
    B, S, K = idx.shape
    flat = idx.reshape(B, S * K).tolist()
    out = [[sum(e == v for e in row[:i]) if 0 <= v < E else 0 for i, v in enumerate(row)]
           for row in flat]
    return torch.tensor(out, dtype=torch.int32).reshape(B, S, K)


@pytest.mark.parametrize("capacity", ["config", "no-drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_positions_match_the_references_queue_positions(arch, capacity):
    from repro_torch.kernels import ops

    jcfg, tcfg = _configs(arch, capacity)
    jp, tp = _moe_pair(jcfg, tcfg)
    E, K = tcfg.moe.n_experts, tcfg.moe.top_k
    x = _crowded_x(3, 24, tcfg.d_model, 1)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, K)
    _, tidx = tmoe.gates(tcfg.moe, tmoe.router_probs(tp, torch.tensor(x))[1])
    pos = ops.moe_positions(tidx, E)
    np.testing.assert_array_equal(pos.numpy(), _jax_positions(jidx, E))
    assert pos.dtype == torch.int32 and torch.equal(pos, _counted(tidx, E))


def test_plain_positions_count_each_row_alone_and_clip_nothing():
    from repro_torch.kernels import ref

    idx = torch.tensor(np.random.RandomState(4).randint(0, 5, size=(3, 40, 3)))
    pos = ref.moe_positions_ref(idx, 5)
    assert torch.equal(pos, _counted(idx, 5))
    for b in range(3):
        assert torch.equal(pos[b:b + 1], ref.moe_positions_ref(idx[b:b + 1], 5))
    one = torch.full((1, 50, 4), 2)  # every pair on one expert: one queue of 200
    assert torch.equal(ref.moe_positions_ref(one, 5).flatten(), torch.arange(200, dtype=torch.int32))
    idx[0, 3, 1], idx[1, 7, 0] = -1, 5  # outside the experts: position 0, counted nowhere
    assert torch.equal(ref.moe_positions_ref(idx, 5), _counted(idx, 5))


def test_the_dispatcher_sends_a_cpu_call_to_the_plain_version():
    from repro_torch.kernels import ops, ref

    idx = torch.tensor(np.random.RandomState(5).randint(0, 8, size=(2, 9, 2)))
    ops.reset_counters()
    want = ref.moe_positions_ref(idx, 8)
    assert torch.equal(ops.moe_positions(idx, 8), want)
    with ops.plain_path():
        assert torch.equal(ops.moe_positions(idx, 8), want)
    assert ops.plain == ops.counts(moe_positions=2)
    assert ops.launches == ops.counts()
    ops.reset_counters()


def test_the_kernel_is_built_and_counted():
    """``_build.counts()`` and the launch counters name the kernel; its
    kernels carry no name that the benchmark's roofline readers look for
    (``flash``, ``decode_kernel``, ``ssd_``)."""
    import re

    from repro_torch.kernels import _build, ops

    assert "moe_positions" in _build.KERNELS and _build.counts()["moe_positions"] == 0
    assert ops.launches["moe_positions"] == 0 and ops.plain["moe_positions"] == 0
    src = (_build.CSRC / _build.SOURCES["moe_positions"]).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert sorted(names) == ["moe_count_kernel", "moe_rank_kernel"]
    assert _build._SIGNATURES["moe_positions"][0] in src


def _launched_as_on_card(monkeypatch):
    """Patches the dispatcher so that the router's int64 indices count as on
    the card (no other input it routes is int64) and the launcher counts a
    launch and runs the plain form: the kernel's route, on the CPU."""
    from repro_torch.kernels import _build, ops, ref

    def launch(idx, E):
        _build.check("moe_positions", 0)
        return ref.moe_positions_ref(idx, E)

    monkeypatch.setattr(ops, "_on_card", lambda t: t.dtype == torch.int64)
    monkeypatch.setattr(ops, "_moe_positions", launch)


def served_calls(m, params, S=11, T=3):
    """The launches and plain calls of the queue positions in one forward,
    one prefill and ``T`` decode steps of ``m``."""
    from repro_torch.kernels import ops

    tokens = torch.arange(1, S + 1, dtype=torch.int32)[None]
    ops.reset_counters()
    m.forward(params, {"tokens": tokens})
    cache = m.init_cache(1, 32)
    m.prefill(params, {"tokens": tokens}, cache)
    m.decode_tokens(params, cache, tokens[:, -1:], T)
    calls = ops.launches["moe_positions"], ops.plain["moe_positions"]
    ops.reset_counters()
    return calls


@pytest.mark.parametrize("use_kernels", [True, False])
def test_use_kernel_reaches_the_router_in_forward_prefill_and_decode(monkeypatch, use_kernels):
    """The model's ``use_kernels`` reaches ``ops.moe_positions`` in forward,
    prefill and decode: the kernel path launches once a layer a call (3
    decode steps) and the plain path calls the plain version as often."""
    _launched_as_on_card(monkeypatch)
    cfg = get_smoke_config("granite-moe-1b-a400m")
    m = build_model(cfg, device="cpu", use_kernels=use_kernels)
    calls = cfg.n_layers * (2 + 3)
    assert served_calls(m, m.init(0)) == ((calls, 0) if use_kernels else (0, calls))
