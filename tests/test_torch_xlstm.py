"""The port's xLSTM (``repro_torch.models.xlstm``) against
``repro.models.xlstm`` on shared weights, at smoke size (2 layers: one
mLSTM and one sLSTM block, 4 heads, chunk 32, f32 on the CPU).

Weights are initialised by JAX and carried over with ``load_jax_params``;
inputs are made from a seed with numpy. Logits and states agree to rtol =
atol = 1e-4, as test_torch_model.py holds the dense model, and greedy
tokens are identical. The reference's flat-dict counterpart of its
``{"states": [...]}`` cache is read group by group (``_states``). The
reference's own check, decode against the parallel forward within 2e-3 of
the largest logit (test_models_smoke.py), runs on the port too.
"""
import _torch_cpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model, greedy_token

ARCH = "xlstm-1.3b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(ARCH), device="cpu")
    tp = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)).astype(np.int32)


def _states(cfg, cache):
    """The port's flat cache as the reference's list of per-group tuples."""
    out = []
    for gi, (kind, _) in enumerate(txlstm._plan(cfg)):
        names = txlstm.MLSTM_STATE if kind == "mlstm" else txlstm.SLSTM_STATE
        out.append(tuple(cache[f"g{gi}.{n}"] for n in names))
    return out


def _states_close(tcache, jcache, cfg):
    for t, j in zip(_states(cfg, tcache), jcache["states"], strict=True):
        for a, b in zip(t, j, strict=True):
            _close(a, b)
    assert tcache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


def test_smoke_config_exercises_both_blocks(pair):
    _, _, _, tm, tp = pair
    assert txlstm._plan(tm.cfg) == [("mlstm", 1), ("slstm", 1)]
    assert isinstance(tp.groups[1], txlstm.SLSTMBlock) and len(tp.groups[0]) == 1
    assert tm.cfg.ssm.chunk == 32


def test_init_cache_matches_the_reference_layout(pair):
    jcfg, jm, _, tm, _ = pair
    _states_close(tm.init_cache(2, 16), jm.init_cache(2, 16), tm.cfg)


def test_forward_logits_match(pair):
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 2, 45, 8)
    jlog, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    tlog, taux = tm.forward(tp, {"tokens": torch.tensor(tokens)})
    _close(tlog, jlog)
    assert float(taux) == 0.0


@pytest.mark.parametrize("S", [20, 70], ids=["one-chunk", "three-chunks-ragged"])
def test_prefill_state_and_decode_steps_match(pair, S):
    """S=70 with chunk 32: three chunks, the last padded by 26."""
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 2, S, 9)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, S + 8))
    tcache = tm.init_cache(2, S + 8)
    tlog, _ = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, tcache)
    _close(tlog, jlog)
    _states_close(tcache, jcache, tm.cfg)
    jtok, ttok = jnp.asarray(tokens[:, -1:]), torch.tensor(tokens[:, -1:])
    for _ in range(8):
        jlog, jcache = jm.decode_step(jp, jcache, jtok)
        tlog, tcache = tm.decode_step(tp, tcache, ttok)
        _close(tlog, jlog)
        jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), greedy_token(tlog)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _states_close(tcache, jcache, tm.cfg)


def test_decode_tokens_matches_the_reference_loop(pair):
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 1, 21, 10)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(1, 40))
    tcache = tm.init_cache(1, 40)
    tm.prefill(tp, {"tokens": torch.tensor(tokens)}, tcache)
    jtoks, _ = jm.decode_tokens(jp, jcache, jnp.asarray(tokens[:, -1:]), 12)
    ttoks, _ = tm.decode_tokens(tp, tcache, torch.tensor(tokens[:, -1:]), 12)
    assert ttoks.dtype == torch.int32
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_decode_matches_parallel_forward(pair):
    """The reference's check on the port: prefill + decode_step == forward
    at the last position (test_models_smoke.py, within 2e-3)."""
    jcfg, _, _, tm, tp = pair
    tokens = torch.tensor(_tokens(jcfg.vocab, 2, 33, 11))
    full, _ = tm.forward(tp, {"tokens": tokens})
    want = full[:, -1]
    cache = tm.init_cache(2, 64)
    tm.prefill(tp, {"tokens": tokens[:, :-1]}, cache)
    got, _ = tm.decode_step(tp, cache, tokens[:, -1:])
    err = (got[:, 0] - want).abs().max() / (want.abs().max() + 1e-9)
    assert float(err) < 2e-3


def test_prefill_starts_from_a_fresh_state_whatever_the_cache_holds(pair):
    """``repro``'s prefill continues from the cache's state, and its serving
    path always hands it a fresh cache; the port's serving path reuses one
    static cache, so its prefill starts from the initial state: a cache
    left by another request gives what a fresh one gives."""
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 1, 30, 12)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(1, 64))
    used = tm.init_cache(1, 64)
    other = torch.tensor(_tokens(jcfg.vocab, 1, 17, 13))
    tm.prefill(tp, {"tokens": other}, used)
    tm.decode_step(tp, used, other[:, -1:])
    tlog, _ = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, used)
    _close(tlog, jlog)
    _states_close(used, jcache, tm.cfg)
    fresh = tm.init_cache(1, 64)
    want, _ = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, fresh)
    assert torch.equal(tlog, want)
    assert all(torch.equal(used[k], fresh[k]) for k in fresh)


def test_cache_is_o1_in_max_len(pair):
    _, _, _, tm, _ = pair
    a, b = tm.init_cache(1, 16), tm.init_cache(1, 4096)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert tm.static_cache(1, 16) is tm.static_cache(1, 4096)
    assert tm.static_cache(2, 16) is not tm.static_cache(1, 16)


def test_model_on_cpu_launches_and_calls_no_attention(pair):
    _, _, _, tm, tp = pair
    ops.reset_counters()
    cache = tm.init_cache(1, 32)
    tm.prefill(tp, {"tokens": torch.arange(5, dtype=torch.int32)[None]}, cache)
    tm.decode_tokens(tp, cache, torch.tensor([[4]], dtype=torch.int32), 3)
    assert sum(ops.plain.values()) == 0 and sum(ops.launches.values()) == 0


def test_converter_refuses_a_tree_of_another_family(pair):
    _, _, jp, tm, _ = pair
    zb = jax_build_model(jax_smoke_config("zamba2-1.2b")).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="hybrid .* model, the model is an xLSTM"):
        load_jax_params(tm.init(0), jax.tree_util.tree_map(np.asarray, zb))
    enc = build_model(get_smoke_config("whisper-small"), device="cpu").init(0)
    with pytest.raises(ValueError, match="xLSTM model, the model is an encoder-decoder"):
        load_jax_params(enc, jax.tree_util.tree_map(np.asarray, jp))


def test_init_is_seeded_with_the_reference_scales():
    cfg = get_smoke_config(ARCH)
    m = build_model(cfg, device="cpu")
    a, b, c = m.init(0), m.init(0), m.init(1)
    ml, sl = a.groups[0][0], a.groups[1]
    assert torch.equal(ml.w_up, b.groups[0][0].w_up) and not torch.equal(ml.w_up, c.groups[0][0].w_up)
    d_inner, H, P = txlstm._dims(cfg)
    assert float(ml.w_up.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(ml.wq.std()) == pytest.approx(P**-0.5, rel=0.05)
    assert torch.all(ml.b_f == 3.0) and torch.all(ml.b_i == -2.0)
    d = cfg.d_model
    assert torch.all(sl.b_gates[2 * d : 3 * d] == 3.0) and not sl.b_gates[:2 * d].any()
    assert not sl.b_gates[3 * d:].any()


def test_full_width_config_is_xlstm_1_3b():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.slstm_every, cfg.vocab) == (48, 2048, 4, 8, 50304)
    assert txlstm._plan(cfg) == [("mlstm", 7), ("slstm", 1)] * 6
    assert txlstm._dims(cfg) == (4096, 4, 1024)
    assert cfg.torch_dtype == torch.bfloat16 and cfg.ssm.chunk == 256
