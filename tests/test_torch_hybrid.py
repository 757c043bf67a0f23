"""The port's Zamba2 hybrid (``repro_torch.models.hybrid``) against
``repro.models.hybrid`` on shared weights, at smoke size (2 Mamba2 layers,
the shared block after the first, window 64, chunk 32, f32 on the CPU).

Weights are initialised by JAX and carried over with ``load_jax_params``;
inputs are made from a seed with numpy. Logits and states agree to rtol =
atol = 1e-4, as test_torch_model.py holds the dense model (the two sides
differ only in summation order), and greedy tokens are identical. The
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
from repro.models import hybrid as jhybrid
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import hybrid as thybrid
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model, greedy_token

ARCH = "zamba2-1.2b"
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


def test_smoke_config_exercises_groups_shared_block_and_window(pair):
    _, _, _, tm, tp = pair
    cfg = tm.cfg
    assert (cfg.n_layers, cfg.hybrid_attn_every, cfg.sliding_window, cfg.ssm.chunk) == (2, 2, 64, 32)
    assert thybrid._group_sizes(cfg) == [2] and thybrid._n_attn(cfg) == 1
    assert len(tp.mamba) == 2 and tp.shared_attn is not None


def test_mamba_block_and_step_match(pair):
    jcfg, _, jp, tm, tp = pair
    x = np.random.RandomState(3).randn(2, 40, jcfg.d_model).astype(np.float32)
    jpl = jax.tree_util.tree_map(lambda t: t[0], jp["mamba"])
    jy, (jh, jctx) = jhybrid.mamba_block(jcfg, jpl, jnp.asarray(x))
    ty, (th, tctx) = thybrid.mamba_block(tm.cfg, tp.mamba[0], torch.tensor(x))
    _close(ty, jy)
    _close(th, jh)
    _close(tctx, jctx)
    xs = np.random.RandomState(4).randn(2, 1, jcfg.d_model).astype(np.float32)
    jy, (jh, jctx) = jhybrid.mamba_block_step(jcfg, jpl, jnp.asarray(xs), (jh, jctx))
    ty, (th, tctx) = thybrid.mamba_block_step(tm.cfg, tp.mamba[0], torch.tensor(xs), (th, tctx))
    _close(ty, jy)
    _close(th, jh)
    _close(tctx, jctx)


def test_forward_logits_match(pair):
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 2, 45, 8)
    jlog, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    tlog, taux = tm.forward(tp, {"tokens": torch.tensor(tokens)})
    _close(tlog, jlog)
    assert float(taux) == 0.0


def _prefill_and_decode(jm, jp, tm, tp, tokens, max_len, T=8):
    """Prefill, then T greedy decode steps, each side on its own tokens;
    returns the caches after prefill and both sides' logits."""
    B = tokens.shape[0]
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(B, max_len))
    tcache = tm.init_cache(B, max_len)
    tlog, _ = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, tcache)
    after = ({k: np.asarray(v) for k, v in jcache.items()}, {k: v.clone() for k, v in tcache.items()})
    logits = [(tlog, jlog)]
    jtok, ttok = jnp.asarray(tokens[:, -1:]), torch.tensor(tokens[:, -1:])
    for _ in range(T):
        jlog, jcache = jm.decode_step(jp, jcache, jtok)
        tlog, tcache = tm.decode_step(tp, tcache, ttok)
        logits.append((tlog, jlog))
        jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), greedy_token(tlog)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return after, logits, (tcache, jcache)


@pytest.mark.parametrize("S,max_len", [(29, 48), (80, 96)], ids=["short", "past-the-window"])
def test_prefill_state_and_decode_steps_match(pair, S, max_len):
    """S=80 with max_len 96: the shared block's ring holds the window's 64
    rows, rolled so that slot = position % 64, and decode writes into it."""
    jcfg, jm, jp, tm, tp = pair
    tokens = _tokens(jcfg.vocab, 2, S, 9)
    (jc, tc), logits, (tfinal, jfinal) = _prefill_and_decode(jm, jp, tm, tp, tokens, max_len)
    assert tc["attn_k"].shape[3] == min(max_len, 64) == jc["attn_k"].shape[3]
    for name in ("h", "conv", "attn_k", "attn_v"):
        _close(tc[name], jc[name])
    assert tc["lengths"].tolist() == jc["lengths"].tolist() == [S, S]
    for t, j in logits:
        _close(t, j)
    for name in ("h", "conv", "attn_k", "attn_v", "lengths"):
        _close(tfinal[name], jfinal[name])


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


def test_prefill_ignores_the_state_a_reused_cache_holds(pair):
    """zamba2's prefill reads no SSD state or conv context: a cache full of
    noise gives what a fresh one gives."""
    jcfg, _, _, tm, tp = pair
    tokens = torch.tensor(_tokens(jcfg.vocab, 1, 30, 12))
    fresh = tm.init_cache(1, 64)
    want, _ = tm.prefill(tp, {"tokens": tokens}, fresh)
    dirty = tm.init_cache(1, 64)
    gen = torch.Generator().manual_seed(0)
    for name in ("h", "conv", "attn_k", "attn_v"):
        dirty[name].copy_(100 * torch.randn(dirty[name].shape, generator=gen))
    dirty["lengths"].fill_(63)
    got, _ = tm.prefill(tp, {"tokens": tokens}, dirty)
    assert torch.equal(got, want)
    for name in ("h", "conv", "lengths"):
        assert torch.equal(dirty[name], fresh[name])
    assert torch.equal(dirty["attn_k"][:, :, :, :30], fresh["attn_k"][:, :, :, :30])


def test_model_on_cpu_goes_through_the_plain_attention(pair):
    _, _, _, tm, tp = pair
    ops.reset_counters()
    cache = tm.init_cache(1, 32)
    tm.prefill(tp, {"tokens": torch.arange(5, dtype=torch.int32)[None]}, cache)
    tm.decode_tokens(tp, cache, torch.tensor([[4]], dtype=torch.int32), 3)
    n = thybrid._n_attn(tm.cfg)
    assert ops.plain == ops.counts(flash_attention=n, decode_attention=3 * n,
                                   ssd_chunked=tm.cfg.n_layers)
    assert sum(ops.launches.values()) == 0
    ops.reset_counters()


def test_converter_refuses_a_tree_of_another_family(pair):
    _, _, jp, tm, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jp)
    xl = jax_build_model(jax_smoke_config("xlstm-1.3b")).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="xLSTM model, the model is a hybrid"):
        load_jax_params(tm.init(0), jax.tree_util.tree_map(np.asarray, xl))
    dense = build_model(get_smoke_config("llama3.2-1b"), device="cpu").init(0)
    with pytest.raises(ValueError, match="hybrid .* model, the model is a decoder-only"):
        load_jax_params(dense, tree)


def test_init_is_seeded_with_the_reference_scales():
    cfg = get_smoke_config(ARCH)
    m = build_model(cfg, device="cpu")
    a, b, c = m.init(0), m.init(0), m.init(1)
    assert torch.equal(a.mamba[1].w_in, b.mamba[1].w_in)
    assert not torch.equal(a.mamba[1].w_in, c.mamba[1].w_in)
    assert float(a.mamba[0].w_in.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(a.mamba[0].conv_w.std()) == pytest.approx(0.5, rel=0.1)
    H = a.mamba[0].A_log.shape[0]
    torch.testing.assert_close(torch.exp(a.mamba[0].A_log), torch.linspace(1.0, 16.0, H))
    assert a.mamba[0].A_log.dtype == torch.float32 and torch.all(a.mamba[0].D == 1)
    assert float(a.shared_attn.attn.wq.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)


def test_full_width_config_is_zamba2_1_2b():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (38, 2048, 32, 32, 64)
    assert (cfg.sliding_window, cfg.hybrid_attn_every, cfg.ssm.d_state, cfg.ssm.chunk) == (4096, 6, 64, 256)
    assert thybrid._group_sizes(cfg) == [6, 6, 6, 6, 6, 6, 2] and thybrid._n_attn(cfg) == 6
    assert thybrid._dims(cfg) == (4096, 64, 64, 64)
    assert cfg.torch_dtype == torch.bfloat16
