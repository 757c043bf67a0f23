"""The port's encoder-decoder family (whisper-small) against
``repro.models.encdec`` on shared weights.

Weights are initialised by JAX and carried over with ``load_jax_params``;
frames and tokens are made from a seed with numpy. The smoke config (2 + 2
layers, d_model 256, 4 heads, 64 frames) is f32 on the CPU, so everything
agrees to rtol/atol 1e-4, as ``test_torch_model.py`` holds the dense family,
and greedy tokens are identical.

Served audio is all zeros (the stub frontend's output in both packages'
backends), which makes the encoder's output exactly 0; so the model tests run
on random frames as well as zeros, and only the random ones exercise the
encoder and cross-attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost as jcost
import repro.core.policy as jpol
import repro.serving.engine as jeng
import repro_torch.core.cost as tcost
import repro_torch.core.policy as tpol
import repro_torch.serving.engine as teng
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-small"


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, torch model, torch params)."""
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(ARCH), device="cpu")
    tp = load_jax_params(tm.init(1), _tree(jp))
    return jcfg, jm, jp, tm, tp


def _frames(cfg, B, kind, seed=0):
    shape = (B, cfg.encoder_frames, cfg.d_model)
    return np.zeros(shape, np.float32) if kind == "zero" else _np(shape, seed)


# ---------------------------------------------------------------------------
# attention: the modes the encoder-decoder calls
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_pair():
    d, H, K, hd = 64, 4, 2, 32
    jp = jattn.init_attention(jax.random.PRNGKey(5), d, H, K, hd, False, jnp.float32)
    tp = tattn.Attention(d, H, K, hd, False, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for f in ("wq", "wk", "wv", "wo"):
            getattr(tp, f).copy_(torch.tensor(np.asarray(getattr(jp, f))))
    return jp, tp


def test_bidirectional_prefill_attention_matches(attn_pair):
    jp, tp = attn_pair
    B, S = 2, 11
    x = _np((B, S, 64), 1)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jy, (jk, jv) = jattn.prefill_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                           rope_theta=1e4, eps=1e-5, causal=False)
    ty, (tk, tv) = tattn.prefill_attention(tp, torch.tensor(x), torch.tensor(pos),
                                           rope_theta=1e4, eps=1e-5, causal=False)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)
    causal, _ = tattn.prefill_attention(tp, torch.tensor(x), torch.tensor(pos),
                                        rope_theta=1e4, eps=1e-5)
    assert not torch.allclose(causal, ty)  # the mask is really off


def test_cross_attention_without_rope_matches(attn_pair):
    jp, tp = attn_pair
    B, S, S_kv = 2, 5, 13
    x = _np((B, S, 64), 2)
    k, v = _np((B, S_kv, 2, 32), 3), _np((B, S_kv, 2, 32), 4)
    pos = np.tile(np.arange(S, dtype=np.int32)[None] + 7, (B, 1))
    jy, (jk, _) = jattn.prefill_attention(
        jp, jnp.asarray(x), jnp.asarray(pos), rope_theta=1e4, eps=1e-5, causal=False,
        cross_kv=(jnp.asarray(k), jnp.asarray(v)), use_rope=False)
    ty, (tk, _) = tattn.prefill_attention(
        tp, torch.tensor(x), torch.tensor(pos), rope_theta=1e4, eps=1e-5, causal=False,
        cross_kv=(torch.tensor(k), torch.tensor(v)), use_rope=False)
    _close(ty, jy)
    _close(tk, jk)  # the given keys, in (B, K, S_kv, hd) layout


def test_decode_step_without_cache_update_matches_and_writes_nothing(attn_pair):
    jp, tp = attn_pair
    B, S = 2, 16
    ck, cv = _np((B, 2, S, 32), 5), _np((B, 2, S, 32), 6)
    x = _np((B, 1, 64), 7)
    lengths = np.array([S, 9], np.int32)
    jy, jkc, _ = jattn.decode_attention_step(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths),
        rope_theta=1e4, eps=1e-5, use_rope=False, update_cache=False)
    tkc, tvc = torch.tensor(ck), torch.tensor(cv)
    before = (tkc.clone(), tvc.clone())
    ty = tattn.decode_attention_step(
        tp, torch.tensor(x), tkc, tvc, torch.tensor(lengths), rope_theta=1e4, eps=1e-5,
        use_rope=False, update_cache=False)
    _close(ty, jy)
    assert torch.equal(tkc, before[0]) and torch.equal(tvc, before[1])
    np.testing.assert_array_equal(np.asarray(jkc), ck)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_encode_matches_on_random_frames(pair):
    jcfg, _, jp, tm, tp = pair
    frames = _frames(jcfg, 2, "random")
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames), remat=False)
    got = tencdec.encode(tm.cfg, tp, torch.tensor(frames))
    _close(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 0.5


def test_prefill_stores_the_cross_kv(pair):
    jcfg, jm, jp, tm, tp = pair
    frames = _frames(jcfg, 2, "random", seed=1)
    _, jcache = jm.prefill(jp, {"frames": jnp.asarray(frames)}, jm.init_cache(2, 16))
    cache = tm.init_cache(2, 16)
    cache["lengths"].fill_(5)  # a reused cache: prefill starts the decoder empty
    logits, out = tm.prefill(tp, {"frames": torch.tensor(frames)}, cache)
    assert logits is None and out is cache
    assert tuple(cache["cross_k"].shape) == (tm.cfg.n_layers, 2, tm.cfg.n_kv_heads,
                                             tm.cfg.encoder_frames, tm.cfg.head_dim)
    _close(cache["cross_k"], jcache["cross_k"])
    _close(cache["cross_v"], jcache["cross_v"])
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist() == [0, 0]


@pytest.mark.parametrize("kind", ["random", "zero"])
def test_decode_logits_and_greedy_tokens_match(pair, kind):
    """prefill, one decode_step, then 8 greedy steps through decode_tokens,
    twice on the static cache (the second request must not see the first's
    rows)."""
    jcfg, jm, jp, tm, tp = pair
    B, T = 2, 8
    tok = np.array([[1], [4]], np.int32)
    static = tm.static_cache(B, 16)
    for seed in (2, 3):
        frames = _frames(jcfg, B, kind, seed=seed)
        _, jcache = jm.prefill_jit(jp, {"frames": jnp.asarray(frames)}, jm.init_cache(B, 16))
        _, cache = tm.prefill_jit(tp, {"frames": torch.tensor(frames)}, static)
        jlog, jstep = jm.decode_step(jp, jcache, jnp.asarray(tok))
        tlog, cache = tm.decode_step(tp, cache, torch.tensor(tok))
        _close(tlog, jlog)
        _close(cache["k"][:, :, :, :1], jstep["k"][:, :, :, :1])
        jtoks, jcache = jm.decode_tokens(jp, jstep, jnp.asarray(tok), T)
        ttoks, cache = tm.decode_tokens(tp, cache, torch.tensor(tok), T)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        for name in ("k", "v"):
            _close(cache[name][:, :, :, :T + 1], np.asarray(jcache[name])[:, :, :, :T + 1])
        assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist() == [T + 1] * B


def test_forward_logits_match(pair):
    jcfg, jm, jp, tm, tp = pair
    frames = _frames(jcfg, 2, "random", seed=4)
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    jlog, jaux = jm.forward(jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    tlog, taux = tm.forward(tp, {"frames": torch.tensor(frames), "tokens": torch.tensor(tokens)})
    _close(tlog, jlog)
    assert float(taux) == float(jaux) == 0.0


def test_model_on_cpu_goes_through_the_plain_versions(pair):
    jcfg, _, _, tm, tp = pair
    ops.reset_counters()
    cache = tm.init_cache(1, 16)
    tm.prefill(tp, {"frames": torch.zeros((1, jcfg.encoder_frames, jcfg.d_model))}, cache)
    tm.decode_tokens(tp, cache, torch.tensor([[1]], dtype=torch.int32), 3)
    assert ops.plain == ops.counts(flash_attention=jcfg.n_encoder_layers,
                                   decode_attention=3 * 2 * jcfg.n_layers)
    assert sum(ops.launches.values()) == 0
    ops.reset_counters()


def test_load_jax_params_refuses_the_other_family(pair):
    _, _, jp, tm, _ = pair
    llama_j = jax_build_model(jax_smoke_config("llama3.2-1b")).init(jax.random.PRNGKey(0))
    llama_t = build_model(get_smoke_config("llama3.2-1b"), device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        load_jax_params(tm.init(0), _tree(llama_j))
    with pytest.raises(ValueError, match="encoder-decoder"):
        load_jax_params(llama_t.init(0), _tree(jp))


def test_init_is_seeded_with_the_reference_scales():
    cfg = get_smoke_config(ARCH)
    m = build_model(cfg, device="cpu")
    a, b = m.init(0), m.init(0)
    assert isinstance(a, tencdec.EncDec)
    assert torch.equal(a.decoder[1].cross_attn.wk, b.decoder[1].cross_attn.wk)
    assert len(a.encoder) == cfg.n_encoder_layers and len(a.decoder) == cfg.n_layers
    assert float(a.embed.std()) == pytest.approx(1.0, rel=0.05)
    assert float(a.unembed.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(a.encoder[0].attn.wq.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(a.decoder[0].mlp.w_down.std()) == pytest.approx(cfg.d_ff**-0.5, rel=0.05)
    assert all(torch.all(n == 1) for n in (a.enc_norm, a.final_norm, a.decoder[0].ln_x))


def test_full_width_config_is_whisper_small():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.encoder_frames) == (
        "encdec", 12, 12, 768, 12, 12, 64, 3072, 51865, 1500)
    assert cfg.torch_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# served behind the gate
# ---------------------------------------------------------------------------


def _requests(cls, vocab, n=6, prompt_len=4, new_tokens=5):
    rs = np.random.RandomState(13)
    return [cls(prompt=rs.randint(0, vocab, size=prompt_len).astype(np.int32),
                max_new_tokens=new_tokens, request_id=i) for i in range(n)]


@pytest.mark.parametrize("decode_mode,new_tokens", [("jit", 5), ("eager", 2)])
def test_served_whisper_matches_reference_exactly(decode_mode, new_tokens):
    """Gate decisions, timings, costs and tokens of whisper served through
    ``ModelServingBackend`` (inside the serving engine) equal ``repro``'s on
    one seed, as ``test_torch_serving.py`` holds llama. (``repro``'s eager
    loop runs each step un-jitted, so that case decodes fewer tokens.)"""
    kw = dict(seed=5, max_pool=3, decode_mode=decode_mode)
    je = jeng.MinosServingEngine(jax_smoke_config(ARCH),
                                 jpol.MinosPolicy(elysium_threshold=180.0, max_retries=5),
                                 jcost.Pricing.tpu_chip_seconds(4), **kw)
    te = teng.MinosServingEngine(get_smoke_config(ARCH),
                                 tpol.MinosPolicy(elysium_threshold=180.0, max_retries=5),
                                 tcost.Pricing.tpu_chip_seconds(4), device="cpu", **kw)
    load_jax_params(te.params, _tree(je.params))
    jres = je.serve(_requests(jeng.ServeRequest, je.cfg.vocab, new_tokens=new_tokens))
    tres = te.serve(_requests(teng.ServeRequest, je.cfg.vocab, new_tokens=new_tokens))
    assert te.instances_started == je.instances_started
    assert te.instances_terminated == je.instances_terminated > 0
    assert te.benchmark_observations == je.benchmark_observations
    assert te.warm_pool_speeds == je.warm_pool_speeds
    assert te.cost.total == je.cost.total
    assert te.jit_stats == je.jit_stats
    assert len(tres) == len(jres)
    for a, b in zip(jres, tres):
        assert (b.request_id, b.retries, b.sim_duration_ms, b.latency_ms, b.replica_speed) == (
            a.request_id, a.retries, a.sim_duration_ms, a.latency_ms, a.replica_speed)
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert b.tokens.dtype == np.int32
    # the encdec requeue penalty re-encodes the audio window
    assert te.backend.requeue_penalty_ms(None) == je.backend.requeue_penalty_ms(None)
