"""The port's dense model against ``repro.models`` on shared weights.

Weights are initialised by JAX and carried over with ``load_jax_params``;
inputs are made from a seed with numpy. Everything is f32 on the CPU (the
smoke configs are f32), so logits agree to rtol/atol 1e-4 — the two sides
differ only in summation order — and greedy tokens are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama3.2-1b", "qwen3-0.6b"]


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


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


def test_rms_norm_rope_swiglu_match():
    x = _np((2, 5, 4, 64), 0)
    w = _np((64,), 1)
    _close(tlayers.rms_norm(torch.tensor(x), torch.tensor(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.tile(np.arange(5, dtype=np.int32)[None] + 3, (2, 1))
    _close(tlayers.rope(torch.tensor(x), torch.tensor(pos), 500_000.0),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0))
    h = _np((2, 5, 32), 2)
    wg, wu, wd = _np((32, 48), 3, 0.2), _np((32, 48), 4, 0.2), _np((48, 32), 5, 0.2)
    _close(tlayers.swiglu(*map(torch.tensor, (h, wg, wu, wd))),
           jlayers.swiglu(*map(jnp.asarray, (h, wg, wu, wd))))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_prefill_and_decode_attention_match(qk_norm):
    d, H, K, hd, S, B = 64, 4, 2, 32, 9, 2
    jp = jattn.init_attention(jax.random.PRNGKey(3), d, H, K, hd, qk_norm, jnp.float32)
    tp = tattn.Attention(d, H, K, hd, qk_norm, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for f in jattn.AttnParams._fields:
            if getattr(jp, f) is not None:
                getattr(tp, f).copy_(torch.tensor(np.asarray(getattr(jp, f))))
    x = _np((B, S, d), 4)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    jy, (jk, jv) = jattn.prefill_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                           rope_theta=1e4, eps=1e-5)
    ty, (tk, tv) = tattn.prefill_attention(tp, torch.tensor(x), torch.tensor(pos),
                                           rope_theta=1e4, eps=1e-5)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)
    # one decode step into a cache of 16 holding the 9 prefilled rows
    cache_k, cache_v = np.zeros((B, K, 16, hd), np.float32), np.zeros((B, K, 16, hd), np.float32)
    cache_k[:, :, :S], cache_v[:, :, :S] = np.asarray(jk), np.asarray(jv)
    lengths = np.array([S, S - 3], np.int32)
    xn = _np((B, 1, d), 5)
    jy, jkc, jvc = jattn.decode_attention_step(
        jp, jnp.asarray(xn), jnp.asarray(cache_k), jnp.asarray(cache_v),
        jnp.asarray(lengths), rope_theta=1e4, eps=1e-5)
    tkc, tvc = torch.tensor(cache_k), torch.tensor(cache_v)
    ty = tattn.decode_attention_step(
        tp, torch.tensor(xn), tkc, tvc, torch.tensor(lengths), rope_theta=1e4, eps=1e-5)
    _close(ty, jy)
    _close(tkc, jkc)  # the in-place row write matches the scatter write
    _close(tvc, jvc)


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
    assert tcache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()
    tok = tokens[:, -1:]
    jlog, jcache2 = jm.decode_step(jp, jcache, jnp.asarray(tok))
    tlog, _ = tm.decode_step(tp, tcache, torch.tensor(tok))
    _close(tlog, jlog)
    _close(tcache["v"], jcache2["v"])
    # the fixed-shape greedy loop against the lax.scan one, from the same state
    jtoks, jcache3 = jm.decode_tokens(jp, jcache2, jnp.asarray(tok), T)
    ttoks, tcache3 = tm.decode_tokens(tp, tcache, torch.tensor(tok), T)
    assert ttoks.dtype == torch.int32 and tuple(ttoks.shape) == (B, T)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tcache3["k"], jcache3["k"])
    assert tcache3["lengths"].tolist() == np.asarray(jcache3["lengths"]).tolist()


def test_forward_logits_match(pair):
    jcfg, jm, jp, tm, tp = pair
    tokens = np.random.RandomState(8).randint(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jlog, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    tlog, taux = tm.forward(tp, {"tokens": torch.tensor(tokens)})
    _close(tlog, jlog)
    _close(taux, jaux)  # 0 for a dense FFN, as in repro


def test_model_on_cpu_goes_through_the_plain_versions(pair):
    _, _, _, tm, tp = pair
    ops.reset_counters()
    cache = tm.init_cache(1, 16)
    tm.prefill(tp, {"tokens": torch.arange(5, dtype=torch.int32)[None]}, cache)
    tm.decode_tokens(tp, cache, torch.tensor([[4]], dtype=torch.int32), 3)
    n = tm.cfg.n_layers
    assert ops.plain == ops.counts(flash_attention=n, decode_attention=3 * n)
    assert sum(ops.launches.values()) == 0
    ops.reset_counters()


def test_init_is_seeded_with_the_reference_scales():
    cfg = get_smoke_config("llama3.2-1b")
    m = build_model(cfg, device="cpu")
    a, b, c = m.init(0), m.init(0), m.init(1)
    assert torch.equal(a.layers[1].attn.wq, b.layers[1].attn.wq)
    assert not torch.equal(a.layers[1].attn.wq, c.layers[1].attn.wq)
    assert a.unembed is None  # tied embeddings
    assert float(a.embed.std()) == pytest.approx(1.0, rel=0.05)
    assert float(a.layers[0].attn.wq.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(a.layers[0].mlp.w_down.std()) == pytest.approx(cfg.d_ff**-0.5, rel=0.05)
    assert torch.all(a.final_norm == 1)


def test_prompt_longer_than_the_cache_raises():
    """A known difference, pinned: with no sliding window, ``repro``'s
    prefill returns a cache grown to the prompt's length, whose next decode
    step then overwrites the last prompt row (``dynamic_update_slice``
    clamps the write); the port refuses the prompt instead."""
    jcfg = jax_smoke_config("llama3.2-1b")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config("llama3.2-1b"), device="cpu")
    tp = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
    tokens = np.random.RandomState(9).randint(0, jcfg.vocab, size=(1, 12)).astype(np.int32)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(1, 8))
    assert np.asarray(jcache["k"]).shape[3] == 12  # the reference grew the cache
    cache = tm.init_cache(1, 8)
    with pytest.raises(ValueError, match="prompt of 12 tokens is longer than the cache's 8 rows"):
        tm.prefill(tp, {"tokens": torch.tensor(tokens)}, cache)
    assert not cache["k"].any() and cache["lengths"].tolist() == [0]  # nothing written


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_families_build_and_init(arch):
    cfg = get_smoke_config(arch)
    m = build_model(cfg, device="cpu")
    p = m.init(0)
    assert torch.equal(p.layers[1].mlp.w_up, m.init(0).layers[1].mlp.w_up)
    mlp, moe = p.layers[0].mlp, cfg.moe
    assert mlp.router.dtype == torch.float32 and mlp.w_gate.dtype == cfg.torch_dtype
    assert tuple(mlp.router.shape) == (cfg.d_model, moe.n_experts)
    assert tuple(mlp.w_down.shape) == (moe.n_experts, moe.d_expert, cfg.d_model)
    assert (mlp.shared is None) == (moe.n_shared == 0)
    assert float(mlp.w_gate.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(mlp.w_down.std()) == pytest.approx(moe.d_expert**-0.5, rel=0.05)
    if mlp.shared is not None:  # init_moe's d_e^-0.5, not (n_shared * d_e)^-0.5
        assert float(mlp.shared.w_down.std()) == pytest.approx(moe.d_expert**-0.5, rel=0.05)
    logits, aux = m.forward(p, {"tokens": torch.arange(7, dtype=torch.int32)[None]})
    assert logits.shape == (1, 7, cfg.vocab) and torch.isfinite(logits).all()
    assert aux.shape == () and float(aux) > 0.0


def test_full_width_config_is_llama_1b():
    cfg = get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (16, 2048, 32, 8, 64)
    assert cfg.torch_dtype == torch.bfloat16
    assert dataclasses.replace(cfg, dtype="float32").torch_dtype == torch.float32
