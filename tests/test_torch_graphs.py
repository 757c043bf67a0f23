"""The port's compiled serving surface on the CPU: ``Model.static_cache``,
``Model.prefill_jit`` and ``Model.decode_tokens`` against ``repro``'s jitted
pair on shared weights, the backend's bucketed path through the reused static
cache, weights swapped between calls, and the launch counters a CUDA graph
records and replays.

On the CPU nothing is captured (``Model.graph_stats`` stays at zero) but the
bucketed path runs on the same static caches as on the card, so what these
tests show about stale rows and swapped weights holds there too; the graphs
themselves are tested in ``test_torch_graphs_cuda.py``. f32 smoke configs,
tolerances as ``test_torch_model.py`` (rtol = atol = 1e-4: the two packages
differ only in summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import _build
from repro_torch.launch import shardings
from repro_torch.models import attention
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model
from repro_torch.serving.backend import ModelServingBackend, ServeRequest, _bucket

TOL = dict(rtol=1e-4, atol=1e-4)
NO_GRAPHS = {"captures": 0, "replays": 0, "dropped": 0}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3-mini-3.8b"])
def test_compiled_surface_matches_reference(arch):
    """prefill_jit then decode_tokens on the static cache, twice (a longer
    prompt, then a shorter one in the same cache), against jax's jitted pair
    on a fresh cache each time."""
    jm = jax_build_model(jax_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = build_model(get_smoke_config(arch), device="cpu")
    tp = load_jax_params(tm.init(0), jax.tree_util.tree_map(np.asarray, jp))
    rs = np.random.RandomState(4)
    cache_len, T = 32, 8
    static = tm.static_cache(1, cache_len)
    for S in (20, 11):
        prompt = rs.randint(0, tm.cfg.vocab, size=(1, S)).astype(np.int32)
        jlogits, jcache = jm.prefill_jit(jp, {"tokens": jnp.asarray(prompt)},
                                         jm.init_cache(1, cache_len))
        cache = tm.static_cache(1, cache_len)
        assert cache is static
        tlogits, cache = tm.prefill_jit(tp, {"tokens": torch.tensor(prompt)}, cache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        tok = prompt[:, -1:]
        jtoks, jcache = jm.decode_tokens(jp, jcache, jnp.asarray(tok), T)
        ttoks, cache = tm.decode_tokens(tp, cache, torch.tensor(tok), T)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        assert ttoks.dtype == torch.int32 and ttoks.shape == (1, T)
        # the rows this request wrote; (L, B, K, S, hd) in both packages
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name][:, :, :, :S + T].numpy(),
                                       np.asarray(jcache[name])[:, :, :, :S + T], **TOL)
        np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    assert tm.graph_stats == NO_GRAPHS


def test_static_cache_is_per_bucket():
    m = build_model(get_smoke_config("llama3.2-1b"), device="cpu")
    a = m.static_cache(1, 32)
    assert m.static_cache(1, 32) is a
    assert m.static_cache(2, 32) is not a and m.static_cache(1, 64) is not a
    assert a["k"].shape == (2, 1, 2, 32, 64) and a["lengths"].dtype == torch.int32


@pytest.fixture(scope="module")
def untied_backend():
    # phi3's smoke config has its own unembedding, so its greedy tokens move
    # with the weights (tied random embeddings repeat the last prompt token)
    return ModelServingBackend(get_smoke_config("phi3-mini-3.8b"), seed=0, device="cpu")


def test_prompts_sharing_a_bucket_never_read_stale_rows(untied_backend):
    """A long prompt, then the cache filled with noise, then a shorter prompt
    in the same (B, cache_len) bucket: its tokens are a fresh cache's."""
    be = untied_backend
    rs = np.random.RandomState(9)
    long = ServeRequest(prompt=rs.randint(0, be.cfg.vocab, size=20).astype(np.int32),
                        max_new_tokens=6)
    short = ServeRequest(prompt=rs.randint(0, be.cfg.vocab, size=11).astype(np.int32),
                         max_new_tokens=6)
    Tb = _bucket(6, base=be.decode_bucket)
    cache_len = _bucket(20 + Tb, base=be.decode_bucket)
    assert cache_len == _bucket(11 + Tb, base=be.decode_bucket)

    def fresh(req):
        m, p = be.model, be.params
        cache = m.init_cache(1, cache_len)
        prompt = torch.tensor(req.prompt)[None]
        m.prefill(p, {"tokens": prompt}, cache)
        return m.decode_tokens(p, cache, prompt[:, -1:], Tb)[0][0, :req.max_new_tokens].numpy()

    np.testing.assert_array_equal(be.run_model(long), fresh(long))
    static = be.model.static_cache(1, cache_len)
    gen = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        static[name].copy_(100 * torch.randn(static[name].shape, generator=gen))
    static["lengths"].fill_(cache_len - 1)
    got = be.run_model(short)
    assert be.model.static_cache(1, cache_len) is static
    np.testing.assert_array_equal(got, fresh(short))
    np.testing.assert_array_equal(got, be.run_model(short, mode="eager"))


def test_swapped_weights_change_the_tokens(untied_backend):
    be = untied_backend
    req = ServeRequest(prompt=np.arange(3, 12, dtype=np.int32), max_new_tokens=8)
    first = be.run_model(req)
    other = ModelServingBackend(be.cfg, seed=1, device="cpu")
    want = other.run_model(req)
    assert not np.array_equal(first, want)  # the seeds give other tokens
    old = be.params
    try:
        be.params = other.params
        np.testing.assert_array_equal(be.run_model(req), want)
    finally:
        be.params = old
    np.testing.assert_array_equal(be.run_model(req), first)


def test_recording_restores_counters_and_replays_count_what_was_recorded():
    _build.reset_counters()
    _build.launches["matmul"] = 5
    with _build.recording() as recorded:
        _build.launches["decode_attention"] += 16
        _build.launches["flash_attention"] += 2
        _build.plain["matmul"] += 1
        _build.form_launches["decode_attention_lse"] += 4  # K3's log-sum-exp form
    assert recorded == {
        "launches": _build.counts(flash_attention=2, decode_attention=16),
        "plain": _build.counts(matmul=1),
        "form_launches": {"decode_attention_lse": 4},
        "form_plain": {"decode_attention_lse": 0},
    }
    assert _build.launches == _build.counts(matmul=5)
    assert sum(_build.plain.values()) == 0 and sum(_build.form_launches.values()) == 0
    for _ in range(3):
        _build.replayed(recorded)
    assert _build.launches == _build.counts(matmul=5, flash_attention=6, decode_attention=48)
    assert _build.plain == _build.counts(matmul=3)
    assert _build.form_launches == {"decode_attention_lse": 12}
    _build.reset_counters()


def test_recording_restores_counters_when_the_capture_raises():
    _build.reset_counters()
    with pytest.raises(RuntimeError, match="capture failed"):
        with _build.recording():
            _build.launches["decode_attention"] += 16
            raise RuntimeError("capture failed")
    assert sum(_build.launches.values()) == 0


def test_graph_key_names_the_placement(tmp_path):
    """On a one-rank gloo mesh, llama placed for the length-sharded decode
    keeps every weight tensor (a block of the whole shape is not replaced),
    so the weights cannot tell its graphs from the unplaced model's: the key
    does (mesh shape, each attention's cache dim, the decode mode), over the
    whole cache's rows, and the static cache is a placed one of its own. The
    greedy loop on it (eager here) gives the unplaced model's tokens."""
    cfg = get_smoke_config("llama3.2-1b")
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    rows, T = 32, 6
    prompt = torch.tensor(np.random.RandomState(5).randint(0, cfg.vocab, (1, 11)),
                          dtype=torch.int32)

    def greedy(params_, cache):
        logits, cache = m.prefill_jit(params_, {"tokens": prompt}, cache)
        return m.decode_tokens(params_, cache, prompt[:, -1:], T)[0]

    key = m.graph_key("decode", params, m.init_cache(1, rows), 1, T)
    assert key == ("decode", 1, rows, T)
    want = greedy(params, m.static_cache(1, rows))
    weights = [p.data_ptr() for p in params.parameters()]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    knobs = (attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = "shard_map", True
        with sh.use_mesh(mesh, shardings.make_rules(cfg, mesh)):
            shardings.place_params(params, cfg, mesh)
            assert [p.data_ptr() for p in params.parameters()] == weights
            cache, _ = shardings.place_cache(m.init_cache(1, rows), cfg, mesh)
            placed = m.graph_key("decode", params, cache, 1, T)
            assert placed[:4] == key and placed != key
            assert placed[4] == (("data", "model"), (1, 1), (2,) * cfg.n_layers, "shard_map")
            static = m.static_cache(1, rows, params)
            assert static is not m.static_cache(1, rows)
            assert static is m.static_cache(1, rows, params)
            _build.reset_counters()
            got = greedy(params, static)
            assert _build.form_plain["decode_attention_lse"] == cfg.n_layers * T
            assert _build.plain["decode_attention"] == 0
    finally:
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = knobs
        dist.destroy_process_group()
        _build.reset_counters()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
