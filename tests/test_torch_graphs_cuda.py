"""The compiled serving surface on the card: ``Model.prefill_jit`` and
``Model.decode_tokens`` as CUDA graphs.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py

The captured path runs the same kernels on the same shapes as the eager one,
so tokens must be equal and the K/V rows the captured loop writes equal to
the eager loop's, bitwise or within the bf16 decode tolerance 2e-2 (f32
2e-3), as ``test_torch_kernels_cuda.py`` holds the decode kernel.
"""
from _torch_cpu import child_env
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.models.model import build_model, greedy_token
from repro_torch.serving.backend import ModelServingBackend, ServeRequest

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-3, "bfloat16": 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _model(dtype="bfloat16"):
    return build_model(dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype=dtype))


def _prompt(S, vocab, seed):
    return torch.tensor(np.random.RandomState(seed).randint(0, vocab, size=(1, S)),
                        dtype=torch.int32, device="cuda")


def _close(got, want, dtype, what):
    """Within TOL[dtype] (rtol = atol); prints the largest |difference|."""
    diff = (got.float() - want.float()).abs().max().item()
    print(f"captured vs eager {what}, {dtype}: max |diff| {diff:.3e}")
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def _eager(m, params, prompt, cache_len, n_steps):
    """prefill and the greedy loop, step by step, on a fresh cache."""
    cache = m.init_cache(prompt.shape[0], cache_len)
    logits, _ = m.prefill(params, {"tokens": prompt}, cache)
    tok, toks = prompt[:, -1:], []
    for _ in range(n_steps):
        step, _ = m.decode_step(params, cache, tok)
        tok = greedy_token(step)
        toks.append(tok)
    return logits, torch.cat(toks, 1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_path_matches_eager_loop(dtype):
    m = _model(dtype)
    params = m.init(0)
    S, cache_len, T = 37, 64, 16
    prompt = _prompt(S, m.cfg.vocab, 1)
    cache = m.static_cache(1, cache_len)
    logits, _ = m.prefill_jit(params, {"tokens": prompt}, cache)
    toks, _ = m.decode_tokens(params, cache, prompt[:, -1:], T)
    torch.cuda.synchronize()
    want_logits, want_toks, want = _eager(m, params, prompt, cache_len, T)
    assert m.graph_stats == {"captures": 2, "replays": 2, "dropped": 0}
    assert toks.dtype == torch.int32 and toks.shape == (1, T)
    assert torch.equal(toks, want_toks)
    _close(logits, want_logits, dtype, "prefill logits")
    for n in ("k", "v"):
        _close(cache[n][:, :, :, :S + T], want[n][:, :, :, :S + T], dtype, f"{n} rows")
    assert torch.equal(cache["lengths"], want["lengths"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_captured_path_matches_eager_loop(arch):
    """The MoE FFN (top-k, then the decode kernel over the chosen experts)
    is captured with the rest of the decode loop: no host sync in it. The
    queue positions' kernel runs once a layer in the prefill, the MoE decode
    kernel once a layer in each decode step."""
    m = build_model(dataclasses.replace(get_smoke_config(arch), dtype="bfloat16"))
    params = m.init(0)
    L, S, cache_len, T = m.cfg.n_layers, 45, 64, 16
    prompt = _prompt(S, m.cfg.vocab, 6)
    cache = m.static_cache(1, cache_len)
    _build.reset_counters()
    logits, _ = m.prefill_jit(params, {"tokens": prompt}, cache)
    toks, _ = m.decode_tokens(params, cache, prompt[:, -1:], T)
    torch.cuda.synchronize()
    assert _build.launches == _build.counts(flash_attention=L, decode_attention=L * T,
                                            moe_positions=L, moe_decode=L * T)
    assert sum(_build.plain.values()) == 0
    want_logits, want_toks, want = _eager(m, params, prompt, cache_len, T)
    assert m.graph_stats == {"captures": 2, "replays": 2, "dropped": 0}
    assert torch.equal(toks, want_toks)
    _close(logits, want_logits, "bfloat16", f"{arch} prefill logits")
    for n in ("k", "v"):
        _close(cache[n][:, :, :, :S + T], want[n][:, :, :, :S + T], "bfloat16", f"{arch} {n} rows")


def test_whisper_captured_path_matches_eager_and_counts_replays():
    """The encoder-decoder's prefill graph takes f32 frames and returns no
    output (the cross K/V it computes stay in the static cache); its decode
    graph runs K3 twice a layer a step, over the self cache and the cross
    cache. Random frames, so the encoder's output is not 0."""
    m = build_model(dataclasses.replace(get_smoke_config("whisper-small"), dtype="bfloat16"))
    params = m.init(0)
    cfg = m.cfg
    L, E, cache_len, T = cfg.n_layers, cfg.n_encoder_layers, 16, 8
    tok = torch.tensor([[3]], dtype=torch.int32, device="cuda")
    cache = m.static_cache(1, cache_len)
    for seed in (7, 8):  # a capture, then a replay on other frames
        frames = torch.tensor(np.random.RandomState(seed).randn(1, cfg.encoder_frames, cfg.d_model),
                              dtype=torch.float32, device="cuda")
        _build.reset_counters()
        out, _ = m.prefill_jit(params, {"frames": frames}, cache)
        toks, _ = m.decode_tokens(params, cache, tok, T)
        torch.cuda.synchronize()
        assert out is None
        assert _build.launches == _build.counts(flash_attention=E, decode_attention=2 * L * T)
        assert sum(_build.plain.values()) == 0
        want = m.init_cache(1, cache_len)
        m.prefill(params, {"frames": frames}, want)
        t, eager = tok, []
        for _ in range(T):
            t = greedy_token(m.decode_step(params, want, t)[0])
            eager.append(t)
        assert torch.equal(toks, torch.cat(eager, 1))
        for name in ("cross_k", "cross_v"):
            _close(cache[name], want[name], "bfloat16", f"whisper {name}")
        for name in ("k", "v"):
            _close(cache[name][:, :, :, :T], want[name][:, :, :, :T], "bfloat16", f"whisper {name} rows")
        assert torch.equal(cache["lengths"], want["lengths"])
    # a cache of the caller's own: every entry, the cross K/V too, is copied
    # into the static cache before a replay and back after it
    foreign = m.init_cache(1, cache_len)
    m.prefill_jit(params, {"frames": frames}, foreign)
    again, out = m.decode_tokens(params, foreign, tok, T)
    assert out is foreign and torch.equal(again, toks)
    for name in ("cross_k", "cross_v", "k", "v", "lengths"):
        assert torch.equal(foreign[name], cache[name]), name
    assert foreign["cross_k"].abs().max() > 0
    assert m.graph_stats == {"captures": 2, "replays": 6, "dropped": 0}


def _recurrent(arch, dtype="bfloat16"):
    m = build_model(dataclasses.replace(get_smoke_config(arch), dtype=dtype))
    return m, m.init(0)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_captured_path_matches_eager_loop(arch, dtype):
    """The recurrent families' prefill (the chunked scans, the sLSTM's loop
    over tokens) and decode loop (every state written in place) captured,
    against the eager path on a fresh cache: tokens equal, prefill logits
    and the final states within TOL[dtype] of their largest value. zamba2's
    prompt (80) is past its smoke window (64): K2 runs with the window and
    the ring is rolled; launches are exact and no plain call is made."""
    m, params = _recurrent(arch, dtype)
    cfg = m.cfg
    S, cache_len, T = 80, 96, 16
    prompt = _prompt(S, cfg.vocab, 11)
    cache = m.static_cache(1, cache_len)
    _build.reset_counters()
    logits, _ = m.prefill_jit(params, {"tokens": prompt}, cache)
    toks, _ = m.decode_tokens(params, cache, prompt[:, -1:], T)
    torch.cuda.synchronize()
    n_attn = cfg.n_layers // cfg.hybrid_attn_every if arch == "zamba2-1.2b" else 0
    n_ssd = cfg.n_layers if arch == "zamba2-1.2b" else 0  # one SSD call a Mamba2 layer
    assert _build.launches == _build.counts(flash_attention=n_attn, decode_attention=n_attn * T,
                                            ssd_chunked=n_ssd)
    assert sum(_build.plain.values()) == 0
    want_logits, want_toks, want = _eager(m, params, prompt, cache_len, T)
    assert m.graph_stats == {"captures": 2, "replays": 2, "dropped": 0}
    assert torch.equal(toks, want_toks)
    assert _rel(logits, want_logits) <= TOL[dtype]
    for name, t in want.items():
        if t.is_floating_point():
            assert _rel(cache[name], t) <= TOL[dtype], name
    assert torch.equal(cache["lengths"], want["lengths"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_backend_reuse_equals_a_fresh_cache_each(arch):
    """Back-to-back requests on the backend's one static cache give the
    tokens each gives alone from a fresh cache: the captured prefill starts
    every state from its initial value. xlstm's cache and graphs are keyed
    by batch (and prompt length), not by the cache-length bucket."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    be = ModelServingBackend(cfg, seed=0)
    rs = np.random.RandomState(5)
    reqs = [ServeRequest(prompt=rs.randint(0, cfg.vocab, size=s).astype(np.int32),
                         max_new_tokens=6) for s in (20, 13, 20, 60)]
    got = [be.run_model(r) for r in reqs]
    for r, toks in zip(reqs, got):
        prompt = torch.tensor(r.prompt, device="cuda")[None]
        cache_len = 32 if len(r.prompt) < 24 else 128
        want = _eager(be.model, be.params, prompt, cache_len, 8)[1]
        np.testing.assert_array_equal(toks, want[0, :6].cpu().numpy())
    caches = be.model.graphs.caches
    if arch == "xlstm-1.3b":  # one cache; 3 prompt shapes, 1 decode graph
        assert list(caches) == [(1, None)]
        assert be.model.graph_stats == {"captures": 4, "replays": 8, "dropped": 0}
    else:  # buckets 32 and 128, the second held as the smoke window's 64 rows:
        # 3 prefill graphs, 2 decode graphs
        assert sorted(caches) == [(1, 32), (1, 64)]
        assert be.model.graph_stats == {"captures": 5, "replays": 8, "dropped": 0}


def test_launch_counts_are_replays_times_what_was_captured():
    m = _model()
    params = m.init(0)
    L, T = m.cfg.n_layers, 8
    prompt = _prompt(20, m.cfg.vocab, 2)
    cache = m.static_cache(1, 32)
    _build.reset_counters()
    for n in range(1, 4):
        m.prefill_jit(params, {"tokens": prompt}, cache)
        m.decode_tokens(params, cache, prompt[:, -1:], T)
        assert _build.launches == _build.counts(flash_attention=n * L, decode_attention=n * L * T)
    assert sum(_build.plain.values()) == 0
    recorded = m.graphs.graphs[("decode", 1, 32, T)].recorded
    assert recorded["launches"]["decode_attention"] == L * T
    assert m.graph_stats == {"captures": 2, "replays": 6, "dropped": 0}


def test_swapped_weights_take_effect_after_capture():
    m = _model()
    a, b = m.init(0), m.init(1)
    prompt = _prompt(25, m.cfg.vocab, 3)
    cache = m.static_cache(1, 64)
    la, _ = m.prefill_jit(a, {"tokens": prompt}, cache)
    ta, _ = m.decode_tokens(a, cache, prompt[:, -1:], 8)
    lb, _ = m.prefill_jit(b, {"tokens": prompt}, cache)   # another module: recaptured
    tb, _ = m.decode_tokens(b, cache, prompt[:, -1:], 8)
    want_lb, want_tb, _ = _eager(m, b, prompt, 64, 8)
    assert not torch.equal(la, lb)
    _close(lb, want_lb, "bfloat16", "prefill logits, swapped weights")
    assert torch.equal(tb, want_tb)
    assert m.graph_stats["dropped"] == 2 and m.graph_stats["captures"] == 4
    # weights written in place are read by the graphs as they are
    with torch.no_grad():
        for pa, pb in zip(a.parameters(), b.parameters()):
            pa.copy_(pb)
    la2, _ = m.prefill_jit(a, {"tokens": prompt}, cache)  # a module again: recaptured
    _close(la2, want_lb, "bfloat16", "prefill logits, weights copied in")
    captures = m.graph_stats["captures"]
    with torch.no_grad():
        a.embed.mul_(2)
    la3, _ = m.prefill_jit(a, {"tokens": prompt}, cache)
    assert m.graph_stats["captures"] == captures  # same tensors: replayed
    want_la3, _ = m.prefill(a, {"tokens": prompt}, m.init_cache(1, 64))
    _close(la3, want_la3, "bfloat16", "prefill logits, weights scaled")
    assert not torch.equal(la3, la2)


def test_a_foreign_cache_is_copied_in_and_out():
    m = _model()
    params = m.init(0)
    prompt = _prompt(30, m.cfg.vocab, 4)
    cache = m.init_cache(1, 64)
    logits, out = m.prefill_jit(params, {"tokens": prompt}, cache)
    toks, out = m.decode_tokens(params, cache, prompt[:, -1:], 8)
    assert out is cache
    want_logits, want_toks, want = _eager(m, params, prompt, 64, 8)
    assert torch.equal(toks, want_toks)
    _close(logits, want_logits, "bfloat16", "prefill logits, foreign cache")
    for name in ("k", "v"):
        _close(cache[name], want[name], "bfloat16", f"{name} rows, foreign cache")
    assert torch.equal(cache["lengths"], want["lengths"])
    with pytest.raises(ValueError, match="does not match"):
        m.decode_tokens(params, m.init_cache(1, 32), prompt[:, -1:].expand(2, 1), 8)


def test_backend_serves_through_the_graphs():
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="bfloat16")
    be = ModelServingBackend(cfg, seed=0)
    rs = np.random.RandomState(5)
    reqs = [ServeRequest(prompt=rs.randint(0, cfg.vocab, size=s).astype(np.int32),
                         max_new_tokens=6) for s in (20, 20, 13)]
    got = [be.run_model(r) for r in reqs]
    # one cache bucket (32), two prompt shapes: 2 prefill graphs, 1 decode graph
    assert be.model.graph_stats == {"captures": 3, "replays": 6, "dropped": 0}
    assert be.jit_stats == {"jit_calls": 3, "eager_calls": 0, "bucket_compiles": 2}
    for r, toks in zip(reqs, got):
        prompt = torch.tensor(r.prompt, device="cuda")[None]
        want = _eager(be.model, be.params, prompt, 32, 8)[1]
        np.testing.assert_array_equal(toks, want[0, :6].cpu().numpy())


def test_first_decode_kernel_call_inside_a_capture_in_a_fresh_process():
    """A process whose first decode-attention call is recorded by a capture
    (the ticket array is zeroed before it), and a capture that meets a host
    sync raises."""
    code = """
import dataclasses, torch
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as k3
from repro_torch.models.graphs import GraphCache
from repro_torch.models.model import build_model, greedy_token
m = build_model(dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="bfloat16"))
params = m.init(0)
cache = m.static_cache(1, 64)
gen = torch.Generator(device="cuda").manual_seed(0)
for name in ("k", "v"):
    cache[name].copy_(torch.randn(cache[name].shape, generator=gen, device="cuda"))
cache["lengths"].fill_(10)
eager = {n: t.clone() for n, t in cache.items()}
tok = torch.tensor([[7]], dtype=torch.int32, device="cuda")
assert not k3._tickets
toks, _ = m.decode_tokens(params, cache, tok, 8)
want, t = [], tok
for _ in range(8):
    t = greedy_token(m.decode_step(params, eager, t)[0])
    want.append(t)
assert torch.equal(toks, torch.cat(want, 1)), (toks, want)
assert m.graph_stats["captures"] == 1
try:
    GraphCache().run(("sync",), params, tok, lambda x: x * int(x.sum().item()), cache, cache)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
else:
    raise SystemExit("a capture with a host sync did not raise")
print("ok")
"""
    env = child_env(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    print(out.stdout)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")


def test_captured_sharded_decode_equals_the_unsharded_one():
    """llama on a one-rank ("data", "model") NCCL mesh with the
    length-sharded flash-decode, captured: tokens bitwise the unsharded
    captured path's, after it captured its own graphs (the placement is in
    the key: at size 1 the weights are the same tensors), K3's log-sum-exp
    form on every replayed step, no plain call, no collective."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings
    from repro_torch.models import attention

    m = _model()
    params = m.init(0)
    L, T, rows = m.cfg.n_layers, 8, 64
    prompts = [_prompt(S, m.cfg.vocab, S) for S in (20, 33)]

    def serve(cache):
        out = []
        for prompt in prompts:
            m.prefill_jit(params, {"tokens": prompt}, cache)
            out.append(m.decode_tokens(params, cache, prompt[:, -1:], T)[0])
        return out

    want = serve(m.static_cache(1, rows))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    knobs = (attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = "shard_map", True
        with sh.use_mesh(mesh, shardings.make_rules(m.cfg, mesh)):
            shardings.place_params(params, m.cfg, mesh)
            cache, _ = shardings.place_cache(m.init_cache(1, rows), m.cfg, mesh)
            _build.reset_counters()
            sh.reset_comm_counters()
            got = serve(cache)
            assert _build.form_launches["decode_attention_lse"] == len(prompts) * L * T
            assert _build.launches == _build.counts(flash_attention=len(prompts) * L)
            assert sum(_build.plain.values()) == sum(_build.form_plain.values()) == 0
            assert sum(sh.comm_counts.values()) == 0
    finally:
        attention.DECODE_ATTN_MODE, shardings.FORCE_SEQ_SHARD_CACHE = knobs
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    decode = [k for k in m.graphs.graphs if k[0] == "decode"]
    assert len(decode) == 2 and len({k[:4] for k in decode}) == 1
    assert m.graph_stats["dropped"] == 0
