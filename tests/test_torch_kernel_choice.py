"""Where the port chooses between a kernel and its plain version.

Every dispatcher in ``kernels/ops.py`` is sent down the card's route on the
CPU here (``_on_card`` patched, each launcher counting a launch and running
the plain form), so a model's launch counts show, on the CPU, which route
each of its calls took. A model built with ``use_kernels=False`` launches
nothing: not in ``forward``, not in ``loss`` and its ``backward()`` (with
remat, so the recompute too), not in ``prefill`` and not in
``decode_tokens``. With ``use_kernels=True`` it launches as many kernels as
it did before the choice moved out of the models' signatures.
"""
import _torch_cpu  # noqa: F401
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import ssm
from repro_torch.models.model import _FAMILIES, build_model

S, T = 9, 3

# family -> the smoke config it runs at (hybrid_moe has no registry entry:
# the small granite-4.0-h that its own tests use)
ARCHS = {"dense": "llama3.2-1b", "moe": "granite-moe-1b-a400m", "vlm": "chameleon-34b",
         "encdec": "whisper-small", "hybrid": "zamba2-1.2b", "xlstm": "xlstm-1.3b",
         "hybrid_moe": None}

# the launches (kernel -> count, the log-sum-exp form under its own name) of
# each phase with use_kernels=True, counted when each family function still
# took the choice as an argument
LAUNCHES = {
    "dense": {"forward": {"flash_attention": 2}, "loss": {"flash_attention": 4},
              "prefill": {"flash_attention": 2}, "decode": {"decode_attention": 6}},
    "vlm": {"forward": {"flash_attention": 2}, "loss": {"flash_attention": 4},
            "prefill": {"flash_attention": 2}, "decode": {"decode_attention": 6}},
    "moe": {"forward": {"flash_attention": 2, "moe_positions": 2},
            "loss": {"flash_attention": 4, "moe_positions": 4},
            "prefill": {"flash_attention": 2, "moe_positions": 2},
            "decode": {"decode_attention": 6, "moe_positions": 6}},
    "encdec": {"forward": {"flash_attention": 6}, "loss": {"flash_attention": 12},
               "prefill": {"flash_attention": 2}, "decode": {"decode_attention": 12}},
    # the SSD scan runs its plain version under autograd
    "hybrid": {"forward": {"flash_attention": 1, "ssd_chunked": 2},
               "loss": {"flash_attention": 1},
               "prefill": {"flash_attention": 1, "ssd_chunked": 2},
               "decode": {"decode_attention": 3}},
    "hybrid_moe": {"forward": {"flash_attention": 1, "ssd_chunked": 3, "moe_positions": 4},
                   "loss": {"flash_attention": 2, "moe_positions": 8},
                   "prefill": {"flash_attention": 1, "ssd_chunked": 3, "moe_positions": 4},
                   "decode": {"decode_attention": 3, "moe_positions": 12}},
    "xlstm": {"forward": {}, "loss": {}, "prefill": {}, "decode": {}},
}


def _config(family):
    if ARCHS[family] is not None:
        return get_smoke_config(ARCHS[family])
    from portbench import harness
    from test_torch_hybrid_moe import small_config

    return harness.arch_config(small_config())


def _all_launched_as_on_card(monkeypatch):
    """Every dispatcher takes the card's route on the CPU; each launcher
    counts a launch and runs the plain form."""
    def matmul(a, b):
        _build.check("matmul", 0)
        return ref.matmul_ref(a, b)

    def flash(q, k, v, *, causal=True, sm_scale=None, window=None):
        _build.check("flash_attention", 0)
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, window=window)

    def decode(q, k, v, lengths, *, sm_scale=None, return_lse=False):
        _build.check("decode_attention", 0, form="decode_attention_lse" if return_lse else None)
        return ref.decode_attention_ref(q, k, v, lengths, sm_scale=sm_scale,
                                        return_lse=return_lse)

    def ssd(*args, chunk, h0=None):
        _build.check("ssd_chunked", 0)
        return ssm.ssd_chunked(*args, chunk=chunk, h0=h0)

    def positions(idx, E):
        _build.check("moe_positions", 0)
        return ref.moe_positions_ref(idx, E)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_matmul", matmul)
    monkeypatch.setattr(kflash, "flash_attention", flash)
    monkeypatch.setattr(ops, "_decode_attention", decode)
    monkeypatch.setattr(ops, "_ssd_chunked", ssd)
    monkeypatch.setattr(ops, "_moe_positions", positions)


def _counted(run) -> tuple[dict, dict]:
    """(launches, plain calls) that ``run()`` makes, each kernel and form
    that it made at least once."""
    ops.reset_counters()
    run()
    made = ({**ops.launches, **ops.form_launches}, {**ops.plain, **ops.form_plain})
    ops.reset_counters()
    return tuple({k: n for k, n in d.items() if n} for d in made)


def _phases(m, cfg):
    """Each phase's (launches, plain calls): forward, loss and its backward
    with remat, prefill, and ``T`` greedy decode steps."""
    params = m.init(0)
    rs = np.random.RandomState(3)
    tokens = torch.tensor(rs.randint(1, cfg.vocab, size=(1, S)), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1).long()}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(rs.randn(1, cfg.encoder_frames, cfg.d_model),
                                       dtype=torch.float32)

    def loss():
        params.requires_grad_(True)
        m.loss(params, batch, remat=True)[0].backward()
        params.requires_grad_(False)

    cache = m.init_cache(1, 32)
    prompt = {"frames": batch["frames"]} if cfg.family == "encdec" else {"tokens": tokens}
    return {"forward": _counted(lambda: m.forward(params, batch)),
            "loss": _counted(loss),
            "prefill": _counted(lambda: m.prefill(params, prompt, cache)),
            "decode": _counted(lambda: m.decode_tokens(params, cache, tokens[:, -1:], T))}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_every_family_keeps_the_choice(monkeypatch, family):
    assert set(ARCHS) == set(_FAMILIES)
    _all_launched_as_on_card(monkeypatch)
    cfg = _config(family)
    kernel = _phases(build_model(cfg, device="cpu"), cfg)
    plain = _phases(build_model(cfg, device="cpu", use_kernels=False), cfg)
    for phase, (launched, calls) in plain.items():
        assert launched == {}, (phase, launched)
        assert set(kernel[phase][0]) <= set(calls), (phase, calls)
    assert {p: c[0] for p, c in kernel.items()} == LAUNCHES[family]


def test_plain_path_nests_and_restores_its_value():
    """``ops.plain_path()`` is the one way to ask for the plain versions: it
    nests, gives back the value it found on exit and on an exception, and a
    CPU call outside it still counts in ``plain``."""
    a = torch.ones(4, 4)
    assert not ops.plain_only()
    with ops.plain_path():
        assert ops.plain_only()
        with ops.plain_path(False):
            assert not ops.plain_only()
            with ops.plain_path():
                assert ops.plain_only()
            assert not ops.plain_only()
        assert ops.plain_only()
    assert not ops.plain_only()
    with pytest.raises(ValueError, match="inside"):
        with ops.plain_path():
            raise ValueError("inside")
    assert not ops.plain_only()
    ops.reset_counters()
    ops.matmul(a, a)
    assert ops.plain == ops.counts(matmul=1) and ops.launches == ops.counts()
    ops.reset_counters()


def test_plain_path_sends_a_call_on_the_card_route_to_the_plain_version(monkeypatch):
    """On the card's route (``_on_card`` patched) every dispatcher launches
    outside the scope and calls its plain version inside it."""
    _all_launched_as_on_card(monkeypatch)
    rs = np.random.RandomState(2)
    a = torch.tensor(rs.randn(8, 8).astype(np.float32))
    q = torch.tensor(rs.randn(1, 2, 5, 16).astype(np.float32))
    lens = torch.tensor([3], dtype=torch.int32)
    ssd = (torch.randn(1, 6, 2, 4), torch.rand(1, 6, 2), -torch.rand(2), torch.randn(1, 6, 4),
           torch.randn(1, 6, 4), torch.ones(2))
    idx = torch.tensor(rs.randint(0, 4, size=(1, 6, 2)))

    def every():
        ops.matmul(a, a)
        ops.flash_attention(q, q, q)
        ops.decode_attention(q[:, :, :1], q, q, lens)
        ops.decode_attention(q[:, :, :1], q, q, lens, return_lse=True)
        ops.ssd_chunked(*ssd, chunk=3)
        ops.moe_positions(idx, 4)

    every_kernel = {**dict.fromkeys(ops.counts(), 1), "decode_attention_lse": 1}
    assert _counted(every) == (every_kernel, {})
    with ops.plain_path():
        assert _counted(every) == ({}, every_kernel)
