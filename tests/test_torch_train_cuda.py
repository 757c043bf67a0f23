"""The port's training path on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

``FlashAttention`` (the flash-attention kernel's forward under autograd, the
plain version's gradient) is held against autograd through the plain
version: outputs per row as ``tests/test_torch_kernels_cuda.py`` holds the
kernel, gradients within 1e-4 of their largest value (f32) or per row at the
bf16 limit. A llama smoke train step on the card equals the CPU's within
1e-4 (losses and gradients; TF32 off), each AdamW update on the card equals
the CPU's on the same gradients and state within 1e-5, and serving after
training launches exactly what it launched before.
"""
import _torch_cpu  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import _build, ops, ref
from repro_torch.models.model import build_model
from repro_torch.train.loop import TrainConfig, make_optimizer, make_train_step, to_device

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_FLASH = 3.125e-2  # tests/test_torch_kernels_cuda.py's bf16 flash limit

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_counters()
    yield
    _build.reset_counters()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _rand(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.tensor(x, device="cuda").to(TDT[dtype])


def _assert_close(got, want, dtype):
    """f32: within 1e-4 of want's largest |value|; bf16: per row (last axis)
    within the bf16 flash limit, or two ulps at the row's largest |want|."""
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= 1e-4 * want.float().abs().max().item()
        return
    top = want.float().abs().amax(-1, keepdim=True)
    lim = torch.clamp(2 * torch.exp2(torch.floor(torch.log2(top)) - 7), max=BF16_FLASH)
    assert not (diff > lim + lim * want.float().abs()).any(), diff.max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 37),
                                           (False, 256)])
@pytest.mark.parametrize("shape", [
    # (batch, q heads, kv heads, q_seq, kv_seq, d)
    (1, 4, 4, 77, 77, 64), (2, 8, 2, 200, 200, 128), (2, 4, 1, 128, 128, 96),
    (1, 8, 2, 65, 250, 64),
])
def test_flash_attention_gradients_match_plain(shape, causal, window, dtype):
    b, qh, kvh, sq, skv, d = shape
    q, k, v = _rand((b, qh, sq, d), dtype, 1), _rand((b, kvh, skv, d), dtype, 2), \
        _rand((b, kvh, skv, d), dtype, 3)
    w = _rand((b, qh, sq, d), dtype, 4)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    (out.float() * w.float()).sum().backward()
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention_ref(*plain, causal=causal, window=window)
    (want.float() * w.float()).sum().backward()
    assert _build.launches["flash_attention"] == 1 and _build.backward["flash_attention"] == 1
    assert sum(_build.plain.values()) == 0
    tol = {"float32": 2e-3, "bfloat16": BF16_FLASH}[dtype]
    top = want.float().abs().amax(-1, keepdim=True)
    lim = torch.clamp(tol * top if dtype == "float32"
                      else 2 * torch.exp2(torch.floor(torch.log2(top)) - 7), max=tol)
    assert not ((out.float() - want.float()).abs() > lim + lim * want.float().abs()).any()
    for t, p in zip(ins, plain):
        assert t.grad.dtype == t.dtype
        _assert_close(t.grad, p.grad, dtype)


def test_llama_smoke_train_step_on_the_card_equals_the_cpu():
    """Two ``make_train_step`` steps from the same weights on the card and on
    the CPU: losses within 1e-4, and the first step's gradients within 1e-4
    of each one's largest |value|. Each of the card's AdamW updates is held
    to the CPU's AdamW fed the card's own gradients and state from before
    the step: master, mu and nu within 1e-5 of each one's largest |value|,
    and the parameters equal to the master. (The parameters after the two
    runs are not held to each other: where a gradient is near 0 its update
    is about ±lr whatever its size, so rounding in the gradient can flip
    it.)"""
    cfg = get_smoke_config("llama3.2-1b")
    data = TokenStream(vocab=cfg.vocab, batch=2, seq_len=64, seed=0)
    batches = [next(data) for _ in range(2)]
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=1)
    cpu_m = build_model(cfg, device="cpu")
    cpu_p = cpu_m.init(3)
    card_m = build_model(cfg)
    card_p = card_m.init(3)
    with torch.no_grad():
        for a, b in zip(card_p.parameters(), cpu_p.parameters()):
            a.copy_(b)
    shadow = cpu_m.init(4)  # the CPU update's parameters, overwritten from its master
    cpu_opt = make_optimizer(tc)

    def on_cpu(state):
        return type(state)(state.step.cpu().clone(),
                           *({n: t.detach().cpu().clone() for n, t in d.items()}
                             for d in (state.mu, state.nu, state.master)))

    losses, grads = {}, {}
    for name, m, p in (("cpu", cpu_m, cpu_p), ("card", card_m, card_p)):
        opt = make_optimizer(tc)
        state = opt.init(p)
        step = make_train_step(m, opt)
        losses[name] = []
        for i, batch in enumerate(batches):
            before = on_cpu(state)
            losses[name].append(step(p, state, to_device(batch, m.device))[2]["loss"].item())
            g = {n: t.grad.detach().cpu() for n, t in p.named_parameters()}
            if i == 0:
                grads[name] = g
            if name == "card":
                cpu_opt.update(g, before, shadow)
                after = on_cpu(state)
                assert int(after.step) == int(before.step) == i + 1
                for want, got in ((before.master, after.master), (before.mu, after.mu),
                                  (before.nu, after.nu)):
                    for n, w in want.items():
                        err = (got[n] - w).abs().max().item()
                        assert err <= 1e-5 * w.abs().max().item(), (i, n)
                for n, t in p.named_parameters():
                    assert torch.equal(t.detach().cpu(), after.master[n].to(t.dtype)), (i, n)
    L = cfg.n_layers
    assert _build.launches["flash_attention"] == 2 * 2 * L  # 2 steps, forward + recompute
    assert _build.backward["flash_attention"] == 2 * L and sum(_build.plain.values()) == 2 * 2 * L
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4)
    for n, want in grads["cpu"].items():
        err = (grads["card"][n] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), n


def test_serving_after_training_launches_as_before():
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0)
    prompt = torch.randint(0, cfg.vocab, (1, 40), dtype=torch.int32, device="cuda")

    def serve():
        cache = model.static_cache(1, 64)
        logits, _ = model.prefill_jit(params, {"tokens": prompt}, cache)
        toks, _ = model.decode_tokens(params, cache, logits.argmax(-1).to(torch.int32), 8)
        torch.cuda.synchronize()
        return logits, toks

    serve()  # captures the graphs
    counts = []
    for train_between in (False, True):
        if train_between:
            opt = make_optimizer(TrainConfig(peak_lr=1e-3, warmup_steps=1))
            batch = next(TokenStream(vocab=cfg.vocab, batch=2, seq_len=64, seed=1))
            make_train_step(model, opt)(params, opt.init(params), to_device(batch, model.device))
            assert all(p.requires_grad for p in params.parameters())
        _build.reset_counters()
        logits, toks = serve()
        assert logits.grad_fn is None and not logits.requires_grad
        counts.append((dict(_build.launches), dict(_build.plain), dict(_build.backward)))
    assert counts[0] == counts[1]
    launches, plain, backward = counts[0]
    assert launches == _build.counts(flash_attention=cfg.n_layers,
                                     decode_attention=8 * cfg.n_layers)
    assert sum(plain.values()) == 0 and sum(backward.values()) == 0
