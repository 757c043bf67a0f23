"""The port's training path (``repro_torch.train``, ``optim``, ``checkpoint``,
``launch.train`` and each family's ``loss_fn``) against ``repro``'s, on the
CPU at smoke size in f32.

Weights are initialised by JAX and carried into the port's modules with
``load_jax_params``; JAX's gradients and optimizer state are carried the same
way into shadow modules of the port, so every tensor is compared by the
port's own parameter names. Inputs come from ``TokenStream`` (numpy) and a
seeded ``RandomState``. Tolerances: ``cross_entropy``, the schedules and
AdamW on identical gradients rtol 1e-6; the loss rtol 1e-5; each gradient
within 1e-4 of its tensor's largest |value| in ``repro``; train-step losses
rtol 1e-5.

On the card the flash-attention kernel carries attention's forward under
autograd; here ``ops._on_card`` is patched to route CPU tensors there and the
kernel's launcher to its plain version, which checks the wiring and the
launch, plain and backward counts.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.models.model import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.optim.schedule import warmup_linear as jax_warmup_linear
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_optimizer as jax_make_optimizer
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import load_jax_params, reference_ndim
from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine, warmup_linear
from repro_torch.train.loop import TrainConfig, make_optimizer, make_train_step, to_device, train

ARCHS = {"dense": "llama3.2-1b", "moe": "granite-moe-1b-a400m", "encdec": "whisper-small",
         "hybrid": "zamba2-1.2b", "xlstm": "xlstm-1.3b"}
CPU = torch.device("cpu")
B, S = 2, 24


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


_JAX = {}


def _jax(arch):
    """(jcfg, jax model, jax params), made once per arch."""
    if arch not in _JAX:
        jcfg = jax_smoke_config(arch)
        jm = jax_build_model(jcfg)
        _JAX[arch] = (jcfg, jm, jm.init(jax.random.PRNGKey(0)))
    return _JAX[arch]


def _port(arch, jp=None, use_kernels=True):
    """A fresh port model and module holding ``jp`` (the arch's JAX weights
    by default)."""
    tm = build_model(get_smoke_config(arch), device="cpu", use_kernels=use_kernels)
    return tm, load_jax_params(tm.init(1), _tree(_jax(arch)[2] if jp is None else jp))


def _shadow(tp, tree):
    """A module shaped like ``tp`` holding ``tree`` (a tree shaped like
    ``repro``'s params): its named tensors."""
    return dict(load_jax_params(type(tp)(tp.cfg, CPU), _tree(tree)).named_parameters())


def _batch(cfg, seed=0):
    b = next(TokenStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=seed))
    if cfg.family == "encdec":
        b["frames"] = np.random.RandomState(seed + 7).randn(
            B, cfg.encoder_frames, cfg.d_model).astype(np.float32)
    return b


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _loss_and_grads(tm, tp, batch, remat=True):
    tp.requires_grad_(True)
    tp.zero_grad(set_to_none=True)
    loss, metrics = tm.loss(tp, to_device(batch, CPU), remat=remat)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in tp.named_parameters()})


def _assert_grads_close(got: dict, want: dict, tol=1e-4):
    assert got.keys() == want.keys()
    for n in want:
        w = want[n].detach().float()
        err = (got[n].float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), f"{n}: {err} > {tol} x {w.abs().max().item()}"


# ---------------------------------------------------------------------------
# cross entropy, schedules, AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_weight", [1e-4, 0.0])
def test_cross_entropy_matches(z_weight):
    rs = np.random.RandomState(0)
    logits = (rs.randn(3, 7, 53) * 4).astype(np.float32)
    labels = rs.randint(0, 53, size=(3, 7)).astype(np.int32)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_weight)
    got = cross_entropy(torch.tensor(logits), torch.tensor(labels), z_weight)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # bf16 logits are widened first, as in repro
    got16 = cross_entropy(torch.tensor(logits).bfloat16(), torch.tensor(labels), z_weight)
    want16 = jax_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), z_weight)
    for g, w in zip(got16, want16):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match(kind):
    make = {"cosine": (warmup_cosine, jax_warmup_cosine),
            "linear": (warmup_linear, jax_warmup_linear)}[kind]
    for peak, warm, total in ((3e-4, 100, 1000), (1e-3, 0, 7), (1e-3, 20, 20)):
        ours, theirs = make[0](peak, warm, total), make[1](peak, warm, total)
        steps = np.arange(0, total + 6, dtype=np.int32)
        got = np.array([ours(torch.tensor(int(s), dtype=torch.int32)).item() for s in steps])
        want = np.array([float(theirs(jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        assert ours(torch.tensor(3)).dtype == torch.float32


@pytest.mark.parametrize("family", list(ARCHS))
def test_decay_rank_is_the_reference_leafs(family):
    """Each port parameter's ``reference_ndim`` is the rank of its leaf in
    repro's tree: carried through the converter, a leaf filled with its own
    rank lands in the parameter."""
    _, _, jp = _jax(ARCHS[family])
    _, tp = _port(ARCHS[family])
    ranks = jax.tree_util.tree_map(lambda x: np.full(np.shape(x), np.ndim(x), np.float32), jp)
    shadow = _shadow(tp, ranks)
    nd = reference_ndim(tp)
    assert nd.keys() == shadow.keys()
    for n, t in shadow.items():
        assert torch.all(t == nd[n]), n
    # the cases a port tensor's own rank gets wrong
    flat = {n for n, r in nd.items() if r <= 1}
    if family == "dense":
        assert nd["layers.0.ln1"] == 2 and flat == {"final_norm"}
    if family == "hybrid":
        assert nd["mamba.0.A_log"] == 2 and flat == {"final_norm", "shared_attn.ln1",
                                                     "shared_attn.ln2"}
    if family == "xlstm":
        assert nd["groups.0.0.b_i"] == 2 and "groups.1.ln" in flat


@pytest.mark.parametrize("family", ["dense", "moe", "encdec", "hybrid", "xlstm"])
def test_adamw_matches_reference_on_identical_gradients(family):
    """Three steps of AdamW (wd 0.1, clipping active) fed the same gradients:
    params, mu and nu within rtol 1e-6, the stacked-rank decay included."""
    _, _, jp = _jax(ARCHS[family])
    _, tp = _port(ARCHS[family])
    sched = dict(peak_lr=3e-2, warmup_steps=1, total_steps=5)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(*sched.values()), weight_decay=0.1)
    topt = AdamW(learning_rate=warmup_cosine(*sched.values()), weight_decay=0.1)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    rs = np.random.RandomState(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rs.randn(*np.shape(x)) * 0.3).astype(np.float32), jp)
        jp, jstate, jm = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        tm_ = topt.update(_shadow(tp, grads), tstate, tp)
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm_["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for name, got, want in (("params", dict(tp.named_parameters()), _shadow(tp, jp)),
                            ("mu", tstate.mu, _shadow(tp, jstate.mu)),
                            ("nu", tstate.nu, _shadow(tp, jstate.nu)),
                            ("master", tstate.master, _shadow(tp, jstate.master))):
        for n in want:
            np.testing.assert_allclose(got[n].detach().numpy(), want[n].detach().numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name} {n}")


# ---------------------------------------------------------------------------
# Model.loss and its gradients, remat, train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(ARCHS))
def test_loss_and_every_gradient_match(family):
    jcfg, jm, jp = _jax(ARCHS[family])
    tm, tp = _port(ARCHS[family])
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), remat=True), has_aux=True))(jp)
    loss, met, grads = _loss_and_grads(tm, tp, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "nll", "aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-7)
    if family == "moe":
        assert float(met["aux"]) > 0
    _assert_grads_close(grads, _shadow(tp, jgrads))


@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_equals_no_remat(family):
    jcfg, _, _ = _jax(ARCHS[family])
    tm, tp = _port(ARCHS[family])
    batch = _batch(jcfg, seed=1)
    loss, met, grads = _loss_and_grads(tm, tp, batch, remat=True)
    loss0, met0, grads0 = _loss_and_grads(tm, tp, batch, remat=False)
    assert torch.equal(loss, loss0)
    for n in grads:
        torch.testing.assert_close(grads[n], grads0[n], rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_train_steps_losses_match(family):
    """Three ``make_train_step`` steps through both packages from shared
    weights on the same batches: losses within 1e-5."""
    jcfg, jm, jp = _jax(ARCHS[family])
    tm, tp = _port(ARCHS[family])
    jtc = JaxTrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jopt, topt = jax_make_optimizer(jtc), make_optimizer(tc)
    jstep = jax.jit(jax_make_train_step(jm, jopt, remat=True))
    tstep = make_train_step(tm, topt, remat=True)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    data = TokenStream(vocab=jcfg.vocab, batch=B, seq_len=S, seed=5)
    for _ in range(3):
        batch = next(data)
        jp, jstate, jmet = jstep(jp, jstate, _jbatch(batch))
        tp, tstate, tmet = tstep(tp, tstate, to_device(batch, CPU))
        for k in ("loss", "ce", "nll", "aux", "grad_norm", "lr"):
            assert tmet[k].dim() == 0
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_train_lowers_nll_at_the_examples_reduced_config():
    """``examples/train_lm.py``'s reduced llama (4 layers, d_model 256, vocab
    512, batch 8 x 128, peak lr 1e-3, warmup 20): 60 steps of the port's
    ``train()`` lower the nll by at least 10%."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), n_layers=4, d_model=256,
                              vocab=512)
    data = iter(TokenStream(vocab=cfg.vocab, batch=8, seq_len=128, seed=0))
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=20, total_steps=60)
    logged = []
    params, hist = train(cfg, data, tc, steps=60, log_every=20, device="cpu",
                         log_fn=lambda step, m: logged.append(step))
    assert logged == [0, 20, 40, 59] and [h["step"] for h in hist] == logged
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["nll"] < 0.9 * hist[0]["nll"], (hist[0]["nll"], hist[-1]["nll"])
    assert params.layers[0].ln1.device.type == "cpu"


def test_serving_after_training_records_no_autograd():
    cfg = get_smoke_config("llama3.2-1b")
    tm, tp = _port("llama3.2-1b")
    opt = make_optimizer(TrainConfig(peak_lr=1e-3, warmup_steps=1))
    step = make_train_step(tm, opt)
    step(tp, opt.init(tp), to_device(_batch(cfg), CPU))
    assert all(p.requires_grad for p in tp.parameters())
    cache = tm.init_cache(B, 32)
    logits, _ = tm.prefill(tp, {"tokens": torch.tensor(_batch(cfg)["tokens"])}, cache)
    assert not logits.requires_grad and logits.grad_fn is None
    toks, _ = tm.decode_tokens(tp, cache, torch.zeros((B, 1), dtype=torch.int32), 3)
    logits, _ = tm.decode_step(tp, cache, toks[:, -1:])
    assert not logits.requires_grad and not cache["k"].requires_grad


# ---------------------------------------------------------------------------
# checkpoint, launcher
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_resumes_bitwise(tmp_path):
    """Save after 3 steps, restore into fresh modules and state (bf16
    parameters, stored as f32): step 4 gives bitwise the same loss and
    parameters as the uninterrupted run."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="bfloat16")
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    batches = [to_device(b, CPU) for _, b in
               zip(range(4), TokenStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=2))]
    model = build_model(cfg, device="cpu")
    opt = make_optimizer(tc)
    step = make_train_step(model, opt)
    params = model.init(0)
    state = opt.init(params)
    for b in batches[:3]:
        step(params, state, b)
    save(tmp_path / "ck.npz", {"params": params, "opt": state})
    _, _, met = step(params, state, batches[3])

    fresh = model.init(99)
    fstate = opt.init(fresh)
    restore(tmp_path / "ck.npz", {"params": fresh, "opt": fstate})
    assert fresh.embed.dtype == torch.bfloat16 and int(fstate.step) == 3
    _, _, fmet = step(fresh, fstate, batches[3])
    assert torch.equal(fmet["loss"], met["loss"])
    for (n, a), b in zip(params.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for n in state.master:
        assert torch.equal(state.master[n], fstate.master[n])
        assert torch.equal(state.nu[n], fstate.nu[n])
    with np.load(tmp_path / "ck.npz") as data:
        manifest = json.loads(str(data["__manifest__"]))
    assert set(manifest) == {"keys", "dtypes", "shardings"}
    assert manifest["dtypes"][manifest["keys"].index("params/embed")] == "bfloat16"
    assert manifest["dtypes"][manifest["keys"].index("opt/step")] == "int32"
    assert "opt/mu/layers.0.ln1" in manifest["keys"]


def test_restore_names_missing_keys(tmp_path):
    tm, tp = _port("llama3.2-1b")
    save(tmp_path / "p.npz", {"embed": tp.embed})
    with pytest.raises(KeyError, match=r"checkpoint missing keys: \['final_norm', "
                                       r"'layers\.0\.ln1'"):
        restore(tmp_path / "p.npz", tp)
    save(tmp_path / "full.npz", tp)
    other = build_model(get_smoke_config("llama3.2-1b"), device="cpu").init(5)
    restore(tmp_path / "full.npz", other)
    for a, b in zip(tp.parameters(), other.parameters()):
        assert torch.equal(a, b)


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--steps", "12", "--batch", "2", "--seq-len", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in lines] == [0, 10, 11]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    with pytest.raises(SystemExit, match="encoder-decoder"):
        launch_train.main(["--arch", "whisper-small", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the kernel under autograd: FlashAttention's wiring, the other kernels' refusal
# ---------------------------------------------------------------------------


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors take the card's route; the flash kernel's launcher is its
    plain version, counted as a launch."""
    def launcher(q, k, v, *, causal=True, sm_scale=None, window=None):
        out = ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
        _build.check("flash_attention", 0)
        return out

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(kflash, "flash_attention", launcher)
    _build.reset_counters()
    yield
    _build.reset_counters()


@pytest.mark.parametrize("case", [
    # (batch, q heads, kv heads, q_seq, kv_seq, d, causal, window, which inputs need grad)
    (2, 4, 4, 17, 17, 16, True, None, "qkv"),
    (2, 8, 2, 17, 17, 16, False, None, "qkv"),
    (1, 8, 2, 33, 33, 16, True, 8, "qkv"),
    (1, 4, 1, 9, 20, 16, False, None, "qkv"),
    (1, 4, 1, 9, 20, 16, True, 5, "kv"),
    (2, 4, 2, 12, 12, 16, True, None, "q"),
], ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_function_gradients_and_counts(on_card, case):
    b, qh, kvh, sq, skv, d, causal, window, need = case
    rs = np.random.RandomState(11)
    q, k, v = (torch.tensor(rs.randn(*s).astype(np.float32)) for s in
               ((b, qh, sq, d), (b, kvh, skv, d), (b, kvh, skv, d)))
    w = torch.tensor(rs.randn(b, qh, sq, d).astype(np.float32))
    ins = [t.clone().requires_grad_(n in need) for t, n in zip((q, k, v), "qkv")]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * w).sum().backward()
    plain_ins = [t.clone().requires_grad_(n in need) for t, n in zip((q, k, v), "qkv")]
    want = ref.attention_ref(*plain_ins, causal=causal, window=window)
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for t, p, n in zip(ins, plain_ins, "qkv"):
        if n in need:
            torch.testing.assert_close(t.grad, p.grad, rtol=1e-6, atol=1e-6)
        else:
            assert t.grad is None
    assert _build.launches["flash_attention"] == 1
    assert _build.backward["flash_attention"] == 1
    assert sum(_build.plain.values()) == 0
    # without a gradient the kernel is called as it is: no Function
    with torch.no_grad():
        assert ops.flash_attention(*ins, causal=causal, window=window).grad_fn is None
    assert ops.flash_attention(q, k, v, causal=causal, window=window).grad_fn is None
    assert _build.launches["flash_attention"] == 3 and _build.backward["flash_attention"] == 1


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_through_the_kernel_route_counts_and_matches_plain(on_card, remat):
    """A llama smoke loss and gradients on the card's route: K2 launched once
    a layer, and again in each layer's recomputation with remat; one plain
    backward a layer; no plain call; the gradients those of the plain path."""
    jcfg, _, _ = _jax("llama3.2-1b")
    batch = _batch(jcfg, seed=4)
    tm, tp = _port("llama3.2-1b")
    loss, _, grads = _loss_and_grads(tm, tp, batch, remat=remat)
    L = jcfg.n_layers
    assert _build.launches == _build.counts(flash_attention=(2 if remat else 1) * L)
    assert _build.backward == _build.counts(flash_attention=L)
    assert sum(_build.plain.values()) == 0
    pm, pp = _port("llama3.2-1b", use_kernels=False)
    ploss, _, pgrads = _loss_and_grads(pm, pp, batch, remat=remat)
    assert _build.plain["flash_attention"] == (2 if remat else 1) * L
    torch.testing.assert_close(loss, ploss, rtol=1e-6, atol=0)
    _assert_grads_close(grads, pgrads, tol=1e-6)


def test_decode_and_matmul_kernels_refuse_gradients_on_the_card(on_card):
    rs = np.random.RandomState(0)
    q = torch.tensor(rs.randn(1, 4, 1, 16).astype(np.float32), requires_grad=True)
    kc = torch.tensor(rs.randn(1, 2, 8, 16).astype(np.float32))
    lens = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="decode_attention kernel has no backward"):
        ops.decode_attention(q, kc, kc, lens)
    a = torch.tensor(rs.randn(4, 4).astype(np.float32))
    with pytest.raises(RuntimeError, match="matmul kernel has no backward"):
        ops.matmul(a, a.clone().requires_grad_(True))
    assert sum(_build.launches.values()) == 0
    # on the CPU's own route both run their plain versions, under autograd
    q2 = q.detach().clone().requires_grad_(True)
    ops.decode_attention(q2, kc, kc, lens, use_kernel=False).sum().backward()
    assert q2.grad is not None
