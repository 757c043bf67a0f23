"""Worker side of ``tests/test_torch_distributed.py``: the port's local
program on each rank of a gloo process group on the CPU.

Imports no JAX: the test computes the reference's numbers in its own
process and hands them over as files in a directory (``.npz`` inputs and
expectations, ``.pt`` port weights). Each rank runs every case of its mesh
and writes ``r{rank}.json``, case -> "ok" or the failure's text.
"""
from __future__ import annotations

import contextlib
import json
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import _build
from repro_torch.launch import shardings
from repro_torch.models import attention as tattn
from repro_torch.models.layers import gather_logits
from repro_torch.models.model import build_model, greedy_token
from repro_torch.models.ssm import slstm_scan
from repro_torch.optim.adamw import AdamW
from repro_torch.train.loop import make_train_step

# rtol 1e-5; atol 1e-5 of the largest |value| (logits of about 20 sum
# thousands of f32 products, in another order on each side)
RTOL = 1e-5
STEPS = 8
# the train cases: a whole batch of TRAIN_B rows of TRAIN_S tokens (S splits
# over a model axis of 2 for seq_parallel), clip_norm CLIP x the reference's
# norm, so that the clip binds. AdamW's first update is lr x g / (|g| + eps),
# which divides out each element's size: at the default eps (1e-8) an element
# near zero, whose f32 rounding differs between summation orders (the port
# alone against the reference, with no mesh, already differs so), moves its
# parameter by up to lr. TRAIN_EPS (1e-4, under a hundredth of the clipped
# gradient's large elements) keeps the update a smooth function of the
# gradient, so the parameters after the step are held at the gradients'
# tolerance
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_EPS, CLIP = 4, 10, 1e-3, 1e-4, 0.1
KNOBS = ("dp_only", "fsdp", "dp_only_fsdp", "seq_parallel", "accum_steps")
# the MoE's own paths under the knobs: the router and its aux read the whole
# sequence, the experts' FSDP blocks are gathered (accumulation differs from
# the whole-batch step there: the aux is not linear in the batch)
MOE_KNOBS = ("fsdp", "seq_parallel")
ENCDEC, ENCDEC_KNOBS = "whisper-small", ("fsdp", "seq_parallel")
RECURRENT = ("zamba2-1.2b", "xlstm-1.3b")


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=what)


@contextlib.contextmanager
def no_parameter_gather(params: torch.nn.Module):
    """Fail on an all-gather over the model axis of a tensor that shares a
    parameter's storage (a block of the weights, gathered)."""
    ptrs = {p.untyped_storage().data_ptr() for p in params.parameters()}
    gather = sh._gather

    def guarded(x, dim, entry, g):
        if sh.MODEL_AXIS in sh._axes(entry) and x.untyped_storage().data_ptr() in ptrs:
            raise AssertionError(f"a parameter block {tuple(x.shape)} was all-gathered over "
                                 f"the model axis")
        return gather(x, dim, entry, g)

    sh._gather = guarded
    try:
        yield
    finally:
        sh._gather = gather


def recurrent_counts(cfg, kind: str) -> dict:
    """The collectives of one prefill or decode step (``kind``) of a placed
    smoke zamba2 or xlstm, by kind, derived by hand (the models' docstrings
    list them): the vocab-split embedding's all-reduce; a Mamba2 block's
    gather of its conv output, its ``ynorm`` and ``w_out`` all-reduces; the
    shared block's attention (one all-reduce after ``wo``; a decode step over
    a head_dim-split cache also sums the scores and gathers q and o) and
    SwiGLU (one); an mLSTM block's gather of its projection, the sum of its
    q, k, v and gates, in decode the sum of q·C and q·n, and ``w_down``'s
    all-reduce; an sLSTM block's ``w_out`` all-reduce, and in decode its two
    gathers of h."""
    from repro_torch.models import hybrid, xlstm

    decode = kind == "decode"
    if cfg.family == "hybrid":
        L, apps = cfg.n_layers, hybrid._n_attn(cfg)
        split_hd = shardings.kv_cache_dim(cfg, sh.current_mesh()) == 3
        attn_ar, attn_ag = (2, 2) if decode and split_hd else (1, 0)
        ar, ag = 1 + 2 * L + apps * (attn_ar + 1), L + apps * attn_ag
    else:
        plan = xlstm._plan(cfg)
        n_m = sum(c for k, c in plan if k == "mlstm")
        n_s = sum(c for k, c in plan if k == "slstm")
        ar = 1 + (3 if decode else 2) * n_m + n_s
        ag = n_m + (2 * n_s if decode else 0)
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0}


def tp_decode(d: Path, arch: str) -> None:
    """Prefill and STEPS greedy steps on the placed model: logits and tokens
    equal to the reference's unsharded ones on this rank's batch rows; for a
    recurrent family also each step's collectives, and no parameter block
    gathered over the model axis."""
    ref = np.load(d / f"{arch}.npz")
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    params.load_state_dict(torch.load(d / f"{arch}.pt"))
    mesh = sh.current_mesh()
    shardings.place_params(params, cfg, mesh)
    B = ref["tokens"].shape[0]
    n = sh.mesh_size(mesh, "data")
    rows = slice(sh.coordinate("data") * (B // n), (sh.coordinate("data") + 1) * (B // n))
    tokens = torch.tensor(ref["tokens"][rows])
    recurrent = arch in RECURRENT
    guard = (lambda: no_parameter_gather(params)) if recurrent else contextlib.nullcontext

    def counted(kind, fn, *args):
        sh.reset_comm_counters()
        with guard():
            out = fn(*args)
        if recurrent:
            assert sh.comm_counts == recurrent_counts(cfg, kind), (kind, sh.comm_counts)
        return out

    # the whole batch's cache, placed: this rank's rows (and split)
    cache, _ = shardings.place_cache(model.init_cache(B, int(ref["max_len"])), cfg, mesh)
    logits, cache = counted("prefill", model.prefill, params, {"tokens": tokens}, cache)
    logits = gather_logits(params, logits)
    _close(logits, ref["prefill"][rows], f"{arch} prefill")
    tok = greedy_token(logits[:, -1:])
    for t in range(STEPS):
        np.testing.assert_array_equal(tok.numpy()[:, 0], ref["tokens_out"][t][rows],
                                      err_msg=f"{arch} token {t}")
        logits, cache = counted("decode", model.decode_step, params, cache, tok)
        logits = gather_logits(params, logits)
        _close(logits, ref["steps"][t][rows], f"{arch} step {t}")
        tok = greedy_token(logits)


def decode_tokens(d: Path, arch: str) -> None:
    """``Model.decode_tokens`` itself (the greedy loop that the card
    captures) on the placed model after ``prefill``: the reference's greedy
    tokens on this rank's rows, the logits gathered over the vocab first."""
    ref = np.load(d / f"{arch}.npz")
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    params.load_state_dict(torch.load(d / f"{arch}.pt"))
    mesh = sh.current_mesh()
    shardings.place_params(params, cfg, mesh)
    assert params.tp.out_vocab, "this mesh does not split the vocab"
    B = ref["tokens"].shape[0]
    n = sh.mesh_size(mesh, "data")
    rows = slice(sh.coordinate("data") * (B // n), (sh.coordinate("data") + 1) * (B // n))
    cache, _ = shardings.place_cache(model.init_cache(B, int(ref["max_len"])), cfg, mesh)
    logits, cache = model.prefill(params, {"tokens": torch.tensor(ref["tokens"][rows])}, cache)
    tok = greedy_token(gather_logits(params, logits)[:, -1:])
    out, cache = model.decode_tokens(params, cache, tok, STEPS - 1)
    got = torch.cat([tok, out], 1).numpy()
    np.testing.assert_array_equal(got, ref["tokens_out"][:, rows].T, err_msg=f"{arch} tokens")


def _close_first_update(got: torch.Tensor, want: np.ndarray, grad: np.ndarray, ref,
                        what: str) -> None:
    """A parameter that starts at zero after the first AdamW step: the step
    alone, lr x g'/(|g'| + eps) of the clipped gradient g'. Where |g'| is
    below eps the step is lr/eps x g', so f32 noise of a small, cancelling
    gradient element that the gradient rule admits (one summation order
    against another; the port with no mesh already differs so from the
    reference) moves it by lr/eps times as much. It is held to the
    reference's step within the PR 20 rule plus the gradient rule carried
    through that map: lr x eps / (|g'| + eps)^2 x c x (RTOL |g| + RTOL
    max|g|), c the clip's factor."""
    c = min(1.0, float(ref["clip_norm"]) / float(ref["grad_norm"]))
    gc = np.abs(grad) * c
    carried = TRAIN_LR * TRAIN_EPS / (gc + TRAIN_EPS) ** 2 * c * RTOL * (
        np.abs(grad) + np.abs(grad).max())
    bound = RTOL * np.abs(want) + RTOL * float(np.abs(want).max()) + carried
    err = np.abs(got.detach().numpy() - want)
    assert (err <= bound).all(), f"{what}: {int((err > bound).sum())} elements off, " \
                                 f"worst {float((err - bound).max())} over"


def _batch_rows(n_rows: int) -> slice:
    """This rank's rows of a batch split over the rules' batch axes."""
    entry = sh.logical_to_spec("batch")[0]
    n = sh.mesh_size(sh.current_mesh(), entry)
    i = sh.coordinate(entry) if n > 1 else 0
    return slice(i * (n_rows // n), (i + 1) * (n_rows // n))


def train_step(d: Path, arch: str, knob: str = "") -> None:
    """One step of ``make_train_step`` on the placed model, this rank's rows
    of the batch, under the dry-run's ``knob``: the reference's loss and
    global ``grad_norm``, and every gradient and post-step parameter,
    gathered over the axes that split it, equal to the reference's."""
    suffix = "-accum_steps" if knob == "accum_steps" else ""
    ref = np.load(d / f"train_{arch}{suffix}.npz")
    cfg = get_smoke_config(arch)
    mesh = sh.current_mesh()
    rules = shardings.make_rules(cfg, mesh)
    if knob == "seq_parallel":
        rules["seq"] = shardings.MODEL_AXIS
    dp_only, fsdp = knob.startswith("dp_only"), knob.endswith("fsdp")
    if dp_only:
        rules = shardings.dp_only_rules(mesh, TRAIN_B)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    params.load_state_dict(torch.load(d / f"{arch}.pt"))
    zero = {n for n, p in params.named_parameters() if arch in RECURRENT and not p.any()}
    with sh.use_mesh(mesh, rules):
        specs = shardings.place_params(params, cfg, mesh, replicate=dp_only, fsdp=fsdp)
        rows = _batch_rows(TRAIN_B)
        batch = {k: torch.tensor(ref[k][rows]) for k in ("tokens", "labels", "frames")
                 if k in ref}
        opt = AdamW(learning_rate=TRAIN_LR, eps=TRAIN_EPS, clip_norm=float(ref["clip_norm"]))
        # ZeRO-1 under dp_only_fsdp: whole parameters, the state split as FSDP splits it
        state_specs = (shardings.param_specs(params, cfg, mesh, fsdp=True)
                       if dp_only and fsdp else None)
        state = opt.init(params, state_specs)
        step = make_train_step(model, opt, specs=specs, state_specs=state_specs,
                               accum_steps=2 if knob == "accum_steps" else 1)
        sh.reset_comm_counters()
        with no_parameter_gather(params):
            _, _, metrics = step(params, state, batch)
        if knob == "dp_only":
            assert sh.comm_counts["all-gather"] == sh.comm_counts["reduce-scatter"] == 0
        if state_specs is not None:
            assert state.master["embed"].numel() * 4 == params.embed.numel(), "state not split"
        _close(metrics["loss"], ref["loss"], f"{arch} {knob} loss")
        _close(metrics["grad_norm"], ref["grad_norm"], f"{arch} {knob} grad_norm")
        want_g = torch.load(d / f"train_{arch}{suffix}_grads.pt")
        want_p = torch.load(d / f"train_{arch}{suffix}_params.pt")
        for name, p in params.named_parameters():
            _close(sh.gather_block(p.grad, specs[name]), want_g[name].detach().numpy(),
                   f"{arch} {knob} gradient {name}")
            got, want = sh.gather_block(p.detach(), specs[name]), want_p[name].detach().numpy()
            what = f"{arch} {knob} parameter {name}"
            if name in zero:
                _close_first_update(got, want, want_g[name].detach().numpy(), ref, what)
            else:
                _close(got, want, what)


def whole_rows_decode(d: Path, arch: str) -> None:
    """``tp_decode`` with the card's placement (``_whole_kv_rows`` true): a cache
    that ``cache_spec`` splits over head_dim is placed along its length, and
    every decode step runs the length-sharded flash-decode (the decode
    kernel's log-sum-exp form on the card, its plain version here) in place
    of the head_dim split's plain scores."""
    cfg = get_smoke_config(arch)
    mesh = sh.current_mesh()
    assert shardings.kv_cache_dim(cfg, mesh) == 3, "this mesh does not split head_dim"
    whole = shardings._whole_kv_rows
    shardings._whole_kv_rows = lambda mesh: True
    _build.reset_counters()
    try:
        assert shardings.kv_cache_dim(cfg, mesh) == 2
        tp_decode(d, arch)
    finally:
        shardings._whole_kv_rows = whole
    assert _build.form_plain["decode_attention_lse"] == cfg.n_layers * STEPS, _build.form_plain
    assert _build.plain["decode_attention"] == 0, _build.plain


def onehot_equals_scatter(d: Path, arch: str) -> None:
    """The placed model's decode with the one-hot cache update gives the
    scatter update's logits, bitwise."""
    ref = np.load(d / f"{arch}.npz")
    cfg = get_smoke_config(arch)
    out = {}
    for mode in ("scatter", "onehot"):
        tattn.CACHE_UPDATE_MODE = mode
        try:
            model = build_model(cfg, device="cpu")
            params = model.init(0)
            params.load_state_dict(torch.load(d / f"{arch}.pt"))
            shardings.place_params(params, cfg, sh.current_mesh())
            B = ref["tokens"].shape[0]
            cache, _ = shardings.place_cache(model.init_cache(B, int(ref["max_len"])), cfg,
                                             sh.current_mesh())
            logits, cache = model.prefill(params, {"tokens": torch.tensor(ref["tokens"])}, cache)
            got = []
            tok = greedy_token(gather_logits(params, logits)[:, -1:])
            for _ in range(3):
                logits, cache = model.decode_step(params, cache, tok)
                logits = gather_logits(params, logits)
                got.append(logits)
                tok = greedy_token(logits)
            out[mode] = (torch.stack(got), cache["k"].clone(), cache["v"].clone())
        finally:
            tattn.CACHE_UPDATE_MODE = "scatter"
    for a, b in zip(out["scatter"], out["onehot"]):
        assert torch.equal(a, b), "one-hot and scatter updates differ"


def shard_map_decode(d: Path, case: str) -> None:
    """``DECODE_ATTN_MODE = "shard_map"`` over this rank's slice of a
    length-sharded cache: the step's output and the gathered caches equal
    the reference's local decode step; three merges a call."""
    ref = np.load(d / f"attn_{case}.npz")
    hd_shape = ref["wq"].shape
    att = tattn.Attention(hd_shape[0], hd_shape[1], ref["wk"].shape[1], hd_shape[2], False,
                          torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for f in ("wq", "wk", "wv", "wo"):
            getattr(att, f).copy_(torch.tensor(ref[f]))
    kc = sh.local_block(torch.tensor(ref["k_cache"]), 2, "model").clone()
    vc = sh.local_block(torch.tensor(ref["v_cache"]), 2, "model").clone()
    window = int(ref["window"]) or None
    tattn.DECODE_ATTN_MODE = "shard_map"
    sh.reset_comm_counters()
    try:
        with torch.no_grad():
            y = tattn.decode_attention_step(att, torch.tensor(ref["x"]), kc, vc,
                                            torch.tensor(ref["lengths"]), rope_theta=1e4,
                                            eps=1e-5, window=window)
    finally:
        tattn.DECODE_ATTN_MODE = "local"
    assert sh.comm_counts["all-reduce"] == 3, sh.comm_counts
    _close(y, ref["y"], f"{case} out")
    _close(sh.all_gather(kc, 2), ref["k_new"], f"{case} k cache")
    _close(sh.all_gather(vc, 2), ref["v_new"], f"{case} v cache")


def slstm_branch(d: Path) -> None:
    """The sLSTM cell on this rank's batch block (the local program is the
    reference's shard_map branch), gathered: the reference's ``slstm_scan``
    over the whole batch; no collective."""
    ref = np.load(d / "slstm.npz")
    B = ref["xg"].shape[0]
    n = sh.mesh_size(sh.current_mesh(), "data")
    i = sh.coordinate("data")
    xg = torch.tensor(ref["xg"][i * (B // n):(i + 1) * (B // n)])
    sh.reset_comm_counters()
    h, state = slstm_scan(xg, torch.tensor(ref["R"]))
    assert sum(sh.comm_counts.values()) == 0, sh.comm_counts
    _close(sh.all_gather(h, 0, "data"), ref["h"], "slstm h")
    for j, s in enumerate(state):
        _close(sh.all_gather(s, 0, "data"), ref[f"s{j}"], f"slstm state {j}")


CASES = {
    "decode[llama3.2-1b]": lambda d: tp_decode(d, "llama3.2-1b"),
    "decode[granite-moe-1b-a400m]": lambda d: tp_decode(d, "granite-moe-1b-a400m"),
    "decode_whole_rows[llama3.2-1b]": lambda d: whole_rows_decode(d, "llama3.2-1b"),
    "onehot_equals_scatter": lambda d: onehot_equals_scatter(d, "llama3.2-1b"),
    "shard_map_decode[prefix]": lambda d: shard_map_decode(d, "prefix"),
    "shard_map_decode[window]": lambda d: shard_map_decode(d, "window"),
    "slstm_branch": slstm_branch,
    "decode_tokens[llama3.2-1b]": lambda d: decode_tokens(d, "llama3.2-1b"),
    **{f"decode[{a}]": (lambda d, a=a: tp_decode(d, a)) for a in RECURRENT},
    **{f"decode_tokens[{a}]": (lambda d, a=a: decode_tokens(d, a)) for a in RECURRENT},
    **{f"train_step[{a}]": (lambda d, a=a: train_step(d, a)) for a in RECURRENT},
    "train_step[llama3.2-1b]": lambda d: train_step(d, "llama3.2-1b"),
    "train_step[granite-moe-1b-a400m]": lambda d: train_step(d, "granite-moe-1b-a400m"),
    **{f"train_step[llama3.2-1b-{k}]": (lambda d, k=k: train_step(d, "llama3.2-1b", k))
       for k in KNOBS},
    **{f"train_step[granite-moe-1b-a400m-{k}]":
       (lambda d, k=k: train_step(d, "granite-moe-1b-a400m", k)) for k in MOE_KNOBS},
    f"train_step[{ENCDEC}]": lambda d: train_step(d, ENCDEC),
    **{f"train_step[{ENCDEC}-{k}]": (lambda d, k=k: train_step(d, ENCDEC, k))
       for k in ENCDEC_KNOBS},
}


def run(rank: int, world: int, shape: tuple[int, int], cases: list[str], d: str) -> None:
    """One rank: join the gloo group, bind a (data, model) mesh of ``shape``,
    run ``cases``, write the results."""
    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world)
    results = {}
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        for case in cases:
            try:
                arch = case[case.find("[") + 1:-1] if case.startswith("decode") else None
                rules = (shardings.make_rules(get_smoke_config(arch), mesh) if arch else None)
                with sh.use_mesh(mesh, rules):
                    CASES[case](d)
                results[case] = "ok"
            except Exception:  # noqa: BLE001 - reported to the test process
                results[case] = traceback.format_exc()
    finally:
        (d / f"r{rank}.json").write_text(json.dumps(results))
        dist.destroy_process_group()
