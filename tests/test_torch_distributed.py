"""The port's multi-rank local program against ``repro``'s unsharded numbers,
on gloo process groups of 2 and 4 ranks on the CPU.

This process computes the reference with JAX (smoke configs, f32) and hands
it to the ranks as files; the ranks (``tests/_torch_dist_workers.py``, no
JAX) run the port's placed models on ``(data, model)`` meshes of shape
``(1, m)`` (tensor parallel: heads, ff columns, experts and vocab split;
with 4 ranks llama's cache splits over head_dim, with 2 over kv heads) and
``(2, 2)`` (data and tensor parallel at once), and hold:

- prefill logits and 8 greedy decode steps of llama3.2-1b and
  granite-moe-1b-a400m: rtol 1e-5, atol 1e-5 of the largest |logit|,
  tokens identical;
- ``DECODE_ATTN_MODE = "shard_map"`` over a length-sharded cache (a slice
  with no valid row, one straddling ``valid``, and a window ring): the step
  and the caches equal ``repro``'s local ``decode_attention_step``;
- llama3.2-1b on (1, 4) placed as on the card (``shardings._whole_kv_rows``
  patched true): its cache along its length in place of head_dim, every
  step through the length-sharded flash-decode, the same logits and tokens;
- the sLSTM cell on each data rank's batch block (the local program is
  ``repro``'s shard_map branch): ``repro``'s ``slstm_scan``;
- ``CACHE_UPDATE_MODE = "onehot"``: the scatter update's logits, bitwise;
- ``Model.decode_tokens`` itself on (1, 2), where llama's logits split over
  the vocab: ``repro``'s greedy tokens;
- one train step (``train.loop.make_train_step``) of llama3.2-1b and
  granite-moe-1b-a400m on (2, 2), tensor and data parallel, a whole batch
  of 4 rows, the clip binding (``clip_norm`` 0.1 of the reference's norm):
  ``repro``'s loss, ``grad_norm``, every gradient and every parameter after
  ``repro``'s AdamW step, gathered; and llama's step under each of the
  dry-run's knobs (``dp_only``, ``fsdp``, both at once (ZeRO-1),
  ``seq_parallel``, and ``accum_steps`` 2 against ``repro``'s mean over its
  two micro-batches), and granite's under ``fsdp`` and ``seq_parallel``
  (the MoE's router and aux read the whole sequence); whisper-small's step
  (64 frames, f32 frames in the batch) as it is and under ``fsdp`` and
  ``seq_parallel`` (the encoder's frames split too, its output gathered for
  every cross-attention). Tolerances as above, each tensor against its own
  largest |value|; AdamW's eps as ``_torch_dist_workers.TRAIN_EPS`` says.

The recurrent families run their own tensor-parallel program (the smoke
zamba2-1.2b and xlstm-1.3b, on (1, 2) and (2, 2), zamba2 also on (1, 4)).
At the smoke width every seam of that program falls inside a block:
zamba2 has d_inner 512, 32 heads of P 16 and conv_dim 544, so a rank's
block of the conv channels (272 or 136) is not its heads' channels (256 or
128) and the packed projection [x, z, B, C, dt] is cut inside x; its shared
attention (4 heads, 2 kv heads) splits over kv heads on 2 ranks and its
cache over head_dim on 4. xlstm has d_inner 512 and mLSTM heads of P 128
(the sLSTM's P is 64): at 2 ranks one rank holds all of ``w_up``'s ``a``
columns and the other all of ``z``, and ``wq``/``wk``/``wv`` split on their
input P axis. Each holds the prefill and the 8 greedy steps to the
reference's unsharded logits (the rule above) and tokens, each step's
collectives by kind against counts derived by hand, and no parameter block
all-gathered over the model axis; ``Model.decode_tokens`` on (1, 2); and on
(2, 2) one train step as above (the same guard on every train case).

Each mesh's ranks are spawned once for the cases above and once for the
recurrent families, with a join timeout of their own.
"""
import _torch_cpu  # noqa: F401
import json
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as workers
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro.models.ssm import slstm_scan as jax_slstm_scan
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model

ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
B, S, MAX_LEN = 4, 10, 32
JOIN_TIMEOUT_S = 120

DECODE = [f"decode[{a}]" for a in ARCHS]
SHARD_MAP = ["shard_map_decode[prefix]", "shard_map_decode[window]"]
TRAIN = [f"train_step[{a}]" for a in ARCHS]
KNOBS = ([f"train_step[llama3.2-1b-{k}]" for k in workers.KNOBS]
         + [f"train_step[granite-moe-1b-a400m-{k}]" for k in workers.MOE_KNOBS]
         + [f"train_step[{workers.ENCDEC}]"]
         + [f"train_step[{workers.ENCDEC}-{k}]" for k in workers.ENCDEC_KNOBS])
MESHES = {
    (1, 2): DECODE + ["onehot_equals_scatter", "decode_tokens[llama3.2-1b]"] + SHARD_MAP,
    (1, 4): DECODE + ["decode_whole_rows[llama3.2-1b]"] + SHARD_MAP,
    (2, 2): DECODE + ["slstm_branch"] + TRAIN + KNOBS,
}
ZAMBA, XLSTM = workers.RECURRENT
RECURRENT_MESHES = {
    (1, 2): [f"{c}[{a}]" for a in workers.RECURRENT for c in ("decode", "decode_tokens")],
    (1, 4): [f"decode[{ZAMBA}]"],
    (2, 2): [f"{c}[{a}]" for a in workers.RECURRENT for c in ("decode", "train_step")],
}


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _write_model_refs(d: Path, arch: str) -> None:
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch), device="cpu")
    params = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
    torch.save(params.state_dict(), d / f"{arch}.pt")
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(B, MAX_LEN))
    prefill = np.asarray(logits)[:, -1:]
    tok = np.argmax(prefill[:, 0], axis=-1).astype(np.int32)
    steps, toks = [], []
    for _ in range(workers.STEPS):
        toks.append(tok)
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(tok[:, None]))
        steps.append(np.asarray(logits))
        tok = np.argmax(steps[-1][:, 0], axis=-1).astype(np.int32)
    np.savez(d / f"{arch}.npz", tokens=tokens, max_len=MAX_LEN, prefill=prefill,
             steps=np.stack(steps), tokens_out=np.stack(toks))


def _write_train_refs(d: Path, arch: str) -> None:
    """``repro``'s loss, gradients and one AdamW step from the weights of
    ``_write_model_refs``, on a whole batch of ``TRAIN_B`` rows, with the
    clip binding; for llama also the mean over two micro-batches, as
    ``repro``'s dry-run accumulates. Gradients and parameters go to the
    ranks by the port's names."""
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(17)
    batch = {k: rs.randint(0, jcfg.vocab, (workers.TRAIN_B, workers.TRAIN_S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if jcfg.family == "encdec":
        batch["frames"] = rs.randn(workers.TRAIN_B, jcfg.encoder_frames,
                                   jcfg.d_model).astype(np.float32)

    def value_and_grad(rows):
        b = {k: jnp.asarray(v[rows]) for k, v in batch.items()}
        (loss, _), g = jax.value_and_grad(lambda p: jm.loss(p, b, remat=True), has_aux=True)(jp)
        return loss, g

    tm = build_model(get_smoke_config(arch), device="cpu")
    if not (d / f"{arch}.pt").exists():
        params = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, jp))
        torch.save(params.state_dict(), d / f"{arch}.pt")
    variants = {"": [slice(None)]}
    if arch == "llama3.2-1b":
        half = workers.TRAIN_B // 2
        variants["-accum_steps"] = [slice(0, half), slice(half, None)]
    for suffix, micro in variants.items():
        outs = [value_and_grad(rows) for rows in micro]
        loss = np.mean([float(o[0]) for o in outs])
        grads = jax.tree_util.tree_map(lambda *g: sum(x.astype(jnp.float32) for x in g) / len(g),
                                       *[o[1] for o in outs])
        norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads))))
        opt = JaxAdamW(learning_rate=workers.TRAIN_LR, eps=workers.TRAIN_EPS,
                       clip_norm=workers.CLIP * norm)
        new, _, om = opt.update(grads, opt.init(jp), jp)
        assert float(om["grad_norm"]) > opt.clip_norm, "the clip must bind"
        for name, tree in (("grads", grads), ("params", new)):
            module = load_jax_params(tm.init(1), jax.tree_util.tree_map(np.asarray, tree))
            torch.save(dict(module.named_parameters()), d / f"train_{arch}{suffix}_{name}.pt")
        np.savez(d / f"train_{arch}{suffix}.npz", **batch, loss=loss,
                 grad_norm=float(om["grad_norm"]), clip_norm=opt.clip_norm)


def _write_attention_ref(d: Path, case: str) -> None:
    """One decode step of a 64-row cache: valid prefixes 11 and 41 (with 2
    or 4 slices: one slice past both prefixes, one straddling each), or a
    ring of window 64 written at rows 6 and 2 after wrapping."""
    dm, H, K, hd, rows = 64, 4, 2, 32, 64
    jp = jattn.init_attention(jax.random.PRNGKey(3), dm, H, K, hd, False, jnp.float32)
    lengths = np.array([10, 40] if case == "prefix" else [70, 130], dtype=np.int32)
    window = 0 if case == "prefix" else rows
    x, kc, vc = _np((2, 1, dm), 11), _np((2, K, rows, hd), 12), _np((2, K, rows, hd), 13)
    y, k_new, v_new = jattn.decode_attention_step(
        jp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths),
        rope_theta=1e4, eps=1e-5, window=window or None)
    np.savez(d / f"attn_{case}.npz", wq=np.asarray(jp.wq), wk=np.asarray(jp.wk),
             wv=np.asarray(jp.wv), wo=np.asarray(jp.wo), x=x, k_cache=kc, v_cache=vc,
             lengths=lengths, window=window, y=np.asarray(y), k_new=np.asarray(k_new),
             v_new=np.asarray(v_new))


def _write_slstm_ref(d: Path) -> None:
    xg, R = _np((B, 6, 4, 2, 8), 21), _np((4, 2, 8, 8), 22, 0.3)
    h, state = jax_slstm_scan(jnp.asarray(xg), jnp.asarray(R))
    np.savez(d / "slstm.npz", xg=xg, R=R, h=np.asarray(h),
             **{f"s{j}": np.asarray(s) for j, s in enumerate(state)})


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_refs")
    for arch in ARCHS + workers.RECURRENT:
        _write_model_refs(d, arch)
        _write_train_refs(d, arch)
    _write_train_refs(d, workers.ENCDEC)
    for case in ("prefix", "window"):
        _write_attention_ref(d, case)
    _write_slstm_ref(d)
    return d


_RESULTS: dict = {}


def _spawn(refs_dir: Path, shape: tuple[int, int], meshes: dict = MESHES) -> list[dict]:
    """Run every case of ``shape``'s mesh in ``meshes`` on its ranks once;
    per-rank results."""
    key = (id(meshes), shape)
    if key in _RESULTS:
        return _RESULTS[key]
    world = shape[0] * shape[1]
    d = Path(tempfile.mkdtemp(dir=refs_dir))
    for f in refs_dir.iterdir():
        if f.is_file():
            (d / f.name).symlink_to(f)
    ctx = mp.start_processes(workers.run, args=(world, shape, meshes[shape], str(d)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks of mesh {shape} did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    _RESULTS[key] = [json.loads((d / f"r{r}.json").read_text()) for r in range(world)]
    return _RESULTS[key]


@pytest.mark.parametrize("shape,case", [(s, c) for s, cases in MESHES.items() for c in cases],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_ranks_match_reference(refs, shape, case):
    for rank, res in enumerate(_spawn(refs, shape)):
        assert res[case] == "ok", f"rank {rank} of mesh {shape}:\n{res[case]}"


@pytest.mark.parametrize("shape,case",
                         [(s, c) for s, cases in RECURRENT_MESHES.items() for c in cases],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_recurrent_ranks_match_reference(refs, shape, case):
    for rank, res in enumerate(_spawn(refs, shape, RECURRENT_MESHES)):
        assert res[case] == "ok", f"rank {rank} of mesh {shape}:\n{res[case]}"
