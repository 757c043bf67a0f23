"""Worker side of ``tests/test_torch_distributed.py``: the port's local
program on each rank of a gloo process group on the CPU.

Imports no JAX: the test computes the reference's numbers in its own
process and hands them over as files in a directory (``.npz`` inputs and
expectations, ``.pt`` port weights). Each rank runs every case of its mesh
and writes ``r{rank}.json``, case -> "ok" or the failure's text.
"""
from __future__ import annotations

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

# rtol 1e-5; atol 1e-5 of the largest |value| (logits of about 20 sum
# thousands of f32 products, in another order on each side)
RTOL = 1e-5
STEPS = 8


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=what)


def tp_decode(d: Path, arch: str) -> None:
    """Prefill and STEPS greedy steps on the placed model: logits and tokens
    equal to the reference's unsharded ones on this rank's batch rows."""
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
    # the whole batch's cache, placed: this rank's rows (and split)
    cache, _ = shardings.place_cache(model.init_cache(B, int(ref["max_len"])), cfg, mesh)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    logits = gather_logits(params, logits)
    _close(logits, ref["prefill"][rows], f"{arch} prefill")
    tok = greedy_token(logits[:, -1:])
    for t in range(STEPS):
        np.testing.assert_array_equal(tok.numpy()[:, 0], ref["tokens_out"][t][rows],
                                      err_msg=f"{arch} token {t}")
        logits, cache = model.decode_step(params, cache, tok)
        logits = gather_logits(params, logits)
        _close(logits, ref["steps"][t][rows], f"{arch} step {t}")
        tok = greedy_token(logits)


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
