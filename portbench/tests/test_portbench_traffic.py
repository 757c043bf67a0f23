"""The traffic generator: a fixed multiset of lengths for every seed, the
seed's own token ids and order, and the warm-up's shapes."""
from __future__ import annotations

import itertools
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
MIXES = sorted({w["traffic"] for w in SPEC["workloads"]})


def _mix(name):
    return traffic.load(ROOT / "portbench" / "traffic" / f"{name}.json")


def _vocab(name):
    configs = {w["config"] for w in SPEC["workloads"] if w["traffic"] == name}
    cfg = next(c for c in SPEC["configs"] if c["name"] in configs)
    return json.loads((ROOT / cfg["file"]).read_text())["vocab"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_draws_the_same_lengths(name):
    mix = _mix(name)
    n = mix["block"]
    blocks = {}
    for seed in (0, 1, 2**31 + 11, 2**33 + 5):
        reqs = list(itertools.islice(traffic.stream(mix, seed, _vocab(name)), 3 * n))
        for b in range(3):
            block = reqs[b * n:(b + 1) * n]
            shapes = Counter((len(r.prompt), r.new_tokens) for r in block)
            blocks.setdefault(seed, []).append(shapes)
    first = blocks[0][0]
    assert all(c == first for bs in blocks.values() for c in bs)
    assert first == Counter(traffic.block_shapes(mix))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ_in_token_ids_and_order(name):
    mix = _mix(name)
    a = list(itertools.islice(traffic.stream(mix, 5, _vocab(name)), mix["block"]))
    b = list(itertools.islice(traffic.stream(mix, 6, _vocab(name)), mix["block"]))
    a2 = list(itertools.islice(traffic.stream(mix, 5, _vocab(name)), mix["block"]))
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b] or \
        [r.new_tokens for r in a] != [r.new_tokens for r in b]
    ids_a = np.concatenate([r.prompt for r in a])
    assert not np.array_equal(ids_a, np.concatenate([r.prompt for r in b])[:len(ids_a)])
    assert all(np.array_equal(x.prompt, y.prompt) and x.new_tokens == y.new_tokens
               for x, y in zip(a, a2))
    assert all(0 <= r.prompt.min() and r.prompt.max() < _vocab(name) for r in a)


@pytest.mark.parametrize("name", MIXES)
def test_warmup_makes_every_key_of_the_traffic(name):
    mix = _mix(name)
    keys = traffic.shape_keys(mix)
    warm = traffic.warmup_shapes(mix)
    made = {k for st in warm for k in traffic.graph_keys(*st)}
    assert made == keys
    kinds = [k[0] for k in keys]
    assert len(warm) == max(kinds.count("prefill"), kinds.count("decode"))


def test_chat_and_docs_shapes():
    chat, docs = _mix("chat"), _mix("docs")
    assert traffic.shape_keys(chat) == (
        {("prefill", S, 1024) for S in range(512, 897, 64)}
        | {("decode", 1024, tb) for tb in (32, 64, 128)})
    assert traffic.shape_keys(docs) == (
        {("prefill", S, 4096) for S in range(2048, 3841, 256)}
        | {("decode", 4096, tb) for tb in (8, 16)})
    outputs = [T for _, T in traffic.block_shapes(chat)]
    assert outputs != sorted(outputs)  # long prompts do not all get long answers


def test_bad_pairing_is_refused(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps({"block": 4, "pair_stride": 2, "prompt": {}, "output": {}}))
    with pytest.raises(ValueError):
        traffic.load(p)
