"""Assigned input shapes and allocation-free stand-ins for the dry-run, the
port of ``repro.launch.specs``.

Decode shapes run ``decode_step`` (ONE new token against a seq_len KV
cache / recurrent state), not a train step. ``long_500k`` is only emitted
for architectures with a sub-quadratic path (SSM/hybrid native; dense via
the sliding-window variant); whisper-small skips it (DESIGN.md §4). The
stand-ins are ``meta`` tensors: shapes and dtypes, no memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..models.model import build_model


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and cfg.family == "encdec":
        return False, (
            f"{cfg.arch_id}: encoder-decoder with full cross-attention and a "
            "448-token decoder — a sub-quadratic long-context variant is not "
            "meaningful (DESIGN.md §4)"
        )
    return True, ""


def config_for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k on dense/MoE/VLM archs runs the documented sliding-window
    VARIANT (w=4096) — the sub-quadratic path; SSM/hybrid run natively."""
    if (
        shape_name == "long_500k"
        and cfg.sliding_window is None
        and cfg.family in ("dense", "moe", "vlm")
    ):
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def input_specs(cfg: ArchConfig, shape_name: str) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of the step kind, at the
    global shapes.

    Returns {"kind", "batch": dict of meta tensors, "cache": dict or None}.
    No memory is allocated.
    """
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    meta = torch.device("meta")

    def sds(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=meta)

    if shp.kind == "train":
        batch: dict[str, Any] = {"tokens": sds((B, S)), "labels": sds((B, S))}
        if cfg.family == "encdec":
            batch["frames"] = sds((B, cfg.encoder_frames, cfg.d_model), torch.float32)
        return {"kind": "train", "batch": batch, "cache": None}

    model = build_model(cfg, device=meta)
    if shp.kind == "prefill":
        if cfg.family == "encdec":
            batch = {"frames": sds((B, cfg.encoder_frames, cfg.d_model), torch.float32)}
        else:
            batch = {"tokens": sds((B, S))}
        return {"kind": "prefill", "batch": batch, "cache": model.init_cache(B, S)}

    # decode: one token against a seq_len cache
    return {"kind": "decode", "batch": {"tokens": sds((B, 1))},
            "cache": model.init_cache(B, S)}
