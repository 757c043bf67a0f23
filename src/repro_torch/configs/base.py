"""Architecture config schema. One file per assigned architecture lives in
this package; each exports ``CONFIG`` (the exact assigned spec) and the
family-preserving reduced ``smoke()`` variant used by CPU smoke tests."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (deepseek-moe)
    d_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    load_balance_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"         # "mamba2" | "mlstm" | "slstm"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256             # chunked-scan block length
    head_dim: int = 0            # Mamba2 head size P; 0 -> d_state


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | xlstm | hybrid | hybrid_moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False        # qwen3 / chameleon style
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one attention block shared across the depth, applied
    # every `hybrid_attn_every` SSM blocks
    hybrid_attn_every: int = 0
    # xlstm: an sLSTM block every `slstm_every` layers (rest mLSTM)
    slstm_every: int = 0
    # encoder-decoder (whisper): n_layers is the decoder depth
    n_encoder_layers: int = 0
    encoder_frames: int = 1500   # stub conv frontend output length
    # sliding-window attention (enables long_500k for dense archs)
    sliding_window: Optional[int] = None
    # hybrid_moe (granite-4.0-h): each layer's mixer ("mamba" | "attention"),
    # every mixer followed by an MoE FFN; the first n_layers entries are used
    layer_types: tuple[str, ...] = ()
    # granite's multipliers, at values that add no operation: embeddings
    # times embedding_multiplier, each residual branch times
    # residual_multiplier, logits divided by logits_scaling, and the softmax
    # scale attention_multiplier (0 -> 1/sqrt(head_dim))
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    dtype: str = "bfloat16"
    # citation for the assigned config
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def is_decode_capable(self) -> bool:
        return True  # every assigned arch has a decoder

    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (SSM/hybrid native, dense via
        sliding window)."""
        if self.family in ("xlstm", "hybrid"):
            return True
        return self.sliding_window is not None

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (used for 6·N·D roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per = att + 2 * d  # norms
        if self.family == "hybrid_moe":
            di = self.ssm.expand * d
            N = self.ssm.d_state
            H = di // (self.ssm.head_dim or N)
            mamba = (d * (2 * di + 2 * N + H) + (self.ssm.d_conv + 1) * (di + 2 * N)
                     + di * d + di + 3 * H)
            ffn = (self.moe.n_experts + self.moe.n_shared) * 3 * d * self.moe.d_expert \
                + d * self.moe.n_experts
            kinds = self.layer_types[:self.n_layers]
            n_attn = sum(k == "attention" for k in kinds)
            return int(emb + d + n_attn * att + (len(kinds) - n_attn) * mamba
                       + len(kinds) * (ffn + 2 * d))
        if self.moe is not None:
            routed = self.moe.n_experts * 3 * d * self.moe.d_expert
            shared = self.moe.n_shared * 3 * d * self.moe.d_expert
            router = d * self.moe.n_experts
            per += routed + shared + router
        elif self.family == "xlstm":
            ex = 2 * d  # expand factor 2 internal dim
            n_sl = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_ml = self.n_layers - n_sl
            P = ex // max(self.n_heads, 1)
            per_ml = d * 2 * ex + 3 * self.n_heads * P * P + 2 * ex * self.n_heads + ex * d + 3 * d
            per_sl = 4 * d * d + 4 * d * (d // max(self.n_heads, 1)) + d * d + 3 * d
            total = emb + n_ml * per_ml + n_sl * per_sl
            return int(total)
        elif self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            N = self.ssm.d_state
            H = di // N
            per = (
                d * (2 * di + 2 * N + H)          # in_proj
                + self.ssm.d_conv * (di + 2 * N)  # conv
                + di * d                          # out_proj
                + di + 3 * d                      # norms
            )
            total = emb + self.n_layers * per
            if self.hybrid_attn_every:
                total += att + 3 * d * self.d_ff + 2 * d  # one shared block
            return int(total)
        elif self.d_ff:
            per += 3 * d * self.d_ff  # SwiGLU
        total = emb + self.n_layers * per
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (att + 2 * d + 3 * d * self.d_ff)
            total += self.n_layers * (att + d)  # decoder cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        routed_all = self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_expert
        routed_act = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert
        return self.param_count() - routed_all + routed_act


def smoke_variant(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Family-preserving reduced config: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, max(1, heads // 2))
    while heads % kv:
        kv -= 1
    changes = dict(
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            d_expert=min(cfg.moe.d_expert, 128),
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, chunk=32)
    if cfg.n_encoder_layers:
        changes["n_encoder_layers"] = 2
        changes["encoder_frames"] = 64
    if cfg.slstm_every:
        changes["slstm_every"] = 2
    if cfg.hybrid_attn_every:
        changes["hybrid_attn_every"] = 2
    if cfg.sliding_window:
        changes["sliding_window"] = min(cfg.sliding_window, 64)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
