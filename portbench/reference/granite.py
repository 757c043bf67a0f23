"""Plain float32 forward pass of the MoE decoder (granite-moe-1b-a400m's
layout): pre-norm GQA attention with rotary positions, then a token-choice
top-k mixture of SwiGLU experts, tied embeddings.

Serving semantics that the reference reproduces, because they decide which
tokens the model sees and which expert outputs it adds:

* The served model prefills the prompt, then decodes from the prompt's LAST
  token again: the sequence it conditions on is ``prompt + [prompt[-1]] +
  served[:-1]``, and the logits at positions ``S .. S+T-1`` choose the
  ``T`` served tokens (:func:`.common.served_sequence`).
* The experts have a capacity: in the prefill of ``S`` prompt tokens each
  expert takes at most ``C = max(4, int(S * top_k * capacity_factor /
  n_experts))`` (token, choice) pairs, queued in the order of the flattened
  (position, choice) pairs; the pairs past it are dropped (the residual
  passes them unchanged). A decode step routes one token, which never
  fills a queue. So the first ``S`` positions are dispatched with the
  prefill's capacity and every later position keeps all its choices.

Weights are a dict of tensors under the served model's parameter names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, attention, rms_norm


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(4, int(tokens * top_k * cf / n_experts))


def _kept(idx: torch.Tensor, n_experts: int, prefill_len: int, capacity: int) -> torch.Tensor:
    """(S, K) bool: which (position, choice) pairs an expert takes."""
    S, K = idx.shape
    keep = torch.ones((S, K), dtype=torch.bool, device=idx.device)
    head = idx[:prefill_len].reshape(-1)
    onehot = F.one_hot(head, n_experts)
    queue = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(queue, 1, head[:, None])[:, 0]
    keep[:prefill_len] = (pos < capacity).reshape(prefill_len, K)
    return keep


def moe(prec: Precision, cfg: dict, W: dict, pre: str, x: torch.Tensor,
        prefill_len: int) -> torch.Tensor:
    m = cfg["moe"]
    E, K = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ W[pre + "router"].float(), dim=-1)  # router in f32
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    keep = _kept(idx, E, prefill_len, _capacity(prefill_len, K, E, m["capacity_factor"]))
    gate = gate * keep
    y = torch.zeros_like(x)
    for e in range(E):
        rows, choice = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(prec.mm(xe, W[pre + "w_gate"][e])) * prec.mm(xe, W[pre + "w_up"][e])
        y.index_add_(0, rows, prec.mm(h, W[pre + "w_down"][e]) * gate[rows, choice][:, None])
    return y


@torch.no_grad()
def logits(cfg: dict, W: dict, tokens: torch.Tensor, prefill_len: int,
           prec: Precision | None = None) -> torch.Tensor:
    """Logits (S, V) in float32 of ``tokens`` (S,), whose first
    ``prefill_len`` positions were the served prompt."""
    prec = prec or Precision()
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    x = W["embed"][tokens.long()].float()
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}."
        a = pre + "attn."
        x = x + attention(prec, rms_norm(x, W[pre + "ln1"], eps), W[a + "wq"], W[a + "wk"],
                          W[a + "wv"], W[a + "wo"], theta=theta,
                          window=cfg.get("sliding_window"))
        x = x + moe(prec, cfg, W, pre + "mlp.", rms_norm(x, W[pre + "ln2"], eps), prefill_len)
    x = rms_norm(x, W["final_norm"], eps)
    return prec.mm(x, W["embed"].T)
