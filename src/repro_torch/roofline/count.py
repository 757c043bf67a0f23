"""Per-device FLOP, HBM-byte and collective count of the port's local
program, and the three roofline terms: the counterpart of
``repro.roofline.hlo``, which parses XLA's post-SPMD HLO and has no torch
counterpart.

The port runs each rank's local program (:mod:`repro_torch.distributed.
sharding`), so counting what one rank executes gives per-device numbers
directly. :func:`count` runs a function once under two dispatch modes:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` — 2*M*N*K for every
  matmul-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions),
  what ``analyze_hlo`` counts for every ``dot``;
* HBM bytes (estimate, the reference's documented rule): result bytes x2
  (write + one amortised read) for every op that materialises a result.
  Views, aliases, factories of uninitialised memory (``empty``) and
  collectives move none here; an in-place op's result is the tensor it
  writes (a per-layer cache view, so the whole cache counts once a step, as
  the reference counts an in-place dynamic-update-slice once a loop);
* collective wire bytes: the port's own collective calls count them
  (``sharding.comm_counts`` / ``comm_bytes``), each result's bytes times the
  reference's algorithm factor (all-reduce 2(g-1)/g; all-gather,
  reduce-scatter and all-to-all (g-1)/g; collective-permute 1).

It also tracks the peak of the bytes the op results hold alive at once
(``temp_bytes``): an estimate of a step's working memory beyond its
arguments. The function may run on ``meta`` tensors, which allocate
nothing, so a full-size configuration is counted on a host.

``count(..., scan_once=True)`` counts a sequential scan as the reference's
counter counts a while loop, its body times its trip count: a scan that asks
:func:`scans_once` runs one step through :func:`step_counted` (the sLSTM's
per-token loop and the chunk loops of the SSD and the mLSTM,
``models.ssm``), which counts it and its backward ``n`` times, so a long
sequence is counted in the time of one step.

:class:`Roofline` takes the chip's peaks as an argument; its default is one
NVIDIA H100 SXM5 by its data sheet (dense bf16, HBM3, NVLink 4). No TPU
figure is used.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..distributed import sharding as sh

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_"}


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A chip's peak rates: FLOP/s, HBM bytes/s and link bytes/s."""
    flops: float
    hbm_bytes: float
    link_bytes: float
    name: str = ""


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 (tensor cores),
# 3.35 TB/s HBM3, NVLink 4 at 900 GB/s in both directions (450 GB/s each way)
H100_SXM5 = Peaks(flops=989e12, hbm_bytes=3.35e12, link_bytes=450e9,
                  name="NVIDIA H100 SXM5 (data sheet)")


@dataclasses.dataclass
class CountStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in sh.COLLECTIVES})
    count_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in sh.COLLECTIVES})
    dot_count: int = 0
    temp_bytes: int = 0
    repeated_flops: float = 0.0  # what repeated() adds to the flop counter's total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Result bytes x2 of every materialising op, the matmul-like ops, and the
    peak of the result bytes alive at once."""

    def __init__(self, stats: CountStats) -> None:
        super().__init__()
        self.stats = stats
        self.live = 0

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            return out
        if name in _MATMULS:
            self.stats.dot_count += 1
        if func.is_view or name in _NO_BYTES:
            return out
        mutated = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = _nbytes(t)
                self.stats.hbm_bytes += 2.0 * n
                if not mutated:
                    self.live += n
                    weakref.finalize(t, self._release, n)
        self.stats.temp_bytes = max(self.stats.temp_bytes, self.live)
        return out


# (stats, flop counter) of the count() that counts a scan once, or None
_SCAN_ONCE: Optional[tuple] = None


def scans_once() -> bool:
    """Whether a scan may run one step under :func:`repeated` in place of
    its loop: inside ``count(..., scan_once=True)``."""
    return _SCAN_ONCE is not None


@contextlib.contextmanager
def repeated(n: int):
    """Count what the enclosed region executes ``n`` times (0: not at all):
    its FLOPs, HBM bytes, matmul-like ops and collectives (inside
    ``count(..., scan_once=True)``; elsewhere nothing is counted)."""
    if _SCAN_ONCE is None:
        yield
        return
    stats, flop_mode = _SCAN_ONCE
    before = (flop_mode.get_total_flops(), stats.hbm_bytes, stats.dot_count,
              dict(sh.comm_counts), dict(sh.comm_bytes))
    yield
    k = n - 1
    stats.repeated_flops += k * (flop_mode.get_total_flops() - before[0])
    stats.hbm_bytes += k * (stats.hbm_bytes - before[1])
    stats.dot_count += k * (stats.dot_count - before[2])
    for kind in sh.COLLECTIVES:
        sh.comm_counts[kind] += k * (sh.comm_counts[kind] - before[3][kind])
        sh.comm_bytes[kind] += k * (sh.comm_bytes[kind] - before[4][kind])


class _Counted(torch.autograd.Function):
    """``fn(*inputs)`` whose forward and backward each count ``n`` times. The
    backward recomputes the step's graph uncounted (a remat region's saved
    tensors would each recompute the whole region), then counts its
    gradient ``n`` times, as a middle step's: of every output and with
    respect to every input, the carried state too (the last step's state
    has no gradient, the first step's initial state needs none)."""

    @staticmethod
    def forward(ctx, fn, n, *inputs):
        ctx.fn, ctx.n = fn, n
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        with repeated(n):
            return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.is_floating_point()) for t in ctx.saved_tensors]
        with torch.enable_grad(), repeated(0):
            outputs = tuple(ctx.fn(*inputs))
            grads = [torch.zeros_like(o) if g is None else g for o, g in zip(outputs, grads)]
        pairs = [(o, g) for o, g in zip(outputs, grads) if o.requires_grad]
        wanted = [t for t in inputs if t.requires_grad]
        got = [None] * len(wanted)
        if pairs and wanted:
            with repeated(ctx.n):
                got = torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                          allow_unused=True)
        got = iter(got)
        return (None, None) + tuple(next(got) if t.requires_grad and need else None
                                    for t, need in zip(inputs, ctx.needs_input_grad[2:]))


def step_counted(fn, n: int, *inputs: torch.Tensor) -> tuple:
    """One step of a scan, ``fn(*inputs)`` (tensors -> a tuple of tensors),
    counted ``n`` times, and its backward ``n`` times where autograd records
    it: for a scan that :func:`scans_once`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Counted.apply(fn, n, *inputs)
    with repeated(n):
        return tuple(fn(*inputs))


def count(fn, *args, scan_once: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count what this rank executed.
    Returns (its result, :class:`CountStats`). Resets the collective counters.
    ``scan_once``: a scan counts one step times its trip count (the values
    it returns are then not the scan's: for ``meta`` tensors)."""
    global _SCAN_ONCE
    stats = CountStats()
    sh.reset_comm_counters()
    flop_mode = FlopCounterMode(display=False)
    prev = _SCAN_ONCE
    with flop_mode, _ByteCounter(stats):
        _SCAN_ONCE = (stats, flop_mode) if scan_once else None
        try:
            out = fn(*args, **kwargs)
        finally:
            _SCAN_ONCE = prev
    stats.flops = float(flop_mode.get_total_flops()) + stats.repeated_flops
    stats.count_by_kind = dict(sh.comm_counts)
    stats.bytes_by_kind = dict(sh.comm_bytes)
    stats.collective_bytes = float(sum(sh.comm_bytes.values()))
    return out, stats


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device FLOPs of the local program
    hbm_bytes: float           # per-device HBM traffic estimate
    collective_bytes: float    # per-device wire bytes
    chips: int
    model_flops: float         # analytic 6*N*D (train) / 2*N*tokens (infer)
    stats: Optional[CountStats] = None
    peaks: Peaks = H100_SXM5

    @property
    def t_compute(self) -> float:
        return self.flops / self.peaks.flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.peaks.hbm_bytes

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.peaks.link_bytes

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        if total == 0:
            return float("nan")
        return self.model_flops / total

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "peaks": dataclasses.asdict(self.peaks),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_counts": self.stats.count_by_kind if self.stats else {},
            "collective_bytes_by_kind": self.stats.bytes_by_kind if self.stats else {},
            "dot_count": self.stats.dot_count if self.stats else 0,
        }
