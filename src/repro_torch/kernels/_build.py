"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and bound with :mod:`ctypes`. The
build runs at first use, from the package's own sources, into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``).
The directory name is a hash of the sources and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. All sources
compile in parallel, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.

``launches`` counts, per kernel, the launches a wrapper has made; ``plain``
counts the calls the dispatcher (:mod:`repro_torch.kernels.ops`) sent to a
kernel's plain PyTorch version; ``backward`` counts the plain-version
recomputations that a kernel's autograd backward made (the flash-attention
kernel has a forward only: its gradient is the plain version's, taken by
autograd). A kernel's second form, one with another output, counts apart in
``form_launches`` and ``form_plain`` (``decode_attention_lse``: K3 with its
log-sum-exp, the local half of the length-sharded flash-decode), so the
counts of the form that serving launches stay as they were.
A run that claims to have gone through the kernels resets them
with :func:`reset_counters` and reads them afterwards.
A CUDA graph counts what it recorded at each replay (:func:`recording`,
:func:`replayed`): its capture runs nothing, so it counts nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

KERNELS = ("matmul", "flash_attention", "decode_attention")
SOURCES = {
    "matmul": "matmul_probe.cu",
    "flash_attention": "flash_attention.cu",
    "decode_attention": "decode_attention.cu",
}
# dtype codes of the C interface, and the head dims the attention kernels
# are instantiated for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 96, 128)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

CSRC = Path(__file__).resolve().parent / "csrc"

FORMS = ("decode_attention_lse",)

launches: dict[str, int] = {name: 0 for name in KERNELS}
plain: dict[str, int] = {name: 0 for name in KERNELS}
backward: dict[str, int] = {name: 0 for name in KERNELS}
form_launches: dict[str, int] = {name: 0 for name in FORMS}
form_plain: dict[str, int] = {name: 0 for name in FORMS}

# what a CUDA graph records and replays
_COUNTERS = {"launches": launches, "plain": plain, "form_launches": form_launches,
             "form_plain": form_plain}

_libs: dict[str, ctypes.CDLL] = {}
last_build_s: float | None = None  # wall time of the last build, None if loaded


def reset_counters() -> None:
    for d in (launches, plain, backward, form_launches, form_plain):
        for name in d:
            d[name] = 0


@contextlib.contextmanager
def recording():
    """Around a CUDA-graph capture: yields a dict that holds, once the block
    has ended, the counts made inside it (``{"launches": {...}, "plain":
    {...}, "form_launches": {...}, "form_plain": {...}}``), and leaves the
    counters as they were before it."""
    counters = _COUNTERS
    before = {key: dict(d) for key, d in counters.items()}
    recorded: dict[str, dict[str, int]] = {}
    try:
        yield recorded
        for key, d in counters.items():
            recorded[key] = {name: d[name] - before[key][name] for name in d}
    finally:
        for key, d in counters.items():
            d.update(before[key])


def replayed(recorded: dict[str, dict[str, int]]) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    for key, d in _COUNTERS.items():
        for name, n in recorded[key].items():
            d[name] += n


def _build_root() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in KERNELS:
        h.update(SOURCES[name].encode())
        h.update((CSRC / SOURCES[name]).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every kernel that is not built yet; returns the directory."""
    global last_build_s
    out = _build_root() / source_hash()
    todo = [n for n in KERNELS if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        # write to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    last_build_s = time.perf_counter() - t0
    return out


_SIGNATURES = {
    # kernel: (C symbol, ctypes argument types; every pointer and the stream is c_void_p)
    "matmul": ("repro_matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "flash_attention": (
        "repro_flash_attention",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
    "decode_attention": (
        "repro_decode_attention",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
}


def kernel(name: str):
    """The C entry point of kernel ``name``, building it on first use."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return getattr(_libs[name], _SIGNATURES[name][0])


def check(name: str, err: int, form: str | None = None) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise (under
    ``form`` in ``form_launches`` when one is given)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if form is None:
        launches[name] += 1
    else:
        form_launches[form] += 1
