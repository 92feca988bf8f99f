"""Build the CUDA sources under csrc/ and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
alone (no PyTorch headers) into `_build/<name>-<hash>.so`, the hash
covering the source and the flags, so an edited source builds anew and
an unchanged one is reused.  The first CUDA call of a kernel builds it;
`build()` starts every missing build at once (one `nvcc` per source).
Pointers go in as `c_void_p`, with PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# shared memory a block may use on an H100 (bytes)
MAX_SMEM = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: (argtypes, restype) per exported function
_SIGNATURES: Dict[str, Dict[str, Tuple[tuple, type]]] = {
    "eval_scorer": {
        "clsr_eval_scorer": ((_P,) * 14 + (_I,) * 7 + (_P,), _I),
    },
    "clsr_scan": {
        "clsr_scan_forward": ((_P,) * 18 + (_I,) * 4 + (_P,), _I),
        "clsr_scan_smem_bytes": ((_I, _I), ctypes.c_longlong),
    },
    "train_stats": {
        "clsr_train_stats0": ((_P,) * 7 + (_I,) * 5 + (_P,), _I),
        "clsr_train_stats1": ((_P,) * 10 + (_I,) * 6 + (_P,), _I),
        "clsr_train_stats_smem_bytes": ((_I, _I, _I), ctypes.c_longlong),
        "clsr_train_stats_chunk_l": ((), _I),
    },
}
KERNELS = tuple(_SIGNATURES)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: PATH, then $CUDA_HOME, then /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every missing library of `names`, all nvcc's at once;
    return the wall seconds.  Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)    # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check_args(names, tensors, shapes, device) -> None:
    """Raise unless every tensor is a contiguous f32 tensor of its shape
    on `device`: what the C entry points take."""
    for name, t, shape in zip(names, tensors, shapes):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
