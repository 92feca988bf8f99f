"""Build the CUDA sources under csrc/ and the host C++ libraries, and
bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
alone (no PyTorch headers) into `_build/<name>-<hash>.so`, the hash
covering the source, the headers it includes by quotes (`csrc/*.cuh`)
and the flags, so an edited source or header builds anew and an
unchanged one is reused.  The host libraries (`HOST_SOURCES`:
`native/fastparse.cpp`, the TSV parser, the ETL's expanding-history
writer and its CSV reader) take the same path with `g++`.  The first
call of a library builds it; `build()` starts every missing build at
once (one compiler per source) and raises with the compiler's output if
one fails.  Pointers go in as `c_void_p`, with PyTorch's current stream
for the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# host C++ libraries, by name; every other name is csrc/<name>.cu
HOST_SOURCES = {"fastparse": _PKG / "native" / "fastparse.cpp"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C signatures: (argtypes, restype) per exported function
_SIGNATURES: Dict[str, Dict[str, Tuple[tuple, type]]] = {
    "eval_scorer": {
        "clsr_eval_scorer": ((_P,) * 14 + (_I,) * 7 + (_P,), _I),
    },
    "clsr_scan": {
        "clsr_scan_forward": ((_P,) * 19 + (_I,) * 5 + (_P,), _I),
        "clsr_scan_backward": ((_P,) * 28 + (_I,) * 5 + (_P,), _I),
    },
    "train_stats": {
        "clsr_train_stats0": ((_P,) * 8 + (_I,) * 5 + (_P,), _I),
        "clsr_train_stats1": ((_P,) * 11 + (_I,) * 6 + (_P,), _I),
        "clsr_train_stats_max_blocks": ((_I, _I), _I),
    },
    "row_update": {
        # one packed int64 array each (the layouts are in the source)
        "clsr_row_scatter_group": ((_P,), _I),
        "clsr_row_sweep": ((_P,), _I),
    },
    "fastparse": {
        "clsr_vocab_new": ((ctypes.c_char_p, _I64, _P, _I64), _P),
        "clsr_vocab_free": ((_P,), None),
        "clsr_parse_file": ((ctypes.c_char_p, _P, _P, _P,
                             ctypes.c_double), _P),
        "clsr_result_n": ((_P,), _I64),
        "clsr_result_total": ((_P,), _I64),
        "clsr_result_fill": ((_P,) * 12, None),
        "clsr_result_free": ((_P,), None),
        "clsr_expand_lines": ((_P,) * 6 + (_I64, _P, _I64, ctypes.c_uint64)
                              + (ctypes.c_char_p,) * 3, _I64),
        "clsr_csv_read": ((ctypes.c_char_p, ctypes.c_char_p, _I64, _I64),
                          _P),
        "clsr_csv_info": ((_P, _P), None),
        "clsr_csv_fill_ints": ((_P, _I64, _P), None),
        "clsr_csv_fill_codes": ((_P, _I64, _P), None),
        "clsr_csv_strings_bytes": ((_P, _I64), _I64),
        "clsr_csv_fill_strings": ((_P, _I64, _P), None),
        "clsr_csv_free": ((_P,), None),
    },
}
KERNELS = tuple(n for n in _SIGNATURES if n not in HOST_SOURCES)
LIBRARIES = tuple(_SIGNATURES)

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
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


def gxx() -> str:
    """Path of g++ (PATH): the host libraries' compiler."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host libraries cannot be "
                           "built")
    return found


def source(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC / f"{name}.cu")


def _command(name: str, out: Path) -> list:
    src = source(name)
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [gxx(), *GXX_FLAGS, "-o", str(out), str(src)]


def _sources(path: Path, seen: list) -> list:
    """`path` and, depth first, every file it includes by quotes (found
    beside the including file, as nvcc finds it), each once."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_text()):
        _sources(path.parent / inc, seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    src = source(name)
    for path in _sources(src, []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS if src.suffix == ".cu"
                           else GXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every missing library of `names`, all compilers at once;
    return the wall seconds.  Raises with the compiler's output on
    failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs.append((name, out, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: {proc.args[0]} exited "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)    # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`, built on first use."""
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
