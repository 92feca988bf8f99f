"""The kernels' build cache key (`clsr_tpu_torch.ops._build.library_path`).

A library is reused while its key is unchanged, so the key must cover
every file nvcc reads: the source and the headers it includes by quotes
(`csrc/tf32_mma.cuh`, shared by K1 and K3), nested ones too.  These run
on the CPU: nothing is compiled.
"""

import os

import torch

from clsr_tpu_torch.ops import _build

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("int inner;\n")
    (tmp_path / "other.cu").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)


def test_library_path_sees_included_headers(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert _build.library_path("k") == first          # unchanged: reused
    other = _build.library_path("other")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                    "int h;\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "inner.cuh").write_text("int inner2;\n")
    assert _build.library_path("k") not in (first, second)
    assert _build.library_path("other") == other      # includes nothing


def test_repo_kernels_hash_the_shared_header():
    for name in ("eval_scorer", "train_stats"):
        files = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu",
                                                 [])]
        assert files == [f"{name}.cu", "tf32_mma.cuh"]
