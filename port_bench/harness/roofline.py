"""Rooflines and model counts, found by name: an op's operations and
bytes in rooflines/<op>.py, a model's counts and kernel launches in
rooflines/model_<model_type>.py, the kernels' profiler names in every
rooflines/names/*.json, the card's peaks in rooflines/peaks.json."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from harness.common import bench_path

_loaded: Dict[str, object] = {}


def module(path: str):
    """A Python file of the benchmark by path, loaded once."""
    if path not in _loaded:
        name = "port_bench_" + re.sub(r"\W", "_", os.path.relpath(
            path, bench_path()))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def op(name: str):
    return module(bench_path("rooflines", f"{name}.py"))


def model(model_type: str):
    return module(bench_path("rooflines", f"model_{model_type.lower()}.py"))


def peaks(device_name: str) -> dict:
    with open(bench_path("rooflines", "peaks.json")) as f:
        table = json.load(f)
    for card in table["cards"].values():
        if any(m in device_name for m in card["match"]):
            return card
    return table["cards"][table["default"]]


def kernel_ops() -> List[Tuple[re.Pattern, str]]:
    out = []
    for path in sorted(glob.glob(bench_path("rooflines", "names",
                                            "*.json"))):
        with open(path) as f:
            out += [(re.compile(p), o) for p, o in json.load(f)["kernels"]]
    return out


def op_of(kernel_name: str, table) -> Optional[str]:
    for pat, name in table:
        if pat.search(kernel_name):
            return name
    return None


def least_seconds(op_name: str, shapes: dict, peak: dict) -> float:
    flops, nbytes = op(op_name).cost(shapes)
    return max(flops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])


def kernel_share(kernels: Dict[str, List[float]], launches: List[tuple],
                 repeats: float, peak: dict) -> Optional[float]:
    """Sum of each mapped op's least time over the sum of its kernels'
    device time, in percent; `launches` are one step's (or dispatch's)
    (op, shapes), run `repeats` times in the traced window.  None when no
    mapped kernel ran."""
    table = kernel_ops()
    spent: Dict[str, float] = {}
    for name, (_, seconds) in kernels.items():
        o = op_of(name, table)
        if o is not None:
            spent[o] = spent.get(o, 0.0) + seconds
    if not spent:
        return None
    least = sum(least_seconds(o, s, peak) for o, s in launches
                if o in spent) * repeats
    return 100.0 * least / sum(spent.values())
