"""What every cell's run shares: the manifest, a cell's configuration
and traffic files found by name, and the run's context."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# the sections of a configuration file that hold the model's keys
CONFIG_SECTIONS = ("data", "model", "train", "info", "implied", "execution")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def bench_path(*parts: str) -> str:
    return os.path.join(BENCH_DIR, *parts)


def load_json(*parts: str) -> dict:
    with open(bench_path(*parts)) as f:
        return json.load(f)


def load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def flat_config(raw: dict) -> Dict[str, Any]:
    """The model's keys, sections dropped (the reference's flat_config),
    with its yaml spellings: EARLY_STOP, enable_BN."""
    flat: Dict[str, Any] = {}
    for sec in CONFIG_SECTIONS:
        flat.update(raw.get(sec) or {})
    return flat


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read."""

    name: str
    chips: int
    config_path: str
    cfg: Dict[str, Any]         # flat keys, for the reference
    tables: Dict[str, int]
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, man: Optional[dict] = None) -> Cell:
    man = man or manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    path = os.path.join(ROOT, conf["file"])
    raw = load_yaml(path)
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in man["per_layer"]
             if "workloads" not in m or name in m["workloads"]]
    limits_file = bench_path("limits", f"{name}.json")
    limits = {}
    if os.path.exists(limits_file):
        limits = {k: v["limit"] for k, v in
                  load_json("limits", f"{name}.json")["limits"].items()}
    return Cell(name=name, chips=w["chips"], config_path=path,
                cfg=flat_config(raw), tables=dict(raw["tables"]),
                mix=load_json("traffic", f"{w['traffic']}.json"),
                limits=limits, end_to_end=e2e, per_layer=layer)


@dataclasses.dataclass
class Run:
    """One run's inputs and what it measured, for the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    t0: float = 0.0              # the process's start, perf_counter
    device_name: str = ""
    cards: int = 1
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # measured
    setup_s: float = 0.0
    window_s: float = 0.0
    work: float = 0.0            # examples or candidates in the window
    calls: int = 0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window_peak_bytes: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    shapes: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None

    @property
    def rate(self) -> float:
        return self.work / self.window_s if self.window_s > 0 else 0.0


class Phases:
    """Set-up's phases on standard error: each one's seconds since the
    last, from the process's start."""

    def __init__(self, t0: float):
        self.last = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"setup {name}: {now - self.last:.3f} s", file=sys.stderr)
        self.last = now
