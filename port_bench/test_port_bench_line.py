"""The result line's keys, the run's refusals without a card and
without the program, and the check that no process of a run loads the
JAX stack or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, tiny_run

ROOT = os.path.dirname(BENCH)


def test_result_line_has_the_contract_keys():
    import run as R
    run = tiny_run("clsr-taobao.train")
    readings = R.drive(run)
    line = R.result(run, readings)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["checks"]) == {"loss_gap", "grad_gap",
                                   "change_gap_median"}
    json.dumps(line)


def test_traced_line_has_busy_window_and_breakdown():
    import run as R
    run = tiny_run("clsr-taobao.train")
    readings = R.drive(run)
    run.trace = True
    run.trace_summary = dict(busy_s=0.5, window_s=1.0, kernels={},
                             n_kernels=0, device_ops=[["k", 0.5]],
                             idle_gaps=[["h", 0.5]], steps=2)
    line = R.result(run, readings)
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _run(args, cwd):
    return subprocess.run([sys.executable, "port_bench/run.py"] + args,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(["--workload", "clsr-taobao.train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode == 3 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(["--workload", "clsr-taobao.train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_no_jax_in_the_run_or_the_reference():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, reference.model, reference.train\n"
        "import harness.train, harness.trace, harness.roofline\n"
        "import clsr_tpu_torch.training.trainer\n"
        "bad = {m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN)\n"
        "print(sorted(bad))\n" % (BENCH, ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import reference.model, reference.train\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'clsr_tpu_torch', 'clsr_tpu', 'jax'}))\n" % BENCH)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    import run as R
    monkeypatch.setitem(sys.modules, "clsr_tpu_torch_probe",
                        types.ModuleType("clsr_tpu_torch_probe"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.probe",
                        types.ModuleType("jaxlib.probe"))
    assert R.forbidden_modules() == ["jaxlib"]


class _Event:
    """A profiler event as reduce_events reads it."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


def test_trace_window_opens_at_the_first_device_operation():
    from harness import trace as tr
    events = [
        _Event(tr.WINDOW, 0, 1000, annotation=True),
        _Event("cudaGraphLaunch", 10, 390),
        _Event("k1", 400, 600, device=True),
        _Event("k2", 650, 900, device=True),
        _Event("k1", 880, 950, device=True),
        _Event("cudaDeviceSynchronize", 600, 1000),
    ]
    s = tr.reduce_events(events)
    # the window runs from k1's start (400), not the launch before it
    assert s["window_s"] == pytest.approx(600e-9)
    assert s["busy_s"] == pytest.approx(500e-9)
    assert {k: c for k, (c, _) in s["kernels"].items()} == {"k1": 2, "k2": 1}
    assert s["kernels"]["k1"][1] == pytest.approx(270e-9)
    assert s["n_kernels"] == 3
    # gaps: 600-650 inside the synchronize, then 950-1000
    assert [g for _, g in s["idle_gaps"]] == pytest.approx([50e-9, 50e-9])
    assert {n for n, _ in s["idle_gaps"]} == {"cudaDeviceSynchronize"}
