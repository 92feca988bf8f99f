"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(port_bench/configs/) and a traffic mix (port_bench/traffic/); the mix's
`kind` picks the driver (harness/train.py for `train`).  A run
makes its inputs and weights from the seed, sets up the program
(clsr_tpu_torch), warms up, measures for `--seconds`, checks what the
timed path produced against the plain reference (port_bench/reference/,
limits in port_bench/limits/<cell>.json), and prints one JSON line last
on standard output: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, each read by port_bench/metrics/
<metric>.py.  The numbers compared come last, on standard error and
under the line's `checks` key.

It needs as many CUDA cards as the cell asks for; without them it exits
with code 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)
# every build and kernel cache of the run at fixed paths in the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(BENCH, ".cache", _dir))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clsr_tpu")
# one intra-op CPU thread a process: the host's share of every cell is
# many small operations, where a pool of threads adds only its own noise
HOST_THREADS = 1


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (clsr_tpu_torch is not clsr_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metric_values(run, specs):
    from harness.roofline import module
    out = {}
    for m in specs:
        v = module(os.path.join(BENCH, "metrics", f"{m['name']}.py")
                   ).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def drive(run, fault=None):
    """The cell's driver by its mix's kind; the check's readings."""
    from harness import checks
    kind = run.cell.mix["kind"]
    if kind == "train":
        from harness.train import run_train
        return checks.train_readings(run_train(run, fault))
    raise SystemExit(f"unknown traffic kind {kind!r}")


def result(run, readings):
    """The result line's object; the numbers compared come last."""
    from harness import checks
    cell = run.cell
    judged = checks.judge(readings, cell.limits)
    specs = cell.per_layer if run.trace else cell.end_to_end
    line = {"correct": checks.passed(judged), "attempted": run.attempted,
            "failed": run.failed, "metrics": metric_values(run, specs),
            "device": {"platform": "gpu", "kind": run.device_name,
                       "count": run.cards,
                       "memory_peak_bytes": int(run.memory_peak_bytes)}}
    if run.trace and run.trace_summary:
        t = run.trace_summary
        line["device"]["busy_s"] = t["busy_s"]
        line["device"]["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = judged
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from harness.common import Run, load_cell
    cell = load_cell(args.workload)
    import torch
    torch.set_num_threads(HOST_THREADS)
    if cell.chips != 1:
        print(f"port_bench: {cell.name} asks for {cell.chips} cards; the "
              f"harness drives one; no result", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}; no result", file=sys.stderr)
        return 3
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0),
              t0=T0, device_name=torch.cuda.get_device_name(0))
    readings = drive(run)
    gc.collect()
    line = result(run, readings)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}; no result",
              file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
