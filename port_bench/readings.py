"""The readings a cell's limits are set from, on the card at the cell's
own size (port_bench/limits/<cell>.json records them):

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 \
        [--faults]

For each seed, in one process: the program's numbers from a run with a
short window (the check needs none), and the control's: the plain
reference computed in TF32, the nearest precision below the
configuration's float32, in the program's place.  With `--faults`, the
numbers of the reference on the first half of each batch (half of the
batch left out, the mean over the rest).  A state left unchanged reads 1
by the train measure and needs no run.  One JSON line a seed, with the
leaves that set each number.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import checks  # noqa: E402
from harness.common import Run, load_cell  # noqa: E402


def leaves(prog, ref, keep=None, top=3):
    names = keep if keep is not None else sorted(ref)
    med = float(np.median([ref[n] for n in names]))
    gaps = sorted(((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
                   for n in names), reverse=True)[:top]
    return [[n, g, prog[n], ref[n]] for g, n in gaps]


def train_seed(run, faults):
    from harness.train import reference_readings, run_train
    r = run_train(run)
    out = {"program": checks.train_readings(r)}
    keep = checks.moving_leaves(r["ref_first"])
    out["program_leaves"] = {
        "grad": leaves(r["first"], r["ref_first"]),
        "change": leaves(r["change"], r["ref_change"], keep)}
    out["losses"] = [r["losses"], r["ref_losses"]]
    variants = [("control", dict(tf32=True))]
    if faults:
        variants.append(("half_batch", dict(half=True)))
    for name, kw in variants:
        v = reference_readings(r["ref_in"], run.device, **kw)
        as_prog = dict(r, losses=v["ref_losses"], first=v["ref_first"],
                       change=v["ref_change"])
        out[name] = checks.train_readings(as_prog)
        out[name + "_leaves"] = {
            "grad": leaves(v["ref_first"], r["ref_first"]),
            "change": leaves(v["ref_change"], r["ref_change"], keep)}
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--faults", action="store_true")
    a = p.parse_args()
    cell = load_cell(a.workload)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    for s in (int(x) for x in a.seeds.split(",")):
        run = Run(cell=cell, seed=s, seconds=a.seconds, trace=False,
                  device=dev, t0=time.perf_counter(), device_name=name)
        t = time.perf_counter()
        out = train_seed(run, a.faults)
        out.update(seed=s, workload=a.workload, s=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
