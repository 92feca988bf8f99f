"""Row-update bench: the K4/K5 kernels against PyTorch's row ops.

    python -m clsr_tpu_torch.bench_row_update [--rows N] [--dim D]
        [--ids M] [--reps R] [--calls C] [--block BLOCK] [--only a,b]

Counterpart of scripts/bench_pallas_update.py, which asks whether a
kernel beats the framework's row ops at the compact engine's shapes
(defaults: a 500,000 x 40 f32 table, 58,000 sorted unique ids, slabs of
2,048 rows, 30 applications per call).  Variants:

  torch-set     table.index_copy_(0, ids, rows): one PyTorch call that
                computes the same function (the script's xla-set)
  torch-gather  table.index_select(0, ids) (the script's xla-gather)
  sweep         K4, row_update.sweep_rows: one block per slab of the
                table finds the slab's ids and writes their rows
  rowdma        K5, row_update.scatter_rows: the rows' 16-byte units
                spread over threads

Each call applies R fresh id sets in a row (CUDA events around the call;
the ids are drawn before the timing), and a variant prints the median
over C calls as us per application and ns per row.  The three set
variants must leave bit-identical tables.  Runs on an NVIDIA GPU only.

Two deliberate repairs against the script:
  * its `fresh_ids` (:68-74) promises unique ids but only truncates and
    sorts a skewed draw, so its ids repeat; here M ids are drawn without
    replacement with the same skew (P(id = i) the mass of u**1.3 * (N-1)
    on [i, i+1)), so every variant computes one well-defined function;
  * its rowdma padding rewrites row N-1 with zeros (:275-281); here no
    padding is needed, and ids >= N would be dropped, not written.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from clsr_tpu_torch.ops import row_update

SKEW = 1.3
VARIANTS = ("torch-set", "torch-gather", "sweep", "rowdma")


def fresh_ids(generator: torch.Generator, n_rows: int, n_ids: int
              ) -> torch.Tensor:
    """n_ids unique sorted int32 ids in [0, n_rows - 1), drawn without
    replacement with the skew of floor(u**1.3 * (n_rows - 1)), u uniform:
    low ids (the frequent rows of a frequency-sorted vocab) more often."""
    dev = generator.device
    edges = (torch.arange(n_rows, dtype=torch.float64, device=dev)
             / (n_rows - 1)) ** (1.0 / SKEW)
    ids = torch.multinomial((edges[1:] - edges[:-1]).float(), n_ids,
                            replacement=False, generator=generator)
    return torch.sort(ids.to(torch.int32)).values


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--dim", type=int, default=40)
    ap.add_argument("--ids", type=int, default=58_000,
                    help="unique touched rows (sorted)")
    ap.add_argument("--reps", type=int, default=30,
                    help="applications per timed call")
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--block", type=int, default=2048,
                    help="table rows per slab of the sweep (K4)")
    ap.add_argument("--only", default="",
                    help="comma-separated variant filter")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_row_update: no CUDA device; this bench runs only on "
                 "an NVIDIA GPU")
    only = [s for s in args.only.split(",") if s]
    unknown = set(only) - set(VARIANTS)
    if unknown:
        sys.exit(f"bench_row_update: unknown variants {sorted(unknown)}; "
                 f"choose from {VARIANTS}")
    N, D, M, K = args.rows, args.dim, args.ids, args.reps
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table0 = torch.randn(N, D, generator=g, device=dev) * 0.05
    newrows = torch.randn(M, D, generator=g, device=dev) * 0.05
    # (int32 ids, the int64 copy index_copy_ takes), drawn before timing
    id_sets = [(ids, ids.long()) for ids in
               (fresh_ids(g, N, M) for _ in range(K))]
    smi = card()
    print(f"bench_row_update: N={N} D={D} M={M} unique sorted ids, "
          f"block={args.block}, {K} applications x {args.calls} calls | "
          f"{smi}", flush=True)

    def set_variant(fn):
        table = table0.clone()
        return table, lambda ids, ids64: fn(table, ids, ids64)

    runs = {
        "torch-set": set_variant(
            lambda t, ids, ids64: t.index_copy_(0, ids64, newrows)),
        "torch-gather": (None, lambda ids, ids64: table0.index_select(0,
                                                                      ids)),
        "sweep": set_variant(
            lambda t, ids, ids64: row_update.sweep_rows(t, ids, newrows,
                                                        args.block)),
        "rowdma": set_variant(
            lambda t, ids, ids64: row_update.scatter_rows(t, ids, newrows)),
    }
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    results: Dict[str, Dict[str, float]] = {}
    for label, (table, apply) in runs.items():
        if only and label not in only:
            continue
        times = []
        for c in range(args.calls + 2):        # two warm-up calls
            start.record()
            for ids, ids64 in id_sets:
                out = apply(ids, ids64)
            end.record()
            torch.cuda.synchronize()
            if c >= 2:
                times.append(start.elapsed_time(end) / K)
        per_app_ms = statistics.median(times)
        total = float((table if table is not None else out).sum())
        results[label] = dict(us_per_app=per_app_ms * 1e3,
                              ns_per_row=per_app_ms * 1e6 / M, sum=total)
        print(f"{label:14s} {per_app_ms * 1e3:9.1f}us/app  "
              f"({per_app_ms * 1e6 / M:6.2f}ns/row)  sum={total:.6e}",
              flush=True)
    tables = {k: v[0] for k, v in runs.items()
              if v[0] is not None and k in results}
    if len(tables) > 1:
        ref_name, ref = next(iter(tables.items()))
        for name, t in tables.items():
            if not torch.equal(t, ref):
                raise AssertionError(f"{name} leaves another table than "
                                     f"{ref_name}")
        print(f"set variants {sorted(tables)}: bit-identical tables",
              flush=True)
    print(json.dumps({"bench_row_update": results, "card": smi}), flush=True)
    return results


if __name__ == "__main__":
    main()
