"""The port's multi-rank scaling model, from its own collective bytes and
its own H100 step times.

    python -m clsr_tpu_torch.scaling_model [--configs taobao,kuaishou]
        [--md] [--nvlink_gbps 450] [--ib_gbps 50]

Counterpart of scripts/scaling_model.py, whose bytes come from the
compiled HLO (clsr_tpu/utils/hlo_bytes.py).  The port calls its
collectives itself, so it counts them (parallel/collectives.py
`count_collectives`): one lazyadam train step of CLSR at clsr.yaml's
widths, at each topology of the config, in a gloo world of d x m ranks
on the CPU (parallel/distributed.py `run_local_world`), the bytes a rank
receives grouped by the mesh's group labels, 'model', 'data' and
'world' (parallel/mesh.py `make_mesh`).  The configurations are JAX's
(scripts/scaling_model.py:48-85: L, the per-rank batch, the meshes, the
merge routing; owner routing under `drop`, as JAX counts it), with
tables of the config's counts capped at 32,768 rows: no wire shape
depends on a table's rows, only whether m divides them.

Where the model departs from JAX's:

  * the bytes are the port's: its all_reduce is an all_gather summed in
    rank order (bit-reproducible), so a rank receives (g - 1) x the
    payload where hlo_bytes' ring all_reduce counts 2 (g - 1) / g x;
  * no loop multiplier and no "as compiled" column: the port issues no
    collective inside the recurrence;
  * the bytes are affine in the per-rank batch b, not linear: the dense
    gradients' all_reduce, the BN statistics and the loss parts are the
    same at any b.  The step is counted at two small b and the line
    through them read at the config's b (JAX compiles at one b and
    rescales linearly, :153-154, which would multiply that fixed part by
    B_dev / b);
  * t1 is the port's graphed one-rank lazyadam step at the config's
    per-rank batch and L (STEP_MS, measured by chip_smoke.py phase 22
    (a)), and the strong-scaling floor is K2's measured forward plus
    backward microseconds a dependent step times L (the three cells run
    side by side in K2), not JAX's TPU figures;
  * links (stated data-sheet assumptions, flags): NVLink 4 inside a
    host, 450 GB/s a direction a GPU (the H100 SXM's 900 GB/s counts
    both directions), and across hosts one 400 Gb/s NDR InfiniBand NIC
    a GPU, 50 GB/s, as in a DGX H100.  Hosts split the data axis
    (ranks process-major), so on two hosts the 'data' and 'world' bytes
    cross InfiniBand and the 'model' bytes stay on NVLink, as JAX
    assumes; a mesh with one data index spans no second host.

JAX's efficiencies, and where their formulas hold for the port:

  * weak (the per-rank batch kept): t1 / (t1 + t_coll).  It holds, and
    tighter than for JAX: every collective runs on the step's stream
    inside its graph, overlapped with nothing;
  * strong (the global batch split over n ranks): t1 / (n (max(t1 / n,
    floor) + t_coll(b / n))), with the bytes read at the shard's batch
    b / n (affine), where JAX divides every byte by n.  t1 / n assumes
    the step's compute splits linearly, which a GPU step at a small
    batch does not (launches and fixed work): an upper bound;
  * the merge-overlap column (two hosts, cross-host bytes hidden under
    up to one step): an upper bound the port does not reach as built,
    since nothing overlaps inside its graph; printed beside JAX's.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the card every measured constant below comes from, as
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# t1: the graphed one-rank lazyadam compact step (clsr.yaml's widths and
# kernel gates, tables at the config's counts) at the config's per-rank
# batch and L, ms: the median of 8 replays of chip_smoke.py phase 22 (a)
# on CARD (Taobao 10.644-11.443 ms, Kuaishou 19.998-21.563 ms)
STEP_MS: Dict[str, Optional[float]] = {"taobao": 11.263, "kuaishou": 21.219}
# K2's device microseconds a dependent step at B = 400, L = 50 on CARD,
# by CUDA graph replay (chip_smoke.py phase 7): the forward kernel
# (0.0736 ms / 50) and the backward kernel (0.1483 ms / 50)
K2_FWD_US, K2_BWD_US = 1.47, 2.97
NVLINK_GBPS, IB_GBPS = 450.0, 50.0      # a direction a GPU (data sheets)

CONFIGS = {
    "taobao": dict(
        n_items=100_000, n_cates=5_000, n_users=8_000, L=50, B_dev=512,
        meshes=[(2, 1), (4, 1), (8, 1)], routing="broadcast"),
    "kuaishou": dict(
        n_items=500_000, n_cates=2_000, n_users=100_000, L=250, B_dev=256,
        meshes=[(1, 2), (2, 2), (4, 2)], routing="owner"),
    "taobao8": dict(
        n_items=100_000, n_cates=5_000, n_users=8_000, L=50, B_dev=512,
        meshes=[(8, 1), (8, 1, "owner", 1.0), (4, 2, "owner", 1.0),
                (2, 4, "owner", 1.0)], routing="broadcast", t1="taobao"),
    "kuaishou8": dict(
        n_items=500_000, n_cates=2_000, n_users=100_000, L=250, B_dev=256,
        meshes=[(4, 2, "owner", 1.0), (2, 4, "owner", 1.0),
                (8, 1, "owner", 1.0)], routing="owner", t1="kuaishou"),
}
ROWS_CAP = 1 << 15
COUNT_B = (4, 8)            # the per-rank batches the bytes are counted at
GROUPS = ("model", "data", "world")


def table_rows(sc: dict) -> Tuple[int, int, int]:
    """(users, items, cates) rows of the counting step's tables."""
    return tuple(min(sc[k], ROWS_CAP)
                 for k in ("n_users", "n_items", "n_cates"))


def step_config(sc: dict, d: int, m: int, b: int,
                routing: Optional[str] = None, capacity: float = 1.5):
    """clsr.yaml's config for one counting step: a per-rank batch of b
    rows on a d x m mesh, lazyadam, owner routing under `drop`."""
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    return load_config(
        os.path.join(CONFIG_DIR, "clsr.yaml"), user_vocab="u",
        item_vocab="i", cate_vocab="c", seed=0, batch_size=b * d * m,
        max_seq_length=sc["L"], optimizer="lazyadam", data_parallel=d,
        model_parallel=m, mesh_update_routing=routing or sc["routing"],
        mesh_owner_overflow="drop", mesh_owner_capacity=capacity,
        train_steps_per_call=1, show_step=0, save_model=False)


def seeded_batch(cfg, sizes: Tuple[int, int, int], seed: int = 0):
    """A global batch of cfg.batch_size positives (the step draws the
    negatives), lengths 1..L, ids uniform over the tables' rows."""
    from clsr_tpu_torch.data.batch import Batch
    rng = np.random.RandomState(seed)
    B, L = cfg.batch_size, cfg.max_seq_length
    n_users, n_items, n_cates = sizes
    mask = (np.arange(L)[None] < rng.randint(1, L + 1, B)[:, None])
    mask = mask.astype(np.float32)
    hist = lambda n: (rng.randint(1, n, (B, L)) * mask).astype(np.int32)
    times = lambda: torch.from_numpy((rng.rand(B, L) * mask)
                                     .astype(np.float32))
    return Batch(
        users=torch.from_numpy(rng.randint(0, n_users, B).astype(np.int32)),
        items=torch.from_numpy(rng.randint(1, n_items, (B, 1))
                               .astype(np.int32)),
        cates=torch.from_numpy(rng.randint(1, n_cates, (B, 1))
                               .astype(np.int32)),
        labels=torch.ones(B, 1), item_hist=torch.from_numpy(hist(n_items)),
        cate_hist=torch.from_numpy(hist(n_cates)),
        mask=torch.from_numpy(mask), time_diff=times(),
        time_from_first=times(), time_to_now=times(), valid=torch.ones(B))


def count_step_calls(cfg, sizes: Tuple[int, int, int], seed: int = 0
                     ) -> list:
    """On one rank of a world of cfg's d x m ranks: one mesh train step of
    cfg's model (tables of `sizes` rows, from cfg's seed) on this rank's
    shard of `seeded_batch`, on the CPU; the collectives it made
    (parallel/collectives.py `Call`s)."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.parallel.collectives import count_collectives
    from clsr_tpu_torch.parallel.mesh import (make_mesh, place_model,
                                              shard_batch)
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step
    mesh = make_mesh(cfg)
    model = get_model_class(cfg.model_type)(cfg, *sizes, device="cpu")
    place_model(model, mesh)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, mesh)
    batch = shard_batch(seeded_batch(cfg, sizes, seed), mesh)
    with count_collectives() as calls:
        step(state, batch, torch.Generator().manual_seed(seed))
    return calls


def by_group(calls) -> Dict[str, int]:
    """The bytes received, by group label."""
    out = dict.fromkeys(GROUPS, 0)
    for c in calls:
        out[c.group] = out.get(c.group, 0) + c.received_bytes
    return out


def _count_rank(rank, device, jobs):
    return {key: by_group(count_step_calls(cfg, sizes))
            for key, (cfg, sizes) in jobs.items()}


def mesh_entry(sc: dict, entry: tuple) -> Tuple[int, int, str, float]:
    """(d, m, routing, capacity) of a CONFIGS mesh entry."""
    d, m = entry[0], entry[1]
    return (d, m, entry[2] if len(entry) > 2 else sc["routing"],
            entry[3] if len(entry) > 3 else 1.5)


def count_configs(names: List[str]) -> Dict[tuple, Dict[int, dict]]:
    """{(config, d, m, routing, capacity): {b: bytes by group}} for each
    mesh of the named configs at each b of COUNT_B: one gloo world a
    world size, the worlds side by side, every rank's count, the largest
    a group over the ranks."""
    import concurrent.futures
    from clsr_tpu_torch.parallel.distributed import run_local_world
    jobs: Dict[int, dict] = {}
    for name in names:
        sc = CONFIGS[name]
        for entry in sc["meshes"]:
            d, m, routing, cap = mesh_entry(sc, entry)
            for b in COUNT_B:
                jobs.setdefault(d * m, {})[(name, d, m, routing, cap, b)] = (
                    step_config(sc, d, m, b, routing, cap), table_rows(sc))
    out: Dict[tuple, Dict[int, dict]] = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        worlds = {n: pool.submit(run_local_world, _count_rank, n, "gloo",
                                 "cpu", (world_jobs,), 1800.0)
                  for n, world_jobs in jobs.items()}
    for n, world_jobs in sorted(jobs.items()):
        ranks = worlds[n].result()
        for key in world_jobs:
            out.setdefault(key[:-1], {})[key[-1]] = {
                g: max(r[key].get(g, 0) for r in ranks) for g in
                set().union(*(r[key] for r in ranks))}
    return out


def bytes_at(counted: Dict[int, dict], b: float) -> Dict[str, float]:
    """Each group's bytes at a per-rank batch b: the line through the two
    counted batches."""
    (b1, y1), (b2, y2) = sorted(counted.items())
    return {g: y1.get(g, 0) + (y2.get(g, 0) - y1.get(g, 0)) * (b - b1)
            / (b2 - b1) for g in set(y1) | set(y2)}


def collective_s(by_group: Dict[str, float], hosts: int,
                 nvlink: float = NVLINK_GBPS * 1e9,
                 ib: float = IB_GBPS * 1e9) -> float:
    """Seconds to receive `by_group` bytes: 'model' over NVLink, 'data'
    and 'world' (and any other) over NVLink on one host and InfiniBand
    across two."""
    model = by_group.get("model", 0.0)
    cross = sum(v for g, v in by_group.items() if g != "model")
    return model / nvlink + cross / (nvlink if hosts == 1 else ib)


def efficiencies(t1: float, floor: float, at_b: Dict[str, float],
                 at_shard: Dict[str, float], n: int, hosts: int,
                 nvlink: float = NVLINK_GBPS * 1e9,
                 ib: float = IB_GBPS * 1e9):
    """(weak, strong, t_coll, weak with cross-host bytes overlapped) for
    a step of t1 s on one rank, at `hosts` hosts: `at_b` the bytes at the
    per-rank batch, `at_shard` at the batch / n (see the module
    docstring)."""
    t_coll = collective_s(at_b, hosts, nvlink, ib)
    weak = t1 / (t1 + t_coll)
    t_strong = max(t1 / n, floor) + collective_s(at_shard, hosts, nvlink,
                                                 ib)
    strong = t1 / (n * t_strong)
    if hosts > 1:
        model = at_b.get("model", 0.0) / nvlink
        cross = collective_s(at_b, hosts, nvlink, ib) - model
        weak_ov = t1 / (t1 + model + max(0.0, cross - t1))
    else:
        weak_ov = weak
    return weak, strong, t_coll, weak_ov


def predict_step_ms(t1_ms: float, by_group: Dict[str, float],
                    hosts: int = 1, nvlink: float = NVLINK_GBPS * 1e9,
                    ib: float = IB_GBPS * 1e9) -> float:
    """The model's step: the one-rank step plus the time to receive the
    step's bytes, nothing overlapped."""
    return t1_ms + 1e3 * collective_s(by_group, hosts, nvlink, ib)


def report(names: List[str], step_ms: Optional[Dict[str, float]] = None,
           nvlink_gbps: float = NVLINK_GBPS, ib_gbps: float = IB_GBPS,
           md: bool = False, card: str = CARD,
           counted: Optional[dict] = None) -> List[str]:
    """The model's tables for the named configs, as lines: the bytes
    `counted` (else counted here, `count_configs`), the step times
    `step_ms` by config (default STEP_MS) measured on `card`."""
    step_ms = dict(STEP_MS, **(step_ms or {}))
    nvlink, ib = nvlink_gbps * 1e9, ib_gbps * 1e9
    if counted is None:
        counted = count_configs(names)
    sep = "|" if md else "  "
    lines = []
    for name in names:
        sc = CONFIGS[name]
        t1_ms = step_ms.get(sc.get("t1", name))
        floor = sc["L"] * (K2_FWD_US + K2_BWD_US) * 1e-6
        lines += ["", f"### {name}: b = {sc['B_dev']} a rank, L = "
                  f"{sc['L']}, routing {sc['routing']}; t1 = "
                  + (f"{t1_ms:.3f} ms" if t1_ms is not None
                     else "not measured")
                  + f" ({card}, chip_smoke.py phase 22 (a)); floor "
                  f"{floor * 1e3:.3f} ms (K2 {K2_FWD_US} + {K2_BWD_US} us "
                  f"a step x L, {CARD}); bytes counted at b = {COUNT_B} "
                  f"on the CPU, affine in b; NVLink {nvlink_gbps:g} GB/s, "
                  f"InfiniBand {ib_gbps:g} GB/s a GPU"]
        hdr = ["mesh d x m (routing)", "MB/rank model", "MB/rank data",
               "MB/rank world", "t_coll 1-host", "step ms 1-host",
               "weak 1-host", "weak 2-host", "strong 1-host",
               "weak 2-host merge-overlap*"]
        lines.append(sep.join(hdr))
        if md:
            lines.append("|".join(["---"] * len(hdr)))
        for entry in sc["meshes"]:
            d, m, routing, cap = mesh_entry(sc, entry)
            n = d * m
            c = counted[(name, d, m, routing, cap)]
            at_b = bytes_at(c, sc["B_dev"])
            at_shard = bytes_at(c, sc["B_dev"] / n)
            label = f"{d}x{m} {routing}" + (f" cap{cap:g}"
                                              if routing == "owner" else "")
            row = [label] + [f"{at_b.get(g, 0.0) / 1e6:.2f}"
                             for g in GROUPS]
            row.append(f"{collective_s(at_b, 1, nvlink, ib) * 1e3:.3f} ms")
            if t1_ms is None:
                row += ["not measured"] * 5
            else:
                t1 = t1_ms / 1e3
                w1, s1, _, _ = efficiencies(t1, floor, at_b, at_shard, n, 1,
                                            nvlink, ib)
                row += [f"{predict_step_ms(t1_ms, at_b, 1, nvlink, ib):.3f}",
                        f"{w1 * 100:.1f}%"]
                if d > 1:
                    w2, _, _, w2ov = efficiencies(t1, floor, at_b, at_shard,
                                                  n, 2, nvlink, ib)
                    row += [f"{w2 * 100:.1f}%", f"{s1 * 100:.1f}%",
                            f"{w2ov * 100:.1f}%"]
                else:
                    row += ["n/a (d = 1)", f"{s1 * 100:.1f}%", "n/a"]
            lines.append(sep.join(row))
        lines += ["", "(*) an upper bound: cross-host bytes hidden under up "
                  "to one step of compute; the port's graph overlaps "
                  "nothing, so it does not reach it as built.  Strong "
                  "scaling assumes t1 splits linearly over the ranks (an "
                  "upper bound)."]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="taobao,kuaishou")
    ap.add_argument("--nvlink_gbps", type=float, default=NVLINK_GBPS)
    ap.add_argument("--ib_gbps", type=float, default=IB_GBPS)
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    names = args.configs.split(",")
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configs {unknown}; known {sorted(CONFIGS)}")
    for line in report(names, nvlink_gbps=args.nvlink_gbps,
                       ib_gbps=args.ib_gbps, md=args.md):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
