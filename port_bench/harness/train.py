"""The train cells: the program's graphed resident train calls, as
`Trainer.fit` makes them, on a resident Taobao-scale set.

Set-up builds one `Trainer` (model, state, steps) from the benchmark's
weights, uploads the benchmark's rows as the program's `ResidentDataset`
and `EpochFeed`, and drives the same `ResidentMultiStep` object that the
window drives through its first three steps, one step a call on rows
that all differ: the losses, each leaf's first gradient (read from the
optimizer's state after one step) and each leaf's change after three
steps are kept for the check.  Two whole calls warm up, then the window
runs whole calls of K steps until `seconds` have passed, waiting for the
card after each, and counts every call it ran.  A traced run then
profiles four more calls (harness/trace.py).  Once the window has
closed and the program's state is freed, the plain reference follows
the first three steps from the same weights, rows and negative draws.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from harness import checks, gen
from harness import trace as tr
from harness.common import Phases, Run
from harness.weights import make_weights
from reference import train as RT

TIME_RANGE = {"s": 3600.0 * 24.0 / 1000.0, "ms": 3600.0 * 24.0 * 1000.0}
WARM_CALLS = 2
TRACED_CALLS = 4


def program_config(run: Run, **extra):
    from clsr_tpu_torch.config import load_config
    mix = run.cell.mix
    return load_config(run.cell.config_path, seed=run.seed,
                       batch_size=mix["batch_size"],
                       **dict(run.overrides, **extra))


def reference_config(run: Run) -> dict:
    return dict(run.cell.cfg, batch_size=run.cell.mix["batch_size"])


def reference_batches(data, rows: np.ndarray, B: int, L: int, device):
    """The plain reference's batches: rows of the benchmark's data, the
    mask from the lengths."""
    out = []
    col = torch.arange(L, device=device)
    for i in range(len(rows) // B):
        idx = torch.from_numpy(rows[i * B:(i + 1) * B]).to(device)
        b = {k: data[k].index_select(0, idx).to(device) for k in (
            "users", "items", "cates", "item_hist", "cate_hist",
            "time_diff", "time_from_first", "time_to_now", "lengths")}
        for k in ("users", "items", "cates", "item_hist", "cate_hist"):
            b[k] = b[k].long()
        b["mask"] = (col[None, :] < b.pop("lengths")[:, None].long()).float()
        b["valid"] = torch.ones(B, device=device)
        out.append(b)
    return out


def program_readings(model, state) -> Dict[str, float]:
    """The program's first clipped gradient of each leaf, from its
    optimizer's state after one step: Adam's first moment is (1 - b1) g,
    in a table's pmn rows [param | mu | nu] or torch Adam's exp_avg."""
    opt = state.optimizer
    out = {}
    for name, p in model.named_parameters():
        if name in opt.moments:
            mn = opt.moments[name]
            D = p.shape[1]
            mu = mn[:, D:2 * D] if mn.shape[1] == 3 * D else mn[:, :D]
        else:
            mu = opt.dense_opt.state[p]["exp_avg"]
        out[name] = float(torch.linalg.vector_norm(mu.float())
                          / (1.0 - RT.B1))
    return out


def program_change(model, w0) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(p.detach().float() - w0[n]))
            for n, p in model.named_parameters()}


def run_train(run: Run, fault: Optional[Callable] = None) -> dict:
    """Measure one train run; returns what the check reads."""
    from clsr_tpu_torch.data.resident import (EpochFeed, ResidentDataset,
                                              epoch_permutation,
                                              perm_length)
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.steps import make_resident_multi_step
    from clsr_tpu_torch.training.trainer import Trainer

    cell, dev, seed = run.cell, run.device, run.seed
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    pcfg = program_config(run)
    rcfg = reference_config(run)
    B, K, L = pcfg.batch_size, pcfg.train_steps_per_call, pcfg.max_seq_length
    tables = cell.tables
    phase = Phases(run.t0)
    phase("imports")
    data = gen.train_rows(cell.mix, tables, L, TIME_RANGE[pcfg.time_unit],
                          seed, dev)
    phase("rows")
    N = data["users"].shape[0]
    elig = np.arange(N)
    perm, n_use, _, _ = epoch_permutation(
        elig, np.random.RandomState(gen.sub_seed(seed, "epoch") % 2 ** 32),
        B, K, pcfg.drop_remainder_min)
    ref_rows = perm[:3 * B].astype(np.int64)
    ref_batches_host = [{k: v.cpu() for k, v in b.items()}
                        for b in reference_batches(data, ref_rows, B, L, dev)]
    w0 = make_weights(rcfg, tables, seed, dev)
    model = get_model_class(pcfg.model_type)(
        pcfg, tables["n_users"], tables["n_items"], tables["n_cates"],
        device=dev)
    model.load_state_dict(w0)
    phase("model")
    trainer = Trainer(model, pcfg, log=lambda *a, **k: None)
    mesh = trainer.mesh
    res = ResidentDataset(**data)
    del data
    # what Trainer._build_resident makes for one resident dataset
    feed = EpochFeed(res, perm_length(N, B, pcfg.drop_remainder_min), mesh)
    step = make_resident_multi_step(model, pcfg, K, mesh)
    feed.set_epoch(perm, n_use)
    phase("trainer")
    g = gen.generator(seed, "negatives", dev)
    if fault is not None:
        step = fault(step, model)
    state = trainer.state
    losses = []
    for i in range(3):
        state, parts = step(state, feed, i * B, g, 1)
        losses.append(float(parts.loss[0]))
        if i == 0:
            first = program_readings(model, state)
    change = program_change(model, w0)
    del w0
    phase("first steps")
    offset = 3 * B

    def call():
        nonlocal offset, state
        state, _ = step(state, feed, offset, g, K)
        offset += K * B
    for _ in range(WARM_CALLS):
        call()
    sync()
    gc.collect()    # set-up's garbage, not the window's
    phase("warm-up")
    run.setup_s = time.perf_counter() - run.t0
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if on_card else 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    calls_left = (n_use - offset) // (K * B) - TRACED_CALLS - tr.WARM_CALLS
    t0 = time.perf_counter()
    n = 0
    while True:
        call()
        sync()
        n += 1
        t = time.perf_counter()
        if t - t0 >= run.seconds or n >= calls_left:
            break
    run.window_s = t - t0
    run.calls = n
    run.work = float(n * K * B)
    run.attempted = n * K
    if on_card:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        run.memory_peak_bytes = max(run.memory_peak_bytes,
                                    run.window_peak_bytes)
    run.shapes = shapes(pcfg, res, ref_batches_host, B, K)
    if run.trace and on_card:
        run.trace_summary = dict(tr.profile_window(call, TRACED_CALLS, dev),
                                 steps=TRACED_CALLS * K)
    del trainer, model, state, step, feed, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref_in = dict(cfg=rcfg, tables=tables, seed=seed,
                  batches=ref_batches_host)
    return dict(losses=losses, first=first, change=change, ref_in=ref_in,
                **reference_readings(ref_in, dev))


def reference_readings(ref_in: dict, device, tf32: bool = False,
                       half: bool = False) -> dict:
    """The plain reference's first three steps from the run's weights,
    rows and negative draws; with `tf32` computed in TF32 (the control),
    with `half` on the first half of each batch only (a fault)."""
    with checks.plain_precision(tf32):
        w0 = make_weights(ref_in["cfg"], ref_in["tables"], ref_in["seed"],
                          device)
        batches = []
        for b in ref_in["batches"]:
            b = {k: v.to(device) for k, v in b.items()}
            if half:
                n = b["users"].shape[0] // 2
                b = {k: v[:n] for k, v in b.items()}
            batches.append(b)
        losses, first, change = RT.follow(
            w0, ref_in["cfg"], gen.sub_seed(ref_in["seed"], "negatives"),
            batches, device)
    return dict(ref_losses=losses, ref_first=first, ref_change=change)


def shapes(pcfg, res, batches, B: int, K: int) -> Dict[str, float]:
    """The sizes the rooflines and model counts read: widths, batch,
    candidates, history, the resident rows' mean real length and each
    table's unique rows a step (the mean over the checked batches)."""
    lengths = res.lengths.float()
    out = dict(B=B, K=K, G=1 + pcfg.train_num_ngs, L=pcfg.max_seq_length,
               mean_len=float(lengths.clamp_max(pcfg.max_seq_length)
                              .mean()),
               I=pcfg.item_embedding_dim, C=pcfg.cate_embedding_dim,
               U=pcfg.user_embedding_dim, H=pcfg.hidden_size,
               A0=pcfg.att_fcn_layer_sizes[0],
               A1=pcfg.att_fcn_layer_sizes[1],
               F0=pcfg.layer_sizes[0], F1=pcfg.layer_sizes[1])
    if batches:
        items = [torch.unique(torch.cat([b["item_hist"].reshape(-1),
                                         b["items"]])).numel()
                 for b in batches]
        cates = [torch.unique(torch.cat([b["cate_hist"].reshape(-1),
                                         b["cates"]])).numel()
                 for b in batches]
        users = [torch.unique(b["users"]).numel() for b in batches]
        out.update(unique_items=float(np.mean(items)),
                   unique_cates=float(np.mean(cates)),
                   unique_users=float(np.mean(users)))
    return out
