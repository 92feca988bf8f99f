"""Training driver: epoch loop, early stopping, checkpointing.

Counterpart of clsr_tpu/training/trainer.py (`__init__`, `fit`, `save`,
`load`, `load_latest`, `_use_resident`, `_resident_epoch`,
`_bucketed_epoch`, `_maybe_histograms`, `_autosave_stream`, `_autosave`;
:33-447, 449-676, 683-732) on one device; it mirrors
the reference's SequentialBaseModel.fit
(sequential_base_model.py:111-202): a reshuffled train pass each epoch
(`np.random.RandomState(cfg.seed)`), weighted eval on the valid file,
early stop once `epoch - best_epoch >= cfg.early_stop` on
cfg.eval_metric (wauc on the CLSR path), a checkpoint `epoch_<n>` on
improvement (training/checkpoint.py).

How the port runs what the JAX package runs:
  * Batches stream from the host loader through `data.prefetch`
    (cfg.prefetch_batches in flight).  The in-batch negatives and the
    dropout masks come from one `torch.Generator` on the model's device,
    seeded from cfg.seed (the numbers differ from JAX's PRNG by design).
  * Resident data (`_use_resident`, :139-155: `on`, or `auto` when the
    upload's estimate fits cfg.resident_max_bytes): the padded train set
    is uploaded once (data/resident.py) and each step gathers its batch
    on the device from the epoch permutation, with no prefetch thread.
    The permutation is `np_rng.permutation(eligible)`, which consumes the
    RandomState as the streamed path's `rng.shuffle` of the same ids
    does, and the gathered batch equals the loader's bit for bit, so a
    resident fit and a streamed fit from one seed run the same steps.
    With K > 1 a call is K replays of a captured step that gathers its
    own batch (training/steps.py `ResidentMultiStep`): the host sends an
    offset, not a batch.
  * Length buckets (cfg.length_buckets, resident only; `_bucketed_epoch`,
    :306-404): one resident dataset and one captured step a bucket, each
    bucket its own epoch permutation, the (bucket, call) slots in an
    order drawn from np_rng, then cfg.bn_refresh_batches forward-only
    batches round-robin over the buckets re-estimate the BN running
    statistics.  np_rng draws in JAX's order (each bucket's permutation,
    the slot order, each refresh batch's rows), so the batches are JAX's.
  * Streamed with `train_steps_per_call` K > 1, the fit takes JAX's
    stacked path (:112-115, :567-594): the loader gathers the epoch once
    and yields [K, B, ...] stacks of whole batches, then the [B] tail
    batches (`train_batches_stacked`); each stack is one host-to-device
    copy and one call of `make_multi_train_step`, which on the card
    replays a CUDA graph of the train step K times (training/steps.py
    `MultiTrainStep`), and each tail batch one replay.  The first step
    of a fit is the graph's warm-up and runs eagerly.  The same steps
    run as with K = 1, which keeps the eager single steps, and the log
    groups them as JAX does (each call's K steps, then single steps).
  * The loss sums stay on the device; the host reads them at show_step
    boundaries and once at the end of an epoch.  The JAX streaming path
    reads `float(parts.loss)` every step, which here would make the host
    wait for the device every step; the logged numbers are the same.
  * Kill and resume (cfg.autosave_every_calls, `fit(resume=True)`,
    JAX :281-302, :415-447, :491-521): every N calls, and at each epoch
    boundary, the state goes to `<model_dir>/autosave/state` and the run
    state beside it (training/checkpoint.py `save_run_state`): the
    fit's generator state where JAX keeps its key, the RandomState, and
    on the resident path the epoch's permutation and layout.  A resumed
    fit loads both and runs the remaining calls: the resident path from
    the saved permutation, the streamed path by rebuilding the epoch's
    iterator from the epoch-start RandomState and skipping the calls
    done on the host.  The calls after it draw from the restored
    generator, so the fit ends with the uninterrupted fit's bits (the
    first step after the load is a graph's eager warm-up, which equals
    a replay bit for bit).  The resumed epoch's steps, examples and mean
    loss count the calls run after the resume.  A finished fit removes
    the autosave.
    Refused as in JAX: a resume whose mode (resident or streamed) is
    not the autosave's, and under length_buckets.
  * Histograms (cfg.write_histograms with summaries_dir, JAX :405-413):
    at each show_step boundary the histogram step (training/steps.py
    `make_histogram_step`) runs on a fixed probe batch, the first train
    batch of RandomState(0), and the counts go to the summary writer.
  * The torch generator is drawn by the steps (and the bucketed
    refresh) alone, so the resident and the streamed path draw the same
    numbers.
  * A (data, model) mesh (cfg.data_parallel * cfg.model_parallel > 1,
    JAX :46-110; parallel/mesh.py): every rank of the process group
    builds the same Trainer.  The model's tables are row-sharded before
    the state is made (`place_model`); streamed, every rank reads the
    same global batches from its loader and keeps its own rows (axis 1
    of a stacked [K, B, ...] item); resident (`_use_resident` as JAX's:
    the batch must divide into the batch shards), every rank uploads its
    block of the rows (data/resident.py `build_resident_mesh`, each
    length bucket's too), draws the same epoch permutation and gathers
    its share of each batch on its device.  The steps are the mesh's
    (training/steps.py): with K > 1 over nccl a call replays CUDA graphs
    of the step on every rank, as on one device; over gloo, or on the
    CPU, its steps run eagerly, which the Trainer logs once, naming the
    reason (`steps.graph_refusal`).  The eval step
    pads each global batch to a multiple of the batch shards, scores the
    rank's rows and gathers the predictions, so every rank computes the
    same metrics.  Rank 0 alone logs and writes summaries; checkpoints
    hold the logical layout (training/checkpoint.py), written by rank 0
    and loaded by every rank.  Without cfg.seed the ranks take rank 0's
    clock seed, so they draw one permutation and one set of negatives
    and masks.  Under the owner-routed merge the epoch's
    end reads the overflow counter and logs JAX's NOTE (fallback) or
    WARNING (drop) when it is nonzero (JAX :619-640).  A mesh autosave
    holds the logical state (as the checkpoints) and one run state,
    written by rank 0 after every rank has checked that its run state
    is rank 0's (`_check_lockstep`: the generator, the RandomState, the
    permutation, the global loss sums); a resume loads both on every
    rank, and the autosave loads on one device too.  A mesh histogram
    step scores the rank's rows of the probe batch and gathers them
    (training/steps.py), so every rank holds the global histograms and
    rank 0 writes them.  LGN gathers its tables (models/lgn.py).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.prefetch import device_batches, to_device
from clsr_tpu_torch.data.resident import (EpochFeed, build_resident,
                                          build_resident_buckets,
                                          build_resident_mesh,
                                          epoch_permutation, pad_view_rows,
                                          perm_length,
                                          resident_nbytes_estimate,
                                          resolve_bucket_paddings)
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.mesh import (barrier, make_mesh,
                                          make_sharded_eval_step,
                                          mesh_size, place_model,
                                          shard_batch)
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.lazy_adam import LazyAdamState
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (graph_refusal,
                                           make_eval_step_fn,
                                           make_histogram_step,
                                           make_multi_train_step,
                                           make_resident_bn_refresh,
                                           make_resident_multi_step,
                                           make_resident_step,
                                           make_train_step)
from clsr_tpu_torch.utils.summaries import SummaryWriter


def _field_bytes(v) -> bytes:
    """A run-state field's bytes, for the lockstep digest."""
    if isinstance(v, torch.Generator):
        return v.get_state().numpy().tobytes()
    if isinstance(v, np.random.RandomState):
        mt = v.get_state()
        return mt[1].tobytes() + repr(mt[2:]).encode()
    return np.asarray(v).tobytes()


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: Config, log=print):
        self.model = model
        self.cfg = cfg
        self.mesh = make_mesh(cfg) if mesh_size(cfg) > 1 else None
        # on a mesh rank 0 alone logs and writes summaries
        self._writer = self.mesh is None or self.mesh.rank == 0
        self.log = log if self._writer else (lambda *a, **k: None)
        self.device = next(model.parameters()).device
        if self.mesh is not None:
            place_model(model, self.mesh)
        if cfg.use_pallas_scan and cfg.compute_dtype == "bfloat16":
            log("compute_dtype bfloat16: the recurrence runs its plain bf16 "
                "path, not K2 (the JAX package runs K2 under f32 compute "
                "only, ops/fused_clsr.py:291)")
        self.state = create_train_state(model, cfg)
        self.train_step = make_train_step(model, cfg, self.mesh)
        self.eval_step = (make_eval_step_fn(cfg) if self.mesh is None
                          else make_sharded_eval_step(cfg, self.mesh))
        self.multi_step = (make_multi_train_step(
            model, cfg, cfg.train_steps_per_call, self.mesh)
            if cfg.train_steps_per_call > 1 else None)
        if self.mesh is not None and cfg.train_steps_per_call > 1:
            why = graph_refusal(self.mesh, self.device)
            if why:
                self.log(f"train_steps_per_call {cfg.train_steps_per_call}"
                         f" on the mesh: each call's steps run eagerly, not"
                         f" as CUDA graph replays ({why})")
        self.best_epoch = 0
        self.eval_history: List[Tuple[int, Dict[str, float]]] = []
        # per epoch: steps, examples, train and eval seconds, mean loss
        # (and on the bucketed path the BN refresh's seconds)
        self.epoch_stats: List[Dict[str, float]] = []
        self.summary = SummaryWriter(
            cfg.summaries_dir if self._writer else None, cfg.write_tfevents)
        # the resident path's state, built at its first epoch: one feed
        # (EpochFeed) a dataset or bucket, each with its eligible local
        # rows, the upload's bytes and seconds, the steps, the refresh
        self.feeds: Optional[List[Tuple[EpochFeed, np.ndarray]]] = None
        self.bucketed = False
        self.upload: Optional[Dict[str, float]] = None
        self.resident_step = None
        self._bn_refresh = None
        self._resident_src = None       # the loader the feeds hold
        self._hist_step = None          # the histogram step, its probe
        self._hist_probe = None
        self._best_metric = 0.0

    def _use_resident(self, train_loader: SequenceLoader) -> bool:
        """resident_data: 'on', or 'auto' when the upload fits
        cfg.resident_max_bytes (JAX :139-155); on a mesh only when the
        batch divides into the batch shards."""
        cfg = self.cfg
        if cfg.resident_data == "off":
            return False
        if self.mesh is not None and cfg.batch_size % self.mesh.n_batch:
            return False
        if cfg.resident_data == "on":
            return True
        return (resident_nbytes_estimate(len(train_loader.ds),
                                         cfg.max_seq_length)
                <= cfg.resident_max_bytes)

    def _build_resident(self, train_loader: SequenceLoader) -> None:
        """Upload the train set (or its length buckets; on a mesh this
        rank's block of each) and make the steps (JAX :174-225)."""
        cfg, mesh = self.cfg, self.mesh
        view = train_loader.view
        B, K = cfg.batch_size, cfg.train_steps_per_call
        t0 = time.perf_counter()
        pads = resolve_bucket_paddings(cfg, view.lengths)
        if pads:
            parts = build_resident_buckets(view, pads, self.device,
                                           cfg.resident_round_rows, mesh)
            elig = [np.flatnonzero(view.lengths[rows] >= cfg.min_seq_length)
                    for _, rows in parts]
            n = mesh.n_batch if mesh is not None else 1   # a block a rank
            self.log("length buckets (Lb x rows): " + ", ".join(
                f"{res.seq_len}x{res.n_rows * n}" for res, _ in parts))
            datasets = [res for res, _ in parts]
        else:
            padded = pad_view_rows(view, cfg.resident_round_rows)
            datasets = [build_resident(padded, self.device) if mesh is None
                        else build_resident_mesh(padded, mesh, self.device)]
            elig = [np.flatnonzero(view.lengths >= cfg.min_seq_length)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload = dict(
            bytes=sum(res.nbytes() for res in datasets),
            s=time.perf_counter() - t0)
        self.feeds = [
            (EpochFeed(res, perm_length(len(e), B, cfg.drop_remainder_min),
                       mesh), e) for res, e in zip(datasets, elig)]
        self.bucketed = bool(pads)
        self.resident_step = (
            make_resident_multi_step(self.model, cfg, K, mesh) if K > 1
            else make_resident_step(self.model, cfg, mesh))

    def _resident_calls(self, np_rng: np.random.RandomState,
                        saved: Optional[dict] = None):
        """The epoch's resident calls in order, as (feed, row offset,
        steps, rows), and the layout an autosave keeps (perm, n_use,
        n_calls, n_tail) of the one unbucketed feed: each feed's
        permutation drawn from np_rng in feed order, then (buckets) the
        slots' order (JAX :245-250, :321-340); or a resumed epoch's
        saved layout, drawing nothing."""
        cfg = self.cfg
        B, K = cfg.batch_size, cfg.train_steps_per_call
        slots, layout = [], None
        for feed, elig in self.feeds:
            if saved is not None:
                layout = (saved["perm"], saved["n_use"], saved["n_calls"],
                          saved["n_tail"])
            else:
                layout = epoch_permutation(elig, np_rng, B, K,
                                           cfg.drop_remainder_min)
            perm, n_use, n_calls, n_tail = layout
            if n_use:       # a drop can leave a bucket without batches
                feed.set_epoch(perm, n_use)
            offsets = ([(c * K * B, K) for c in range(n_calls)]
                       + [((n_calls * K + t) * B, 1) for t in range(n_tail)])
            slots += [(feed, off, k, max(0, min(k * B, n_use - off)))
                      for off, k in offsets]
        if self.bucketed:
            order = np_rng.permutation(len(slots)) if slots else []
            slots = [slots[i] for i in order]
        return slots, layout

    def _refresh_bn(self, np_rng: np.random.RandomState,
                    generator: torch.Generator) -> float:
        """The bucketed epoch's end (JAX :368-400): bn_refresh_batches
        forward-only batches, bucket r % n_buckets for batch r, of B
        eligible rows drawn with replacement; its seconds."""
        cfg = self.cfg
        if not (len(self.feeds) > 1 and cfg.bn_refresh_batches > 0
                and next(self.model.buffers(), None) is not None):
            return 0.0
        if self._bn_refresh is None:
            self._bn_refresh = make_resident_bn_refresh(self.model, cfg,
                                                        self.mesh)
        t0 = time.perf_counter()
        for r in range(cfg.bn_refresh_batches):
            feed, elig = self.feeds[r % len(self.feeds)]
            idx = np_rng.choice(elig, size=cfg.batch_size).astype(np.int64)
            self.state = self._bn_refresh(
                self.state, feed.res,
                torch.from_numpy(idx).to(self.device), generator)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def fit(self, train_loader: SequenceLoader,
            valid_loader: SequenceLoader,
            valid_num_ngs: Optional[int] = None,
            np_rng: Optional[np.random.RandomState] = None,
            resume: bool = False) -> "Trainer":
        cfg = self.cfg
        if valid_num_ngs is None:
            valid_num_ngs = cfg.valid_num_ngs
        if cfg.need_sample and cfg.train_num_ngs < 1:
            raise ValueError(
                "Please specify a positive integer of negative numbers for "
                "training without sampling needed.")
        if valid_num_ngs < 1:
            raise ValueError(
                "Please specify a positive integer of negative numbers for "
                "validation.")
        seed = cfg.seed
        if seed is None and self.mesh is not None:
            seed = self._shared_seed()
        np_rng = np_rng or np.random.RandomState(seed)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed if seed is not None else int(time.time()))

        if cfg.write_histograms and not cfg.summaries_dir:
            self.log("WARNING: write_histograms is set but summaries_dir "
                     "is empty — no histograms will be written")
        if (cfg.write_histograms and cfg.summaries_dir
                and self._hist_step is None):
            self._hist_step = make_histogram_step(mesh=self.mesh)
            # a fixed probe batch keeps the distributions comparable
            # across steps (JAX :476-484)
            self._hist_probe = to_device(next(train_loader.train_batches(
                cfg.batch_size, np.random.RandomState(0))), self.device)

        B, K = cfg.batch_size, cfg.train_steps_per_call
        multi = self.multi_step
        single = self.train_step if multi is None else multi.step
        resident = self._use_resident(train_loader)
        if resident and self._resident_src is not train_loader:
            self._build_resident(train_loader)
            self._resident_src = train_loader
        best_metric = 0.0
        self.best_epoch = 0
        step = 0
        start_epoch = 1
        saved = self._resume_info(resident) if resume else None
        if saved is not None:
            np_rng = saved["np_rng"]
            generator.set_state(saved["rng"])
            best_metric = saved["best_metric"]
            self.best_epoch = saved["best_epoch"]
            step = saved["step"]
            start_epoch = saved["epoch"]
        self._best_metric = best_metric
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.time()
            n_steps, n_examples = 0, 0
            epoch_loss = None
            refresh_s = None
            first = saved if epoch == start_epoch else None

            def counted(batches):
                nonlocal n_examples
                for b in batches:       # host batches, in the producer
                    n_examples += int(b.valid.sum())
                    yield b

            def emit(n_new, loss, data_loss):
                nonlocal step, n_steps, epoch_loss
                prev = step
                step += n_new
                n_steps += n_new
                epoch_loss = loss if epoch_loss is None else epoch_loss + loss
                if cfg.show_step and step // cfg.show_step > prev // cfg.show_step:
                    loss_avg = loss.item() / n_new
                    data_avg = data_loss.item() / n_new
                    self.log(f"step {step}, total_loss: {loss_avg:.4f}, "
                             f"data_loss: {data_avg:.4f}")
                    self.summary.scalars(step, {"loss": loss_avg,
                                                "data_loss": data_avg})
                    self._maybe_histograms(step)

            autosave_every = cfg.autosave_every_calls
            if resident:
                layout_saved = (first if first is not None
                                and first["n_calls"] >= 0 else None)
                calls, layout = self._resident_calls(np_rng, layout_saved)
                calls_done = (layout_saved["calls_done"]
                              if layout_saved is not None else 0)
                for i in range(calls_done, len(calls)):
                    feed, offset, k, rows = calls[i]
                    n_examples += rows
                    if K > 1:
                        self.state, parts = self.resident_step(
                            self.state, feed, offset, generator, k)
                        emit(k, parts.loss.sum(), parts.data_loss.sum())
                    else:
                        self.state, parts = self.resident_step(
                            self.state, feed, offset, generator)
                        emit(1, parts.loss, parts.data_loss)
                    if autosave_every and (i + 1) % autosave_every == 0:
                        self._autosave(epoch, i + 1, step, generator,
                                       np_rng, layout, epoch_loss)
                if self.bucketed:
                    refresh_s = self._refresh_bn(np_rng, generator)
            else:
                # the loaders draw the permutation inside the iterator,
                # so an autosave keeps the epoch-start RandomState and a
                # resume skips the calls done on the host (JAX :556-578)
                np_mt0 = np_rng.get_state()
                calls_done = (first["calls_done"] if first is not None
                              and first["mode"] == "stream" else 0)
                if multi is not None:
                    items = train_loader.train_batches_stacked(
                        B, K, np_rng, min_seq_length=cfg.min_seq_length)
                else:
                    items = train_loader.train_batches(
                        B, np_rng, min_seq_length=cfg.min_seq_length)
                for _ in range(calls_done):     # no device work
                    next(items, None)
                items = counted(items)
                if self.mesh is not None:       # this rank's rows
                    items = (shard_batch(b, self.mesh, b.users.ndim - 1)
                             for b in items)
                for item in device_batches(items, self.device,
                                           cfg.prefetch_batches):
                    if item.users.ndim == 2:    # [K, B, ...] stacked
                        self.state, parts = multi(self.state, item,
                                                  generator)
                        emit(K, parts.loss.sum(), parts.data_loss.sum())
                    else:                       # tail / single steps
                        self.state, parts = single(self.state, item,
                                                   generator)
                        emit(1, parts.loss, parts.data_loss)
                    calls_done += 1
                    if autosave_every and calls_done % autosave_every == 0:
                        self._autosave_stream(epoch, calls_done, step,
                                              generator, np_mt0, epoch_loss)
            mean_loss = (epoch_loss.item() / n_steps if n_steps
                         else float("nan"))
            train_time = time.time() - t0

            t0 = time.time()
            valid_res = run_weighted_eval(self.eval_step, self.state.model,
                                          valid_loader, cfg, valid_num_ngs)
            eval_time = time.time() - t0
            self.log(
                "eval valid at epoch {0}: {1}".format(
                    epoch, ",".join(f"{k}:{v}" for k, v in valid_res.items())))
            self.log(f"epoch {epoch} train time {train_time:.3f}s "
                     f"({n_steps} steps, {n_examples} examples, "
                     f"{n_examples / max(train_time, 1e-9):.1f} examples/s), "
                     f"eval time {eval_time:.3f}s")
            self.epoch_stats.append(dict(
                epoch=epoch, steps=n_steps, examples=n_examples,
                train_s=train_time, eval_s=eval_time, mean_loss=mean_loss,
                **({} if refresh_s is None else dict(refresh_s=refresh_s))))
            self.eval_history.append((epoch, valid_res))
            self.summary.scalars(step, {f"valid/{k}": v
                                        for k, v in valid_res.items()})
            self._log_overflow()

            progress = False
            if valid_res[cfg.eval_metric] > best_metric:
                best_metric = valid_res[cfg.eval_metric]
                self._best_metric = best_metric
                self.best_epoch = epoch
                progress = True
            elif (cfg.early_stop > 0
                  and epoch - self.best_epoch >= cfg.early_stop):
                self.log(f"early stop at epoch {epoch}!")
                break

            if cfg.save_model and cfg.model_dir and progress:
                self.save(os.path.join(cfg.model_dir, f"epoch_{epoch}"))

            if autosave_every and epoch < cfg.epochs:
                # the epoch boundary: the next epoch starts from the
                # restored RandomState (a kill in the eval or early in
                # the next epoch resumes here; n_calls = -1)
                if resident:
                    self._autosave(epoch + 1, 0, step, generator, np_rng,
                                   (np.zeros(0, np.int32), 0, -1, -1), None)
                else:
                    self._autosave_stream(epoch + 1, 0, step, generator,
                                          np_rng.get_state(), None)

        if cfg.autosave_every_calls and cfg.model_dir:
            # a finished fit is not resumed into
            if self._writer:
                shutil.rmtree(self._autosave_dir(), ignore_errors=True)
            barrier(self.mesh)
        self.log(f"best epoch: {self.best_epoch}")
        return self

    def _shared_seed(self) -> int:
        """A seed from rank 0's clock, the same on every rank: without
        cfg.seed the ranks would draw different epoch permutations,
        negatives and dropout masks, and the global batch would not be
        one batch (resident, the ranks' gathers would not assemble)."""
        mine = int(time.time()) if self.mesh.rank == 0 else 0
        return int(col.all_reduce(torch.tensor(
            [mine], dtype=torch.int64, device=self.device),
            self.mesh.world)[0])

    def _log_overflow(self) -> None:
        """The owner-routed merge's overflow so far, read once an epoch
        at the eval's sync (JAX :619-640)."""
        cfg = self.cfg
        opt = self.state.optimizer
        if (self.mesh is None or cfg.mesh_update_routing != "owner"
                or not isinstance(opt, LazyAdamState)):
            return
        ovf = int(opt.route_overflow)
        if ovf and cfg.mesh_owner_overflow == "drop":
            self.log(f"WARNING: owner-routed update merge dropped {ovf} "
                     f"gradient bucket entries so far (mesh_owner_capacity "
                     f"too small for this id distribution — raise it, or "
                     f"use mesh_owner_overflow='fallback')")
        elif ovf:
            self.log(f"NOTE: owner-routed update merge fell back to the "
                     f"broadcast merge for {ovf} bucket entries so far "
                     f"(lossless; raise mesh_owner_capacity to keep the "
                     f"O(M/m) wire bytes on those steps)")

    def _resume_info(self, resident: bool) -> Optional[dict]:
        """Load `<model_dir>/autosave` for fit(resume=True): the run
        state, with the state restored from it, or None (a fresh start)
        when there is none; the refusals are JAX's (:491-521)."""
        cfg = self.cfg
        if not cfg.model_dir:
            raise ValueError("resume requires model_dir")
        info = checkpoint.load_run_state(self._autosave_dir())
        if info is None:
            self.log("resume requested but no autosave found — "
                     "starting fresh")
            return None
        stream_saved = info["mode"] == "stream"
        if stream_saved and resident:
            raise ValueError(
                "the autosave was written by the STREAMING path "
                "but this run resolves to resident data — pass "
                "resident_data=off to resume it")
        if not stream_saved and not resident:
            raise ValueError(
                "the autosave was written by the RESIDENT path "
                "but this run streams — pass resident_data="
                "auto/on to resume it")
        if cfg.length_buckets != "off":
            raise ValueError(
                "mid-epoch resume is not supported with "
                "length_buckets (the autosaved run state stores "
                "a single epoch permutation)")
        self.load(os.path.join(self._autosave_dir(), "state"))
        self.log(f"resuming at epoch {info['epoch']}, call "
                 f"{info['calls_done']} (step {info['step']})")
        return info

    def _autosave_dir(self) -> str:
        return os.path.join(self.cfg.model_dir, "autosave")

    def _autosave(self, epoch, calls_done, step, generator, np_rng, layout,
                  total) -> None:
        """The resident path's autosave (JAX :431-447): the state, the
        RandomState after this epoch's draws, and the epoch's layout."""
        perm, n_use, n_calls, n_tail = layout
        self.save(os.path.join(self._autosave_dir(), "state"))
        self._save_run_state(
            epoch=epoch, calls_done=calls_done,
            step=step, generator=generator, np_rng=np_rng,
            perm=np.asarray(perm), n_use=n_use, n_calls=n_calls,
            n_tail=n_tail, total=0.0 if total is None else total.item(),
            data_total=0.0, best_metric=self._best_metric,
            best_epoch=self.best_epoch)

    def _autosave_stream(self, epoch, calls_done, step, generator, np_mt0,
                         total) -> None:
        """The streamed path's autosave (JAX :415-429): the state and the
        epoch-start RandomState `np_mt0`."""
        self.save(os.path.join(self._autosave_dir(), "state"))
        start = np.random.RandomState(0)
        start.set_state(np_mt0)
        self._save_run_state(
            epoch=epoch, calls_done=calls_done,
            step=step, generator=generator, np_rng=start,
            perm=np.zeros(0, np.int32), n_use=0, n_calls=-1, n_tail=0,
            total=0.0 if total is None else total.item(), data_total=0.0,
            best_metric=self._best_metric, best_epoch=self.best_epoch,
            mode="stream")

    def _save_run_state(self, **fields) -> None:
        """checkpoint.save_run_state into the autosave, by rank 0 on a
        mesh once every rank's fields are checked to be rank 0's; every
        rank waits for the write."""
        if self.mesh is not None:
            self._check_lockstep(fields)
        if self._writer:
            checkpoint.save_run_state(self._autosave_dir(), **fields)
        barrier(self.mesh)

    def _check_lockstep(self, fields) -> None:
        """Raise unless every rank's run state is rank 0's, field by field
        (a digest of each, all_gathered): rank 0 alone writes it, so a
        field that differed by rank (a generator that drew apart, a
        rank's own loss sum) would resume the other ranks wrongly."""
        names = sorted(fields)
        digests = np.stack([np.frombuffer(hashlib.sha256(_field_bytes(
            fields[k])).digest(), np.uint8) for k in names])
        every = col.all_gather(torch.from_numpy(digests.copy()).to(
            self.device), self.mesh.world).cpu().numpy()
        differ = sorted({names[i] for r in range(1, every.shape[0])
                         for i in np.flatnonzero(
                             (every[r] != every[0]).any(1))})
        if differ:
            raise RuntimeError(f"the ranks' run states differ in {differ}: "
                               f"rank 0 alone writes the autosave")

    def _maybe_histograms(self, step: int) -> None:
        """The activation histograms on the probe batch (JAX :405-413):
        the counts come off the device, the buckets' edges from lo, hi;
        on a mesh every rank runs the step and rank 0 writes."""
        if self._hist_step is None:
            return
        hists = self._hist_step(self.state.model, self._hist_probe)
        self.summary.histograms(step, {
            tag: tuple(t.cpu().numpy() for t in parts)
            for tag, parts in hists.items()})

    def save(self, path: str) -> None:
        """Write a checkpoint (on a mesh: every rank calls, rank 0 writes
        the logical layout)."""
        checkpoint.save_state(os.path.abspath(path), self.state, self.mesh)

    def load(self, path: str) -> None:
        """Restore a checkpoint into the state.  Loading replaces the
        optimizers' tensors, which a captured train step still writes, so
        the graphs are dropped and the next steps capture again."""
        checkpoint.load_state(os.path.abspath(path), self.state, self.mesh)
        for steps in (self.multi_step, self.resident_step):
            if hasattr(steps, "reset"):
                steps.reset()

    def load_latest(self, model_dir: str) -> None:
        """tf.train.latest_checkpoint equivalent (sequential.py:352-353)."""
        self.load(checkpoint.latest_epoch_dir(model_dir))
