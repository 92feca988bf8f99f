"""Training driver: epoch loop, early stopping, checkpointing.

Counterpart of clsr_tpu/training/trainer.py (`__init__`, `fit`, `save`,
`load`, `load_latest`, `_use_resident`, `_resident_epoch`,
`_bucketed_epoch`; :33-404, 449-676, 683-732) on one device; it mirrors
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
  * A mesh (item 10), mid-epoch autosave and resume, histograms and
    TensorBoard files (item 11) raise.  The torch generator is drawn by
    the steps (and the bucketed refresh) alone, so the resident and the
    streamed path draw the same numbers.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.prefetch import device_batches
from clsr_tpu_torch.data.resident import (EpochFeed, build_resident,
                                          build_resident_buckets,
                                          epoch_permutation, pad_view_rows,
                                          perm_length,
                                          resident_nbytes_estimate,
                                          resolve_bucket_paddings)
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_eval_step_fn,
                                           make_multi_train_step,
                                           make_resident_bn_refresh,
                                           make_resident_multi_step,
                                           make_resident_step,
                                           make_train_step)
from clsr_tpu_torch.utils.summaries import SummaryWriter


def check_trainable(cfg: Config) -> None:
    """Raise on settings whose fit path is not ported, naming the ROADMAP
    item that brings it."""
    if cfg.data_parallel * cfg.model_parallel > 1:
        raise NotImplementedError(
            "a device mesh (data_parallel * model_parallel > 1) waits for "
            "ROADMAP queue 1 item 10 (parallel)")
    if cfg.autosave_every_calls > 0:
        raise NotImplementedError(
            "autosave_every_calls (mid-epoch run state) waits for ROADMAP "
            "queue 1 item 11 (host remainder)")
    if cfg.write_histograms:
        raise NotImplementedError(
            "write_histograms waits for ROADMAP queue 1 item 11 (host "
            "remainder)")


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: Config, log=print):
        check_trainable(cfg)
        self.model = model
        self.cfg = cfg
        self.log = log
        self.device = next(model.parameters()).device
        if cfg.use_pallas_scan and cfg.compute_dtype == "bfloat16":
            log("compute_dtype bfloat16: the recurrence runs its plain bf16 "
                "path, not K2 (the JAX package runs K2 under f32 compute "
                "only, ops/fused_clsr.py:291)")
        self.state = create_train_state(model, cfg)
        self.train_step = make_train_step(model, cfg)
        self.eval_step = make_eval_step_fn(cfg)
        self.multi_step = (make_multi_train_step(
            model, cfg, cfg.train_steps_per_call)
            if cfg.train_steps_per_call > 1 else None)
        self.best_epoch = 0
        self.eval_history: List[Tuple[int, Dict[str, float]]] = []
        # per epoch: steps, examples, train and eval seconds, mean loss
        # (and on the bucketed path the BN refresh's seconds)
        self.epoch_stats: List[Dict[str, float]] = []
        self.summary = SummaryWriter(cfg.summaries_dir, cfg.write_tfevents)
        # the resident path's state, built at its first epoch: one feed
        # (EpochFeed) a dataset or bucket, each with its eligible local
        # rows, the upload's bytes and seconds, the steps, the refresh
        self.feeds: Optional[List[Tuple[EpochFeed, np.ndarray]]] = None
        self.bucketed = False
        self.upload: Optional[Dict[str, float]] = None
        self.resident_step = None
        self._bn_refresh = None
        self._resident_src = None       # the loader the feeds hold

    def _use_resident(self, train_loader: SequenceLoader) -> bool:
        """resident_data: 'on', or 'auto' when the upload fits
        cfg.resident_max_bytes (JAX :139-155, one device)."""
        cfg = self.cfg
        if cfg.resident_data == "off":
            return False
        if cfg.resident_data == "on":
            return True
        return (resident_nbytes_estimate(len(train_loader.ds),
                                         cfg.max_seq_length)
                <= cfg.resident_max_bytes)

    def _build_resident(self, train_loader: SequenceLoader) -> None:
        """Upload the train set (or its length buckets) and make the
        steps (JAX :174-225)."""
        cfg = self.cfg
        view = train_loader.view
        B, K = cfg.batch_size, cfg.train_steps_per_call
        t0 = time.perf_counter()
        pads = resolve_bucket_paddings(cfg, view.lengths)
        if pads:
            parts = build_resident_buckets(view, pads, self.device,
                                           cfg.resident_round_rows)
            elig = [np.flatnonzero(view.lengths[rows] >= cfg.min_seq_length)
                    for _, rows in parts]
            self.log("length buckets (Lb x rows): " + ", ".join(
                f"{res.seq_len}x{res.n_rows}" for res, _ in parts))
            datasets = [res for res, _ in parts]
        else:
            datasets = [build_resident(
                pad_view_rows(view, cfg.resident_round_rows), self.device)]
            elig = [np.flatnonzero(view.lengths >= cfg.min_seq_length)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload = dict(
            bytes=sum(res.nbytes() for res in datasets),
            s=time.perf_counter() - t0)
        self.feeds = [
            (EpochFeed(res, perm_length(len(e), B, cfg.drop_remainder_min)),
             e) for res, e in zip(datasets, elig)]
        self.bucketed = bool(pads)
        self.resident_step = (make_resident_multi_step(self.model, cfg, K)
                              if K > 1 else
                              make_resident_step(self.model, cfg))

    def _resident_calls(self, np_rng: np.random.RandomState):
        """The epoch's resident calls in order, as (feed, row offset,
        steps), and its examples: each feed's permutation drawn from
        np_rng in feed order, then (buckets) the slots' order (JAX
        :245-250, :321-340)."""
        cfg = self.cfg
        B, K = cfg.batch_size, cfg.train_steps_per_call
        slots, n_examples = [], 0
        for feed, elig in self.feeds:
            perm, n_use, n_calls, n_tail = epoch_permutation(
                elig, np_rng, B, K, cfg.drop_remainder_min)
            if n_use:       # a drop can leave a bucket without batches
                feed.set_epoch(perm, n_use)
            n_examples += n_use
            slots += [(feed, c * K * B, K) for c in range(n_calls)]
            slots += [(feed, (n_calls * K + t) * B, 1)
                      for t in range(n_tail)]
        if self.bucketed:
            order = np_rng.permutation(len(slots)) if slots else []
            slots = [slots[i] for i in order]
        return slots, n_examples

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
            self._bn_refresh = make_resident_bn_refresh(self.model, cfg)
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
        if resume:
            raise NotImplementedError(
                "resume waits for ROADMAP queue 1 item 11 (host remainder)")
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
        np_rng = np_rng or np.random.RandomState(cfg.seed)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed if cfg.seed is not None
                              else int(time.time()))

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
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.time()
            n_steps, n_examples = 0, 0
            epoch_loss = None
            refresh_s = None

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

            if resident:
                calls, n_examples = self._resident_calls(np_rng)
                for feed, offset, k in calls:
                    if K > 1:
                        self.state, parts = self.resident_step(
                            self.state, feed, offset, generator, k)
                        emit(k, parts.loss.sum(), parts.data_loss.sum())
                    else:
                        self.state, parts = self.resident_step(
                            self.state, feed, offset, generator)
                        emit(1, parts.loss, parts.data_loss)
                if self.bucketed:
                    refresh_s = self._refresh_bn(np_rng, generator)
            else:
                if multi is not None:
                    items = train_loader.train_batches_stacked(
                        B, K, np_rng, min_seq_length=cfg.min_seq_length)
                else:
                    items = train_loader.train_batches(
                        B, np_rng, min_seq_length=cfg.min_seq_length)
                for item in device_batches(counted(items), self.device,
                                           cfg.prefetch_batches):
                    if item.users.ndim == 2:    # [K, B, ...] stacked
                        self.state, parts = multi(self.state, item,
                                                  generator)
                        emit(K, parts.loss.sum(), parts.data_loss.sum())
                    else:                       # tail / single steps
                        self.state, parts = single(self.state, item,
                                                   generator)
                        emit(1, parts.loss, parts.data_loss)
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

            progress = False
            if valid_res[cfg.eval_metric] > best_metric:
                best_metric = valid_res[cfg.eval_metric]
                self.best_epoch = epoch
                progress = True
            elif (cfg.early_stop > 0
                  and epoch - self.best_epoch >= cfg.early_stop):
                self.log(f"early stop at epoch {epoch}!")
                break

            if cfg.save_model and cfg.model_dir and progress:
                self.save(os.path.join(cfg.model_dir, f"epoch_{epoch}"))

        self.log(f"best epoch: {self.best_epoch}")
        return self

    def save(self, path: str) -> None:
        checkpoint.save_state(os.path.abspath(path), self.state)

    def load(self, path: str) -> None:
        """Restore a checkpoint into the state.  Loading replaces the
        optimizers' tensors, which a captured train step still writes, so
        the graphs are dropped and the next steps capture again."""
        checkpoint.load_state(os.path.abspath(path), self.state)
        for steps in (self.multi_step, self.resident_step):
            if hasattr(steps, "reset"):
                steps.reset()

    def load_latest(self, model_dir: str) -> None:
        """tf.train.latest_checkpoint equivalent (sequential.py:352-353)."""
        self.load(checkpoint.latest_epoch_dir(model_dir))
