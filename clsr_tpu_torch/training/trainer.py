"""Training driver: epoch loop, early stopping, checkpointing.

Counterpart of clsr_tpu/training/trainer.py (`__init__`, `fit`, `save`,
`load`, `load_latest`; :33-137, 449-676, 683-732) on one device, the
streaming path; it mirrors the reference's SequentialBaseModel.fit
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
  * `resident_data: auto` streams.  The JAX package's resident epoch
    draws its order as `np_rng.permutation(eligible)`, which consumes
    the RandomState as `rng.shuffle` of the same ids does, and gathers
    the same rows with the same padding, so it is step for step the
    computation streamed here.  `on` raises (ROADMAP queue 1 item 5).
  * `train_steps_per_call` K > 1 takes JAX's stacked path (:112-115,
    :567-594): the loader gathers the epoch once and yields [K, B, ...]
    stacks of whole batches, then the [B] tail batches
    (`train_batches_stacked`); each stack is one host-to-device copy and
    one call of `make_multi_train_step`, which on the card replays a
    CUDA graph of the train step K times (training/steps.py
    `MultiTrainStep`), and each tail batch one replay.  The first step
    of a fit is the graph's warm-up and runs eagerly.  The same steps
    run as with K = 1, which keeps the eager single steps, and the log
    groups them as JAX does (each call's K steps, then single steps).
  * The loss sums stay on the device; the host reads them at show_step
    boundaries and once at the end of an epoch.  The JAX streaming path
    reads `float(parts.loss)` every step, which here would make the host
    wait for the device every step; the logged numbers are the same.
  * A mesh (item 10), mid-epoch autosave and resume, histograms and
    TensorBoard files (item 11) raise.
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
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_eval_step_fn,
                                           make_multi_train_step,
                                           make_train_step)
from clsr_tpu_torch.utils.summaries import SummaryWriter


def check_trainable(cfg: Config) -> None:
    """Raise on settings whose fit path is not ported, naming the ROADMAP
    item that brings it."""
    if cfg.data_parallel * cfg.model_parallel > 1:
        raise NotImplementedError(
            "a device mesh (data_parallel * model_parallel > 1) waits for "
            "ROADMAP queue 1 item 10 (parallel)")
    if cfg.resident_data == "on":
        raise NotImplementedError(
            "resident_data 'on' waits for ROADMAP queue 1 item 5 "
            "(device-resident data); 'auto' and 'off' stream")
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
        self.state = create_train_state(model, cfg)
        self.train_step = make_train_step(model, cfg)
        self.eval_step = make_eval_step_fn(cfg)
        self.multi_step = (make_multi_train_step(
            model, cfg, cfg.train_steps_per_call)
            if cfg.train_steps_per_call > 1 else None)
        self.best_epoch = 0
        self.eval_history: List[Tuple[int, Dict[str, float]]] = []
        # per epoch: steps, examples, train and eval seconds, mean loss
        self.epoch_stats: List[Dict[str, float]] = []
        self.summary = SummaryWriter(cfg.summaries_dir, cfg.write_tfevents)

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
        best_metric = 0.0
        self.best_epoch = 0
        step = 0
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.time()
            n_steps, n_examples = 0, 0
            epoch_loss = None

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

            if multi is not None:
                items = train_loader.train_batches_stacked(
                    B, K, np_rng, min_seq_length=cfg.min_seq_length)
            else:
                items = train_loader.train_batches(
                    B, np_rng, min_seq_length=cfg.min_seq_length)
            for item in device_batches(counted(items), self.device,
                                       cfg.prefetch_batches):
                if item.users.ndim == 2:        # [K, B, ...] stacked
                    self.state, parts = multi(self.state, item, generator)
                    emit(K, parts.loss.sum(), parts.data_loss.sum())
                else:                           # tail / single steps
                    self.state, parts = single(self.state, item, generator)
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
                train_s=train_time, eval_s=eval_time, mean_loss=mean_loss))
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
        the graph is dropped and the next step captures again."""
        checkpoint.load_state(os.path.abspath(path), self.state)
        if self.multi_step is not None:
            self.multi_step.reset()

    def load_latest(self, model_dir: str) -> None:
        """tf.train.latest_checkpoint equivalent (sequential.py:352-353)."""
        self.load(checkpoint.latest_epoch_dir(model_dir))
