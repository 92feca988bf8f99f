"""Inference-only scoring service on one CUDA device.

Counterpart of clsr_tpu/serving.py (the reference has no serving path;
it dumps predictions from the training session,
sequential_base_model.py:326-347):

  * `ScoringService` — build the model once (random weights from the
    seed, a saved state_dict, the newest checkpoint of a training run
    (`load_latest`), or flax trees through weights.from_flax),
    then `score(requests)` batches of (user, history, C candidates)
    through the eval step.  One encoder pass per user scores all its
    candidates (the [B, G] Batch layout).
  * Shape buckets — requests are padded to (batch, candidates) buckets
    and padding scores are dropped, as on the TPU; it keeps the kernels'
    launch shapes to a handful.
  * `AsyncScoringService` — a thread-safe micro-batching frontend:
    callers submit() single requests and get futures; one dispatcher
    thread coalesces what has queued into shared dispatches.
  * int8 tables (`int8_tables=True`, JAX :125-144): after the optional
    checkpoint is loaded, `quantize_tables` replaces each table by
    symmetric per-row int8 rows and `<name>_scales` [N, 1] f32 beside
    it; lookups dequantize after the gather (models/base.py
    `lookup_rows`), and K1 runs as before.  The service honours the
    config's compute_dtype and embedding_dtype as training does.

Every model of the registry serves but LGN, which raises, as the JAX
service cannot build it (it holds no interaction graph).

On a (data, model) mesh (cfg.data_parallel * cfg.model_parallel > 1,
JAX :93-122; parallel/mesh.py) every rank of the process group builds
the same service and calls `score` with the same requests: the model's
tables are row-sharded (`place_model`, after a checkpoint is loaded in
the logical layout), each dispatch's rows are padded to a multiple of
the batch shards (flat under `resolve_flat_batch(cfg, pads_rows=True)`),
each rank scores its rows, K1 on its share, and the shards' scores are
gathered, so every rank returns every score.  The thread-driven
`AsyncScoringService` coalesces requests by arrival time, which the
ranks do not share, and refuses a mesh (ROADMAP queue 1 item 10c), as
do `save` and `load` of a mesh service's weights.
"""

from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from clsr_tpu_torch import weights
from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.parser import (compute_time_features,
                                        time_range_for_unit)
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.parallel.mesh import (make_mesh,
                                          make_sharded_eval_step,
                                          mesh_size, place_model)
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.steps import make_eval_step_fn
from clsr_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ScoreRequest:
    """One user's scoring request (raw string tokens, like the TSV)."""

    user: str
    hist_items: Sequence[str]
    hist_cates: Sequence[str]
    hist_times: Sequence[float]
    current_time: float
    cand_items: Sequence[str]
    cand_cates: Sequence[str]


@torch.no_grad()
def quantize_tables(model: nn.Module) -> None:
    """Row-quantize every `*_embedding` table of `model` to int8, in
    place (JAX `quantize_tables`, :125-144): symmetric per row, scale =
    max(max|row| / 127, 1e-12) in f32, q = clip(round(row / scale),
    -127, 127) rounding half to even as np.round does; the scales go
    beside the table as `<name>_scales` [N, 1].  Both are parameters
    without gradient, so `state_dict` and `weights.save` carry them.
    Serving only: training refuses the model."""
    for name, p in list(model.named_parameters()):
        path, _, leaf = name.rpartition(".")
        if not leaf.endswith("_embedding"):
            continue
        owner = model.get_submodule(path) if path else model
        table = p.detach().float()
        # divisions by tensors: true divisions, as numpy's (a CUDA
        # division by a Python number multiplies by its reciprocal)
        scale = torch.clamp(table.abs().amax(dim=1, keepdim=True)
                            / torch.full_like(table[:1, :1], 127.0),
                            min=1e-12)
        q = torch.clamp(torch.round(table / scale), -127, 127)
        quantized = nn.Parameter(q.to(torch.int8), requires_grad=False)
        if getattr(p, "mesh_rows", None) is not None:   # a sharded block
            quantized.mesh_rows = p.mesh_rows
        setattr(owner, leaf, quantized)
        setattr(owner, f"{leaf}_scales",
                nn.Parameter(scale, requires_grad=False))


class ScoringService:
    """Candidate scorer with shape-bucketed batching."""

    def __init__(self, cfg: Config, n_users: int, n_items: int,
                 n_cates: int, user_vocab: Vocab, item_vocab: Vocab,
                 cate_vocab: Vocab,
                 checkpoint: Optional[str] = None,
                 batch_buckets: Sequence[int] = (8, 64),
                 cand_buckets: Sequence[int] = (16, 128, 512),
                 int8_tables: bool = False,
                 device=None):
        if cfg.model_type.lower() == "lgn":
            # JAX's service builds the model without the interaction
            # graph LGN scores through (clsr_tpu/serving.py:79), so it
            # cannot serve LGN either
            raise ValueError(
                "ScoringService does not serve LGN: its scores come from "
                "the graph convolution over the train set's interaction "
                "graph, which a service does not hold; score LGN with the "
                "eval step (training/steps.py make_eval_step_fn)")
        self.cfg = cfg
        self.int8_tables = int8_tables
        self.device = resolve_device(device)
        self.vocabs = (user_vocab, item_vocab, cate_vocab)
        self.model = get_model_class(cfg.model_type)(
            cfg, n_users, n_items, n_cates, device=self.device)
        self.model.eval()
        self.mesh = (make_mesh(cfg, pads_rows=True) if mesh_size(cfg) > 1
                     else None)
        n = self.mesh.n_batch if self.mesh is not None else 1
        # a dispatch's rows: a multiple of the batch shards (JAX :228)
        self.batch_buckets = sorted({-(-b // n) * n for b in batch_buckets})
        self.cand_buckets = sorted(cand_buckets)
        self._time_range = time_range_for_unit(cfg.time_unit)
        self._eval_step = (make_eval_step_fn(cfg) if self.mesh is None
                           else make_sharded_eval_step(cfg, self.mesh))
        if checkpoint is not None:
            self.load(checkpoint)
        self._place()

    def _place(self) -> None:
        """Shard the tables over the mesh, then quantize (int8_tables)."""
        if self.mesh is not None:
            place_model(self.model, self.mesh)
        if self.int8_tables:
            quantize_tables(self.model)

    # ------------------------------------------------------------- ckpt
    def load(self, path: str) -> None:
        """Restore a state_dict written by `save` (weights.save) of a
        service like this one; a checkpoint given to the constructor is
        loaded before the tables are quantized."""
        self._refuse_mesh("load")
        weights.load(self.model, path)

    def save(self, path: str) -> None:
        self._refuse_mesh("save")
        weights.save(self.model, path)

    def _refuse_mesh(self, what: str) -> None:
        if self.mesh is not None and any(
                getattr(p, "mesh_rows", None) is not None
                for p in self.model.parameters()):
            raise NotImplementedError(
                f"{what} of a sharded service's weights waits for ROADMAP "
                f"queue 1 item 10c (parallel); load_latest reads a "
                f"training checkpoint on a mesh")

    def load_latest(self, model_dir: str) -> None:
        """Restore the model part of the newest `epoch_<n>` checkpoint
        that `training.trainer.Trainer` wrote into `model_dir`; with
        int8 tables it is quantized again after the load."""
        if self.int8_tables:        # the checkpoint holds float tables
            cfg = self.cfg
            self.model = get_model_class(cfg.model_type)(
                cfg, self.model.n_users, self.model.n_items,
                self.model.n_cates, device=self.device)
            self.model.eval()
            if self.mesh is not None:
                place_model(self.model, self.mesh)
        checkpoint.load_model(checkpoint.latest_epoch_dir(model_dir),
                              self.model, self.mesh)
        if self.int8_tables:
            quantize_tables(self.model)

    # ------------------------------------------------------------ batch
    def _bucket(self, buckets: Sequence[int], n: int) -> int:
        i = bisect.bisect_left(buckets, n)
        return buckets[min(i, len(buckets) - 1)]

    def _empty_batch(self, B: int, G: int) -> Batch:
        return Batch.zeros(B, G, self.cfg.max_seq_length)

    def _fill_row(self, batch: Batch, row: int, req: ScoreRequest,
                  G: int) -> None:
        uv, iv, cv = self.vocabs
        L = self.cfg.max_seq_length
        n = min(len(req.hist_items), L)
        hitems = iv.lookup_many(req.hist_items)
        hcates = cv.lookup_many(req.hist_cates)
        td, tff, ttn = compute_time_features(
            np.asarray(req.hist_times, np.float64), req.current_time,
            self._time_range)
        batch.users[row] = uv.lookup(req.user)
        if n:
            batch.item_hist[row, :n] = torch.tensor(hitems[-n:])
            batch.cate_hist[row, :n] = torch.tensor(hcates[-n:])
        batch.mask[row, :n] = 1.0
        batch.time_diff[row, :n] = torch.from_numpy(td[-n:])
        batch.time_from_first[row, :n] = torch.from_numpy(tff[-n:])
        batch.time_to_now[row, :n] = torch.from_numpy(ttn[-n:])
        C = len(req.cand_items)
        batch.items[row, :C] = torch.tensor(iv.lookup_many(req.cand_items))
        batch.cates[row, :C] = torch.tensor(cv.lookup_many(req.cand_cates))
        batch.valid[row] = 1.0

    # ------------------------------------------------------------ score
    def score(self, requests: List[ScoreRequest]) -> List[np.ndarray]:
        """Sigmoid scores per request, one array of len(cand_items) each.

        Requests are grouped by candidate-count bucket; each group pads
        to (batch bucket, cand bucket) and runs as one dispatch.
        """
        order: Dict[int, List[int]] = {}
        for i, req in enumerate(requests):
            if len(req.cand_items) > self.cand_buckets[-1]:
                raise ValueError(
                    f"request {i}: {len(req.cand_items)} candidates exceeds "
                    f"the largest bucket {self.cand_buckets[-1]}; raise "
                    f"cand_buckets or split the request")
            g = self._bucket(self.cand_buckets, len(req.cand_items))
            order.setdefault(g, []).append(i)

        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for G, idxs in order.items():
            for lo in range(0, len(idxs), self.batch_buckets[-1]):
                chunk = idxs[lo:lo + self.batch_buckets[-1]]
                B = self._bucket(self.batch_buckets, len(chunk))
                batch = self._empty_batch(B, G)
                for row, i in enumerate(chunk):
                    self._fill_row(batch, row, requests[i], G)
                preds, _ = self._eval_step(self.model,
                                           batch.to(self.device))
                preds = preds.cpu().numpy()
                for row, i in enumerate(chunk):
                    out[i] = preds[row, :len(requests[i].cand_items)].copy()
        return out   # type: ignore[return-value]


class AsyncScoringService:
    """Thread-safe micro-batching frontend over a ScoringService.

    Callers `submit()` single requests from any thread and receive
    futures; one dispatcher thread drains whatever has accumulated —
    bounded by `max_batch` rows and a `max_wait_ms` coalescing window —
    and runs it through `ScoringService.score`.
    """

    def __init__(self, service: ScoringService, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None):
        if service.mesh is not None:
            raise NotImplementedError(
                "the async frontend on a mesh waits for ROADMAP queue 1 "
                "item 10c (parallel): its ranks would coalesce different "
                "requests; call ScoringService.score on every rank")
        self._svc = service
        self._max_wait = max_wait_ms / 1e3
        self._max_batch = max_batch or service.batch_buckets[-1]
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self.dispatches = 0          # score() calls made by the dispatcher
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- client
    def submit(self, req: ScoreRequest) -> "Future[np.ndarray]":
        if self._closed:
            raise RuntimeError("service is closed")
        fut: "Future[np.ndarray]" = Future()
        self._q.put((req, fut))
        return fut

    def score(self, requests: List[ScoreRequest]) -> List[np.ndarray]:
        """Blocking convenience wrapper over submit()."""
        futs = [self.submit(r) for r in requests]
        return [f.result() for f in futs]

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join()

    # ------------------------------------------------------- dispatcher
    def _drain(self, first) -> List[Tuple[ScoreRequest, Future]]:
        items = [first]
        deadline = time.monotonic() + self._max_wait
        while len(items) < self._max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)    # keep the shutdown signal
                break
            items.append(nxt)
        return items

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            items = self._drain(item)
            reqs = [r for r, _ in items]
            try:
                scores = self._svc.score(reqs)
            except Exception as e:        # noqa: BLE001 — fail the batch
                for _, fut in items:
                    fut.set_exception(e)
                continue
            self.dispatches += 1
            for (_, fut), s in zip(items, scores):
                fut.set_result(s)
