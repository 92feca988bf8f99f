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
gathered, so every rank returns every score.  int8 tables are quantized
after sharding (a row's scale is its own, so the rows are the one-rank
service's), and each block's `_scales` rows are marked as its table is.
`save` writes the logical layout (each row-sharded table and scales
block gathered over its model row; rank 0 writes, every rank waits) and
`load` reads a logical file on every rank and keeps the rank's blocks,
so weights move between a mesh service and a one-device one both ways.

The async frontend on a mesh: JAX's is one controller, the port has a
process a rank, and the ranks do not share the requests' arrival times.
So every rank builds an `AsyncScoringService` over its service; on rank
0 the dispatcher thread decides each dispatch (which requests, their
buckets), assembles all its batches (`ScoringService.plan`: a bad
request fails there, before anything is sent), and before each eval
step broadcasts the batch over the world (a header of (op, B, G,
last), then each field: parallel/collectives.py `broadcast`); every
other rank runs a follower thread that receives each batch, calls the
same eval step, counts a dispatch at its last batch, and stops at rank
0's close.  A step or collective that raises after a broadcast leaves
the ranks out of step (a follower may wait in the step's gather), so
it stops the frontend for good: rank 0 fails every pending future and
refuses later submits, and sends nothing more; a follower still in a
collective waits out the process group's timeout.  `submit` on
another rank raises; every rank calls `close`.  While it runs, the
ranks' service is driven by it alone.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
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
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.mesh import (barrier, local_tensor,
                                          logical_tensor, make_mesh,
                                          make_sharded_eval_step,
                                          mesh_size, place_model,
                                          sharded_tables)
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
        scales = nn.Parameter(scale, requires_grad=False)
        if getattr(p, "mesh_rows", None) is not None:   # a sharded block
            quantized.mesh_rows = scales.mesh_rows = p.mesh_rows
        setattr(owner, leaf, quantized)
        setattr(owner, f"{leaf}_scales", scales)


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
        loaded before the tables are quantized.  On a mesh every rank
        reads the logical file and keeps its blocks."""
        if self.mesh is None:
            weights.load(self.model, path)
            return
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for name in sharded_tables(self.model):
            sd[name] = local_tensor(sd[name], self.mesh)
        self.model.load_state_dict(sd)

    def save(self, path: str) -> None:
        """weights.save of the model; on a mesh every rank calls it and
        rank 0 writes the logical layout."""
        if self.mesh is None:
            weights.save(self.model, path)
            return
        sd = self.model.state_dict()
        for name in sharded_tables(self.model):
            sd[name] = logical_tensor(sd[name], self.mesh)
        if self.mesh.rank == 0:
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(sd, tmp)
            os.replace(tmp, path)
        barrier(self.mesh)

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
    def step(self, batch: Batch) -> np.ndarray:
        """The eval step's scores [B, G] of a device batch."""
        preds, _ = self._eval_step(self.model, batch)
        return preds.cpu().numpy()

    def plan(self, requests: List[ScoreRequest]
             ) -> List[Tuple[List[int], Batch]]:
        """The dispatches of `requests`: (the requests' indices, their
        device batch) each.  Requests are grouped by candidate-count
        bucket; each group pads to (batch bucket, cand bucket).  Every
        request is checked and filled here, before any step runs."""
        order: Dict[int, List[int]] = {}
        for i, req in enumerate(requests):
            if len(req.cand_items) > self.cand_buckets[-1]:
                raise ValueError(
                    f"request {i}: {len(req.cand_items)} candidates exceeds "
                    f"the largest bucket {self.cand_buckets[-1]}; raise "
                    f"cand_buckets or split the request")
            g = self._bucket(self.cand_buckets, len(req.cand_items))
            order.setdefault(g, []).append(i)

        plan = []
        for G, idxs in order.items():
            for lo in range(0, len(idxs), self.batch_buckets[-1]):
                chunk = idxs[lo:lo + self.batch_buckets[-1]]
                B = self._bucket(self.batch_buckets, len(chunk))
                batch = self._empty_batch(B, G)
                for row, i in enumerate(chunk):
                    self._fill_row(batch, row, requests[i], G)
                plan.append((chunk, batch.to(self.device)))
        return plan

    @staticmethod
    def unpad(out: List[Optional[np.ndarray]],
              requests: List[ScoreRequest], chunk: List[int],
              preds: np.ndarray) -> None:
        """The scores of a dispatch's requests, cut from its `preds`,
        into `out`."""
        for row, i in enumerate(chunk):
            out[i] = preds[row, :len(requests[i].cand_items)].copy()

    def score(self, requests: List[ScoreRequest]) -> List[np.ndarray]:
        """Sigmoid scores per request, one array of len(cand_items) each:
        every dispatch of `plan` through the eval step."""
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for chunk, batch in self.plan(requests):
            self.unpad(out, requests, chunk, self.step(batch))
        return out   # type: ignore[return-value]


# the async mesh frontend's broadcast header: (op, B, G, last), `last`
# 1 on a dispatch's last batch
_CLOSE, _STEP = 0, 1


class AsyncScoringService:
    """Thread-safe micro-batching frontend over a ScoringService.

    Callers `submit()` single requests from any thread and receive
    futures; one dispatcher thread drains whatever has accumulated —
    bounded by `max_batch` rows and a `max_wait_ms` coalescing window —
    and runs it as one dispatch: `ScoringService.plan`, then each batch
    through its eval step.  On a mesh every rank builds one: rank 0's
    dispatcher leads and broadcasts each batch, the other ranks' threads
    follow it (the module docstring).  A request that fails in `plan`
    fails its dispatch alone.  On a mesh a failure after the first
    broadcast leaves the ranks' collectives out of step, so it stops
    the frontend: every pending future fails, `submit` raises, and
    `error` holds the cause (on each rank whose thread saw it).
    """

    def __init__(self, service: ScoringService, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None):
        self._svc = service
        self._max_wait = max_wait_ms / 1e3
        self._max_batch = max_batch or service.batch_buckets[-1]
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.error: Optional[BaseException] = None
        self.dispatches = 0          # dispatches that ran to their end
        mesh = service.mesh
        self._lead = mesh is None or mesh.rank == 0
        # the thread's card: CUDA's current device is a thread's own
        dev = service.device
        self._card = (None if dev.type != "cuda" else dev.index
                      if dev.index is not None
                      else torch.cuda.current_device())
        self._thread = threading.Thread(
            target=self._loop if self._lead else self._follow, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- client
    def submit(self, req: ScoreRequest) -> "Future[np.ndarray]":
        if not self._lead:
            raise RuntimeError(
                f"submit on rank {self._svc.mesh.rank}: on a mesh rank 0 "
                f"takes the requests and the other ranks follow it")
        fut: "Future[np.ndarray]" = Future()
        with self._lock:
            if self.error is not None:
                raise RuntimeError(
                    f"the mesh service stopped: {self.error!r}")
            if self._closed:
                raise RuntimeError("service is closed")
            self._q.put((req, fut))
        return fut

    def score(self, requests: List[ScoreRequest]) -> List[np.ndarray]:
        """Blocking convenience wrapper over submit()."""
        futs = [self.submit(r) for r in requests]
        return [f.result() for f in futs]

    def close(self) -> None:
        """Stop the thread (on a mesh every rank calls it: rank 0's close
        ends the followers' loops)."""
        with self._lock:
            self._closed = True
            if self._lead:
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

    def _header(self, op: int, B: int = 0, G: int = 0,
                last: int = 0) -> Tuple[int, ...]:
        """Rank 0's (op, B, G, last), on every rank of the mesh."""
        svc = self._svc
        return tuple(int(v) for v in col.broadcast(
            torch.tensor([op, B, G, last], dtype=torch.int64,
                         device=svc.device), svc.mesh.world))

    def _share(self, batch: Batch, last: bool) -> None:
        """Rank 0: a batch of a dispatch to the followers, before its
        step."""
        self._header(_STEP, *batch.items.shape, int(last))
        for f in dataclasses.fields(Batch):
            col.broadcast(getattr(batch, f.name), self._svc.mesh.world)

    def _on_device(self) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)

    def _loop(self) -> None:
        self._on_device()
        svc, mesh = self._svc, self._svc.mesh
        while True:
            item = self._q.get()
            if item is None:
                if mesh is not None:
                    self._header(_CLOSE)
                return
            items = self._drain(item)
            reqs = [r for r, _ in items]
            try:
                plan = svc.plan(reqs)
            except Exception as e:        # noqa: BLE001 — fail the batch
                for _, fut in items:
                    fut.set_exception(e)
                continue
            out: List[Optional[np.ndarray]] = [None] * len(reqs)
            try:
                for k, (chunk, batch) in enumerate(plan):
                    if mesh is not None:
                        self._share(batch, k == len(plan) - 1)
                    svc.unpad(out, reqs, chunk, svc.step(batch))
            except Exception as e:        # noqa: BLE001 — fail the batch
                if mesh is not None:
                    self._stop(e)
                for _, fut in items:
                    fut.set_exception(e)
                if mesh is not None:
                    return
                continue
            self.dispatches += 1
            for (_, fut), s in zip(items, out):
                fut.set_result(s)

    def _stop(self, e: BaseException) -> None:
        """Rank 0 after a failure past a broadcast: no more collectives;
        fail what is queued."""
        with self._lock:
            self.error = e
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return
                if item is not None:
                    item[1].set_exception(e)

    def _follow(self) -> None:
        """A rank but 0: receive each batch of rank 0's dispatches and run
        its step, until rank 0 closes or a step or collective raises."""
        self._on_device()
        svc, world = self._svc, self._svc.mesh.world
        L = svc.cfg.max_seq_length
        try:
            while True:
                op, B, G, last = self._header(_CLOSE)
                if op == _CLOSE:
                    return
                empty = Batch.zeros(B, G, L).to(svc.device)
                svc.step(Batch(**{
                    f.name: col.broadcast(getattr(empty, f.name), world)
                    for f in dataclasses.fields(Batch)}))
                self.dispatches += last
        except Exception as e:            # noqa: BLE001 — kept for close
            self.error = e
