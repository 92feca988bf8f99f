"""Process groups: one process a rank, over torch.distributed.

Counterpart of clsr_tpu/parallel/distributed.py.  JAX's mesh is one
controller over every chip (`jax.distributed.initialize` on a pod); the
port runs one process a rank, and the collectives of the mesh
(parallel/collectives.py) run over a torch.distributed process group.

  * `init_process_group(backend, ...)` joins the group, either from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    or from a `FileStore` path with an explicit rank and world size.
    The backend is an explicit argument, `nccl` or `gloo`: nothing picks
    one or falls back to another.  `nccl` needs a GPU a rank and raises
    when two ranks of a host would share one;
  * `rank_device(backend, device)` is the device of this rank: under
    nccl `cuda:<LOCAL_RANK>`, under gloo the device given (gloo moves
    CUDA tensors through host memory, so several gloo ranks may share
    one card);
  * `host_batch_slice(global_rows, n, i)`: the [start, end) rows of the
    global batch that batch shard i of n holds;
  * `run_local_world(fn, world_size, backend, device, args)` spawns
    world_size local ranks, each joining a FileStore group and calling
    fn(rank, rank_device(backend, device), *args) with one torch
    thread, and returns their results in rank order.  A rank that
    raises, or a world that outlasts `timeout_s`, fails the call and
    stops every rank; the group's own timeout is the same, so a
    collective that hangs fails too.  The CLI and the tests both use
    it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
STORE_NAME = "store"


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def init_process_group(backend: str, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       store_path: Optional[str] = None,
                       timeout_s: float = 600.0) -> None:
    """Join the process group: from torchrun's environment when
    `store_path` is None, else from a FileStore at `store_path`."""
    _check_backend(backend)
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group: set {missing} (torchrun does) or "
                f"spawn the ranks with run_local_world")
        if backend == "nccl":
            rank_device(backend, None)       # refuse before joining
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore group needs rank and world_size")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    if backend == "nccl":
        rank_device(backend, None)


def rank_device(backend: str, device) -> torch.device:
    """This rank's device: under nccl cuda:<LOCAL_RANK>, raising unless
    every rank of the host has a GPU of its own; under gloo `device`."""
    _check_backend(backend)
    if backend == "gloo":
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK",
                                    dist.get_rank() if dist.is_initialized()
                                    else 0))
    local_world = int(os.environ.get(
        "LOCAL_WORLD_SIZE",
        dist.get_world_size() if dist.is_initialized() else 1))
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > n_gpus:
        raise RuntimeError(
            f"nccl needs a GPU a rank: {local_world} ranks on this host, "
            f"{n_gpus} GPUs (two ranks would map to one GPU); run gloo or "
            f"fewer ranks")
    return torch.device("cuda", local_rank)


def host_batch_slice(global_rows: int, n: int, i: int) -> Tuple[int, int]:
    """[start, end) of the global batch that batch shard i of n holds."""
    if global_rows % n:
        raise ValueError(f"global batch {global_rows} not divisible by "
                         f"{n} batch shards")
    per = global_rows // n
    return i * per, (i + 1) * per


def _rank_main(fn, rank, world_size, backend, device, store_path, args,
               timeout_s, results):
    torch.set_num_threads(1)
    try:
        init_process_group(backend, rank, world_size, store_path, timeout_s)
        dev = rank_device(backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(rank, dev, *args)
        results.put((rank, True, out))
    except Exception:           # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_world(fn: Callable[..., Any], world_size: int, backend: str,
                    device, args: Sequence = (), timeout_s: float = 600.0
                    ) -> List[Any]:
    """Spawn `world_size` local ranks running fn(rank, device, *args) in
    a FileStore group of `backend`; their results, in rank order.  `fn`
    and `args` must pickle (a module-level function and its
    arguments)."""
    _check_backend(backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="clsr_world_")
    store = os.path.join(tmp, STORE_NAME)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, device, store,
                               tuple(args), timeout_s, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"the local world of {world_size} ranks did not finish "
                    f"in {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append((rank, value))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} of the local world failed:\n"
                               f"{tb}")
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors and len(out) == world_size
                   else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
