"""Host -> device prefetching.

Counterpart of clsr_tpu/data/prefetch.py:30-91.  A producer thread turns
each host batch (numpy fields, data/loader.py) into tensors on the
device while the consumer trains on earlier ones, `depth` batches ahead.
An item is a [B] batch or a [K, B, ...] stack of K steps'
(`SequenceLoader.train_batches_stacked`); either is one copy a field.

On a CUDA device each field is copied into pinned host memory and then
to the device with `non_blocking=True` on a copy stream of the
producer's own; an event recorded after the batch's copies goes through
the queue with it.  The consumer's current stream waits on that event
before the batch is handed out, so no kernel reads a field before its
copy lands, and every field is `record_stream`ed on the consumer's
stream, so the caching allocator does not reuse its memory while work
queued there may still read it.  (The pinned buffers come from PyTorch's
caching host allocator, which keeps each one until its copy is done.)
On the CPU the thread only wraps the arrays as tensors: no pinning, no
streams.

Abandonment safety, as in the JAX package: a consumer that stops early
(early stop, an exception) closes the generator; the producer is
released through a stop flag and a queue drain, and exits.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator

import torch

from clsr_tpu_torch.data.batch import Batch

_SENTINEL = object()


def to_device(batch: Batch, device) -> Batch:
    """A host batch's fields as tensors on `device` (a plain copy)."""
    return Batch(**{f.name: torch.from_numpy(getattr(batch, f.name))
                    .to(device) for f in dataclasses.fields(batch)})


def _copy_async(batch: Batch, device, stream: torch.cuda.Stream):
    """(device batch, event after its copies), copied on `stream`."""
    with torch.cuda.stream(stream):
        out = Batch(**{f.name: torch.from_numpy(getattr(batch, f.name))
                       .pin_memory().to(device, non_blocking=True)
                       for f in dataclasses.fields(batch)})
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _claim(item, device) -> Batch:
    """Make the consumer's stream wait for the copies of a batch and mark
    its tensors as used there."""
    batch, event = item
    if event is None:
        return batch
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for f in dataclasses.fields(batch):
        getattr(batch, f.name).record_stream(stream)
    return batch


def prefetch_to_device(batches: Iterable[Batch], device,
                       depth: int = 2) -> Iterator[Batch]:
    """Yield the host `batches` as device batches, `depth` in flight."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def place(batch):
        if copy_stream is None:
            return to_device(batch, device), None
        return _copy_async(batch, device, copy_stream)

    def enqueue(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not enqueue(place(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            err.append(e)
        finally:
            enqueue(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield _claim(item, device)
        t.join()
        if err:
            raise err[0]
    finally:
        # consumer gone (early stop, exception, GeneratorExit): release
        # the producer and drop the queued batches
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def device_batches(batches: Iterable[Batch], device,
                   depth: int) -> Iterator[Batch]:
    """`prefetch_to_device` with `depth` batches in flight, or with
    depth 0 a plain copy of each batch when it is asked for."""
    if depth > 0:
        return prefetch_to_device(batches, device, depth)
    return (to_device(b, device) for b in batches)
