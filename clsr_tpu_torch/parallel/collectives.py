"""The mesh's collectives over a process group, in a fixed order.

GSPMD inserts the collectives of JAX's mesh; the port calls them itself,
each over one of the mesh's groups (parallel/mesh.py: a data column, a
model row, or every rank):

  * `all_gather(x, group)` -> [n, *x.shape], the group's tensors in
    group-rank order;
  * `all_reduce(x, group)`: the sum, taken as an all-gather and then
    gathered[0] + gathered[1] + ... in group-rank order, so the bits
    depend on the inputs alone: every rank gets the same bits, and two
    runs from one seed are bit-identical (no ring or tree order that a
    backend may choose);
  * `reduce_scatter(x, group)`: x [n, ...]; rank k gets sum_r x_r[k], by
    an all-to-all and the same rank-order sum;
  * `all_to_all(x, group)`: x [n, ...]; rank k gets [x_0[k], x_1[k],
    ...], no sum (the owner-routed merge's buckets,
    training/lazy_adam.py);
  * `broadcast(x, group, src)`: group rank src's x on every rank (the
    async mesh service's dispatches, serving.py).

`all_reduce_grad` is all_reduce as a `torch.autograd.Function` whose
backward is its transpose, an all_reduce (the batch statistics' sums,
parallel/mesh.py `batch_sum`); `all_gather_grad` is all_gather with the
rank's slice of the summed cotangent as its backward, a reduce_scatter
(the sequence-parallel merge, ops/long_context.py); the lookups write
their own backwards (parallel/embedding.py).

The collective-byte count (the counterpart of clsr_tpu/utils/
hlo_bytes.py's accounting, which reads the compiled HLO the port does
not have): inside `with count_collectives() as calls:` every call made
here appends a `Call` to `calls`: its kind, its group's name ('data',
'model' or 'world', as parallel/mesh.py `make_mesh` labels them), the
wire tensor's shape and dtype, its payload bytes (the tensor a rank
sends) and the bytes each rank receives, by hlo_bytes' ring formulas
applied to what is sent: an all_gather receives out * (g-1)/g, and so
does all_reduce, which is an all_gather here (the rank-order sum);
reduce_scatter and all_to_all, each one all-to-all, receive
in * (g-1)/g; a broadcast's receivers receive its payload, its source
nothing.  Outside the block it costs one list test a call.

A CUDA graph replays its collectives without Python, so the count
records them at capture: inside `with capturing() as calls:` (the
captured step, training/steps.py) the calls go to `calls` alone (the
capture runs nothing), and `replayed(calls)` after each replay appends
them to every open recorder, as `ops.launches.add` does for the
kernels' counters.  A graphed call of K steps so counts what K eager
steps do.

Under the gloo backend a CUDA tensor goes through host memory (gloo's
transport), and bool and bf16 tensors travel as uint8 and f32 (exact);
under nccl a tensor stays on its card (the casts run there, and the
all_gather writes one [n, ...] tensor), so a CUDA graph can capture
every collective.  A group of one rank returns its
input without a call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist

_WIRE_DTYPES = {torch.bool: torch.uint8, torch.bfloat16: torch.float32}


@dataclasses.dataclass
class Call:
    """One collective as the byte count records it."""

    kind: str                   # all_gather, all_reduce, reduce_scatter,
    #                             all_to_all, broadcast
    group: str                  # 'data', 'model', 'world' or 'other'
    shape: Tuple[int, ...]      # the wire tensor a rank sends
    dtype: torch.dtype
    payload_bytes: int          # that tensor's bytes
    received_bytes: int         # each rank's, by the ring formulas


_recorders: List[List[Call]] = []
_group_names: Dict[int, str] = {}


def label_group(group, name: str) -> None:
    """Name a process group for the byte count (parallel/mesh.py)."""
    _group_names[id(group)] = name


@contextlib.contextmanager
def count_collectives() -> Iterator[List[Call]]:
    """Record every collective made inside the block (see the module
    docstring); yields the list the calls are appended to."""
    calls: List[Call] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


@contextlib.contextmanager
def capturing() -> Iterator[List[Call]]:
    """Inside a CUDA graph's capture: record the collectives in the
    yielded list alone, none in the open recorders (the capture runs
    nothing); `replayed` adds them after each replay."""
    global _recorders
    outer, calls = _recorders, []
    _recorders = [calls]
    try:
        yield calls
    finally:
        _recorders = outer


def replayed(calls: List[Call]) -> None:
    """A captured graph was replayed: append its capture's calls to
    every open recorder."""
    for rec in _recorders:
        rec.extend(calls)


def _record(kind: str, w: torch.Tensor, group, n: int,
            received=None) -> None:
    if not _recorders:
        return
    payload = w.numel() * w.element_size()
    if received is None:
        received = (payload * (n - 1) if kind in ("all_gather",
                                                  "all_reduce")
                    else payload * (n - 1) // n)
    call = Call(kind, _group_names.get(id(group), "other"),
                tuple(w.shape), w.dtype, payload, received)
    for calls in _recorders:
        calls.append(call)


def group_size(group) -> int:
    return dist.get_world_size(group)


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    x = x.to(_WIRE_DTYPES.get(x.dtype, x.dtype))
    return x.contiguous()


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order."""
    out = parts[0]
    for k in range(1, parts.shape[0]):
        out = out + parts[k]
    return out


def _gather(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x[None]
    w = _to_wire(x, group)
    _record(kind, w, group, n)
    if dist.get_backend(group) == "gloo":
        out = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(out, w, group=group)
        return _from_wire(torch.stack(out), x)
    out = w.new_empty((n,) + tuple(w.shape))
    dist.all_gather_into_tensor(out, w, group=group)
    return _from_wire(out, x)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's x in group-rank order."""
    return _gather(x, group, "all_gather")


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x, in group-rank order."""
    if group_size(group) == 1:
        return x
    return _ordered_sum(_gather(x, group, "all_reduce"))


def _exchange(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """out[r] = x_r[me] for x [n, ...]: one all_to_all_single."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"{kind} over {n} ranks needs a leading axis of "
                         f"{n}, got {tuple(x.shape)}")
    if n == 1:
        return x
    w = _to_wire(x, group)
    _record(kind, w, group, n)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _from_wire(out, x)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] on each rank; rank k gets the sum over ranks r of
    x_r[k], in rank order."""
    return _ordered_sum(_exchange(x, group, "reduce_scatter"))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] on each rank; rank k gets [x_0[k], x_1[k], ...] (no
    sum): x_r[k] is what rank r sends rank k."""
    return _exchange(x, group, "all_to_all")


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank `src`'s x on every rank of the group; on the other
    ranks x gives the shape, dtype and device to receive (no sum, the
    same bits everywhere)."""
    n = group_size(group)
    if n == 1:
        return x
    w = _to_wire(x, group).clone()
    me = dist.get_rank(group)
    _record("broadcast", w, group, n,
            0 if me == src else w.numel() * w.element_size())
    dist.broadcast(w, src=dist.get_global_rank(group, src), group=group)
    return _from_wire(w, x)


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce with an all_reduce backward."""
    return _AllReduce.apply(x, group)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group), None


def all_gather_grad(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather whose backward hands each rank its slice of the
    cotangent summed over the group (each rank's loss a share of the
    whole, as for all_reduce_grad)."""
    return _AllGather.apply(x, group)
