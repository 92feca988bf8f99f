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
    an all-to-all and the same rank-order sum.

`all_reduce_grad` is all_reduce as a `torch.autograd.Function` whose
backward is its transpose, an all_reduce (the batch statistics' sums,
parallel/mesh.py `batch_sum`); the lookups write their own backwards
(parallel/embedding.py).

Under the gloo backend a CUDA tensor goes through host memory (gloo's
transport), and bool and bf16 tensors travel as uint8 and f32 (exact);
under nccl tensors stay on their card.  A group of one rank returns its
input without a call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_WIRE_DTYPES = {torch.bool: torch.uint8, torch.bfloat16: torch.float32}


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


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's x in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x[None]
    w = _to_wire(x, group)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return _from_wire(torch.stack(out), x)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x, in group-rank order."""
    if group_size(group) == 1:
        return x
    return _ordered_sum(all_gather(x, group))


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] on each rank; rank k gets the sum over ranks r of
    x_r[k], in rank order."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"reduce_scatter over {n} ranks needs a leading "
                         f"axis of {n}, got {tuple(x.shape)}")
    if n == 1:
        return x[0]
    w = _to_wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _ordered_sum(_from_wire(out, x))


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
