"""The collectives of the training mesh, as autograd functions.

JAX's GSPMD inserts these itself. Here each is spelled out on
``all_reduce`` and ``all_gather_into_tensor`` (``all_gather_single`` where
torch has renamed it), which NCCL and gloo both take on CUDA tensors
(scripts/probe_torch_collectives.py tries gloo's on the card). A group of
one rank is the identity everywhere.

- ``TensorParallel`` (over ``model``), Megatron's pair around the
  column-split q/k/v/gate/up and the row-split o/down projections:
  ``enter`` is the identity forward with an all-reduce backward (each rank
  feeds the replicated activation to its columns, so the activation's
  gradient sums over the ranks), ``reduce`` an all-reduce forward with the
  identity backward (the row-split products are partial sums).
- ``gather_rows`` (over ``data``): every rank's rows stacked in rank
  order; its backward returns this rank's rows of the gradient and does
  not sum over ranks (``torch.distributed.nn.functional.all_gather``'s
  does, which would scale the gradient of a loss that every rank computes
  alike by the group's size).
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; every rank gets the same sum."""
    if group_size(group) > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_reduce_many(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor (of one dtype and device) over ``group`` in place,
    with one collective for all of them."""
    if group_size(group) <= 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    start = 0
    for t in tensors:
        t.copy_(flat[start : start + t.numel()].view_as(t))
        start += t.numel()


def gather_dim(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along ``dim`` in rank order (no
    gradient)."""
    size = group_size(group)
    if size == 1:
        return tensor
    front = tensor.movedim(dim, 0).contiguous()
    full = front.new_empty((size * front.shape[0], *front.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(full, front, group=group)
    return full.movedim(0, dim).contiguous()


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRows(torch.autograd.Function):
    """Rows of every rank stacked in rank order; the backward keeps this
    rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.index = dist.get_rank(group)
        return gather_dim(x.contiguous(), 0, group)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.rows
        return grad[start : start + ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each of the group's ranks -> [size * n, ...]."""
    if group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis: ``index`` of ``size``."""

    group: object
    size: int
    index: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)


def tensor_parallel(mesh) -> TensorParallel | None:
    """The model axis of a process mesh, or None where it has one rank."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return TensorParallel(mesh.groups["model"], mesh.shape["model"], mesh.coords["model"])
