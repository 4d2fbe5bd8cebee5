"""Collectives over a process group: what `lax.psum`, `lax.pmax` and
`lax.all_gather` are inside JAX's `shard_map`
(`stratanet2_tpu/parallel/point_sharded.py`).

Every collective here is built on `all_reduce` and `broadcast` alone, the
two that gloo runs on CUDA tensors (two ranks share the one card over
gloo). An all-gather is a zeroed (D, ...) buffer with this rank's slot
filled, all-reduced with SUM: x + 0 is x, so it is exact.

The differentiable versions follow one rule: the backward of a collective
sums the cotangents of every rank. Each rank's loss is its share of the
global loss (a term replicated on D ranks enters each divided by D, see
`learning/train.py`), so the cotangent a rank receives at a collective's
output is the derivative of its own share; summing them over the group
gives the derivative of the global loss, and the parameter gradients are
then all-reduced with SUM once, before the optimizer. Nothing is scaled by
the world size.

A group of `None` is one rank: every collective is the identity there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor holding the reduction of `x` over the group (sum, max
    or min); bool tensors reduce as uint8 (max is any, min is all)."""
    if group is None:
        return x.clone()
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x.detach()).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return y.bool() if x.dtype == torch.bool else y


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(D, *x.shape): slot r holds rank r's `x`, on every rank."""
    d = group_size(group)
    if group is None:
        return x[None].clone()
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.detach()
    buf = torch.zeros((d,) + tuple(x.shape), dtype=src.dtype, device=x.device)
    buf[group_rank(group)] = src
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.bool() if x.dtype == torch.bool else buf


def broadcast_(x: torch.Tensor, src_rank: int = 0, group=None) -> torch.Tensor:
    """`x` overwritten in place by group rank `src_rank`'s copy."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, src_rank), group=group)
    return x


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


class _GatherAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group)[group_rank(ctx.group)], None


def sum_across(x: torch.Tensor, group=None) -> torch.Tensor:
    """psum: the sum of every rank's `x`, differentiable."""
    return x if group is None else _SumAcross.apply(x, group)


def gather_across(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_gather: (D, *x.shape), differentiable."""
    return x[None] if group is None else _GatherAcross.apply(x, group)


def max_across(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over ranks as a gather then `torch.amax`, which
    splits a cotangent evenly among tied ranks, as `jnp.max` over JAX's
    gathered axis does (`torch.max(dim)` would send it to one)."""
    return x if group is None else torch.amax(_GatherAcross.apply(x, group), dim=0)


def mean_parts(parts: dict, group=None) -> dict:
    """{name: scalar} averaged over the group's ranks in one all-reduce
    (detached): the global mean of per-rank means over equal shares."""
    if group is None:
        return parts
    names = list(parts)
    total = all_reduce(torch.stack([parts[k].detach() for k in names]), "sum", group)
    return dict(zip(names, (total / group_size(group)).unbind()))


def reduce_gradients(module: torch.nn.Module, group=None) -> None:
    """Every parameter's gradient summed over the group's ranks, in one
    all-reduce (a parameter without one counts as zero)."""
    if group is None:
        return
    params = list(module.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), "sum", group)
    for p, part in zip(params, torch.split(flat, [g.numel() for g in grads])):
        p.grad = part.reshape(p.shape)
