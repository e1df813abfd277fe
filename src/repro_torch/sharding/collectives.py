"""Collectives over one mesh axis, each with its transpose as backward.

The counterparts of ``jax.lax.all_to_all`` / ``all_gather`` /
``psum_scatter`` / ``psum`` / ``pmax`` / ``ppermute`` inside JAX's
``shard_map``, on the local shards of a ``DeviceMesh`` axis (its process
group), as ``torch.autograd.Function``s over ``torch.distributed``:

=============  ==================================  ======================
collective     forward                             backward
=============  ==================================  ======================
all_to_all     chunk i of dim 0 to rank i          all_to_all
all_gather     concatenate the ranks' blocks       reduce_scatter (sum)
reduce_scatter sum, rank i keeps block i           all_gather
psum           sum over the axis                   identity
pmax           max over the axis                   none (scales only)
ppermute       ring shift by ``shift``             ring shift by -shift
=============  ==================================  ======================

``psum``'s output is replicated over the axis and read by replicated code,
so each rank's cotangent is already the whole one and passes unchanged; an
input that was replicated over the axis then holds a partial gradient on
each rank, which its caller declares (``to_local(grad_placements=
Partial())``). The tensors stay where they are: on the card NCCL moves them
device to device, on the CPU gloo. int16 travels as its bytes
(``view(torch.int8)``), since neither gloo's all-gather nor NCCL takes it.

``BYTES`` counts, per collective, the bytes handed to it (each call's input,
forward and backward), so a test can hold one reduction's wire volume
against another's. While ``TRACE`` holds a ``roofline.StepCounter``, each
call also hands it the kind, result bytes and group of the collective, for
its wire bytes by the ring model.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

BYTES: Dict[str, int] = {"all_to_all": 0, "all_gather": 0, "reduce_scatter": 0,
                         "psum": 0, "pmax": 0, "ppermute": 0}
# The open step count (``roofline.analysis.count_step``), or None.
TRACE = None
# Each collective as JAX's HLO names it, and its result's size over its input's
# for a group of n.
_KIND = {"all_to_all": ("all-to-all", lambda n: 1), "all_gather": ("all-gather", lambda n: n),
         "reduce_scatter": ("reduce-scatter", lambda n: 1 / n),
         "psum": ("all-reduce", lambda n: 1), "pmax": ("all-reduce", lambda n: 1),
         "ppermute": ("collective-permute", lambda n: 1)}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def _count(name: str, x: torch.Tensor, g) -> None:
    nbytes = x.numel() * x.element_size()
    BYTES[name] += nbytes
    if TRACE is not None:
        kind, result = _KIND[name]
        ranks = dist.get_process_group_ranks(g)
        TRACE.add_collective(kind, nbytes * result(len(ranks)), ranks,
                             x.dtype == torch.float32)


def group(mesh, axis: str):
    return mesh.get_group(axis)


def _size(g) -> int:
    return dist.get_world_size(g)


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int8) if x.dtype == torch.int16 else x.contiguous()


def _a2a(x: torch.Tensor, g) -> torch.Tensor:
    _count("all_to_all", x, g)
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=g)
    return out.view(x.dtype)


def _gather(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    _count("all_gather", x, g)
    n = _size(g)
    w = _wire(x.movedim(dim, 0))
    out = torch.empty((n * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.all_gather_into_tensor(out, w, group=g)
    return out.view(x.dtype).movedim(0, dim)


def _scatter(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    _count("reduce_scatter", x, g)
    n = _size(g)
    w = x.movedim(dim, 0).contiguous()
    out = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.reduce_scatter_tensor(out, w, group=g)
    return out.movedim(0, dim)


def _shift(x: torch.Tensor, g, shift: int) -> torch.Tensor:
    _count("ppermute", x, g)
    n = _size(g)
    x = x.contiguous()
    if n == 1:
        return x.clone()
    ranks = dist.get_process_group_ranks(g)
    me = dist.get_group_rank(g, dist.get_rank())
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + shift) % n], g),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], g)]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _a2a(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _a2a(dy, ctx.g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter(dy, ctx.g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _scatter(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.g, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        _count("psum", x, g)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift):
        ctx.g, ctx.shift = g, shift
        return _shift(x, g, shift)

    @staticmethod
    def backward(ctx, dy):
        return _shift(dy, ctx.g, -ctx.shift), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-to-all on dim 0: chunk i goes to rank i of ``axis``, the
    received chunks are concatenated in rank order."""
    return _AllToAll.apply(x, group(mesh, axis))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim``, in rank order."""
    return _AllGather.apply(x, group(mesh, axis), dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Sum over ``axis``; rank i keeps block i of ``dim`` (``psum_scatter``
    with ``tiled=True``)."""
    return _ReduceScatter.apply(x, group(mesh, axis), dim)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _Psum.apply(x, group(mesh, axis))


@torch.no_grad()
def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    g = group(mesh, axis)
    _count("pmax", x, g)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    return out


def psum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` over each mesh axis of ``axes`` in turn: the sum over their
    product group."""
    for a in axes:
        x = psum(x, mesh, a)
    return x


def pmax_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmax`` over each mesh axis of ``axes`` in turn."""
    for a in axes:
        x = pmax(x, mesh, a)
    return x


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i sends to rank (i + shift) mod n of ``axis``."""
    return _Ppermute.apply(x, group(mesh, axis), shift)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))
