"""Logical-axis sharding context (MaxText-style), with divisibility fallback.

Port of ``repro/sharding/ctx.py``. Models annotate activations with
*logical* axis names, e.g. ``shard(x, "batch", "seq", "embed")``. A
``use_mesh(mesh, rules)`` context resolves logical names to mesh axes;
outside a mesh context the annotation is a no-op, so every single-device
path runs as before.

Resolution drops a mesh axis when (a) it is absent from the mesh or (b) the
dim size does not divide the axis size, exactly as in JAX. ``logical_to_spec``
returns a tuple with the entries of JAX's ``PartitionSpec``.

GSPMD's counterpart is ``torch.distributed.tensor``: ``to_placements(spec,
mesh)`` turns a spec into one ``Shard(dim)``/``Replicate()`` per mesh axis,
and ``shard`` redistributes a ``DTensor`` to them (the collectives follow
from the placements, as GSPMD inserts them). ``place`` cuts a tensor that
every rank holds in full into its local shard without communicating.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import axis_sizes

_state = threading.local()

Logical = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Union[str, None, Tuple[str, ...]], ...]


def _ctx():
    if not hasattr(_state, "mesh"):
        _state.mesh = None
        _state.rules = {}
        _state.strategy = "baseline"
    return _state


@contextlib.contextmanager
def use_mesh(mesh, rules: Dict[str, Logical], strategy: str = "baseline"):
    st = _ctx()
    prev = (st.mesh, st.rules, st.strategy)
    st.mesh, st.rules, st.strategy = mesh, dict(rules), strategy
    try:
        yield
    finally:
        st.mesh, st.rules, st.strategy = prev


def axis_ctx():
    st = _ctx()
    return st.mesh, st.rules


def current_strategy() -> str:
    return _ctx().strategy


def mesh_axis_size(name: str) -> int:
    mesh, _ = axis_ctx()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def _resolve_one(logical: Optional[str], dim: int, sizes: Dict[str, int],
                 rules: Dict[str, Logical], used: set):
    """Logical name -> the spec entry of one dim, or None."""
    if logical is None:
        return None
    phys = rules.get(logical)
    if phys is None:
        return None
    if isinstance(phys, str):
        phys = (phys,)
    # keep only axes present in mesh, unused so far, whose product divides dim
    kept = []
    prod = 1
    for ax in phys:
        if ax not in sizes or ax in used:
            continue
        if dim % (prod * sizes[ax]) != 0:
            continue
        kept.append(ax)
        prod *= sizes[ax]
    if not kept:
        return None
    used.update(kept)
    return tuple(kept) if len(kept) > 1 else kept[0]


def logical_to_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                    mesh=None, rules: Optional[Dict[str, Logical]] = None) -> Spec:
    if mesh is None or rules is None:
        m, r = axis_ctx()
        mesh = mesh or m
        rules = rules if rules is not None else r
    if mesh is None:
        return ()
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    sizes = axis_sizes(mesh)
    used: set = set()
    entries = [_resolve_one(lg, d, sizes, rules, used)
               for lg, d in zip(logical_axes, shape)]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh):
    """A spec -> one placement per mesh axis: ``Shard(d)`` on the axes that
    spec entry d names, ``Replicate()`` on the rest. An entry naming several
    axes must name them in mesh order (major first), as every rule set does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_slices(shape: Sequence[int], mesh, placements) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``
    (even shards, mesh axes in order, the earlier axis major)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    sizes = list(axis_sizes(mesh).values())
    lo, n = [0] * len(shape), list(shape)
    for ax, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim % len(shape)
            n[d] //= sizes[ax]
            lo[d] += coord[ax] * n[d]
    return tuple(slice(a, a + b) for a, b in zip(lo, n))


def place(t: torch.Tensor, mesh, placements, *, requires_grad: bool = False):
    """A DTensor from ``t``, which every rank holds in full: each rank keeps
    its own block, with no communication."""
    from torch.distributed.tensor import DTensor
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = t[local_slices(t.shape, mesh, placements)].to(dev).contiguous()
    out = DTensor.from_local(local.detach(), mesh, placements, run_check=False)
    return out.requires_grad_(requires_grad)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to its logical sharding (no-op without a mesh, and
    for a tensor that is not a DTensor)."""
    mesh, rules = axis_ctx()
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, x.shape, mesh, rules)
    return x.redistribute(mesh, to_placements(spec, mesh))


def split_heads(x: torch.Tensor, heads: int, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` (B, S, heads * hd) viewed as (B, S, heads, hd), laid out for
    ``shard(view.transpose(1, 2), *logical_axes)`` (the names of the (B,
    heads, S, hd) layout). DTensor cannot split a dim that is sharded over
    more shards than ``heads`` divides, so under a mesh ``x`` first takes
    that layout on its own dims: where ``heads`` falls back to no axis, its
    last dim gives the model axis up (to the sequence, or to no dim). Where
    the heads keep the axes ``x``'s last dim has, nothing moves."""
    B, S, F = x.shape
    mesh, rules = axis_ctx()
    if mesh is not None and is_dtensor(x):
        spec = logical_to_spec(logical_axes, (B, heads, S, F // heads), mesh, rules)
        spec = tuple(spec) + (None,) * (4 - len(spec))
        if spec[3] is not None:
            raise ValueError(f"split_heads shards whole heads only, got {logical_axes}")
        x = x.redistribute(mesh, to_placements((spec[0], spec[2], spec[1]), mesh))
    return x.reshape(B, S, heads, F // heads)
