"""The initial weights from the seed, made on the device in a few large draws.

A leaf is named as the program's parameter tree names it (``layers.3.attn.wq``)
and has a shape and a type. Its values follow the last part of its name:
``table`` (the embedding) N(0, 0.02^2); a ``conv_*`` kernel N(0, 0.1^2); any
other matrix, laid out (in, out), N(0, 1/in); ``dt_bias`` and ``A_log`` 0;
any other vector (a norm's scale, ``D_skip``) 1. The normal leaves are drawn
from one generator on the device, in groups of at least ``GROUP`` values, each
group one call, and rounded to the leaf's type. The same leaves and seed give
the same bits, so the reference can make them again after the program's run.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import torch

GROUP = 1 << 27
Leaf = Tuple[str, Tuple[int, ...], torch.dtype]


def _std(name: str, shape: Sequence[int]) -> float:
    last = name.rsplit(".", 1)[-1]
    if last == "table":
        return 0.02
    if last.startswith("conv_"):
        return 0.1
    return 1.0 / math.sqrt(shape[0])


def _const(name: str) -> float:
    return 0.0 if name.rsplit(".", 1)[-1] in ("dt_bias", "A_log") else 1.0


def leaves_of(named) -> List[Leaf]:
    """``(name, shape, dtype)`` of each of ``named``'s (name, tensor) pairs."""
    return [(n, tuple(t.shape), t.dtype) for n, t in named]


def draw(leaves: Sequence[Leaf], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yields ``(name, values)`` for every leaf, in order, each in its own
    type on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    pending: List[Leaf] = []
    size = 0

    def flush():
        buf = torch.randn(size, generator=gen, dtype=torch.float32, device=device)
        at = 0
        for name, shape, dtype in pending:
            n = math.prod(shape)
            yield name, (buf[at:at + n].view(shape) * _std(name, shape)).to(dtype)
            at += n

    for leaf in leaves:
        name, shape, dtype = leaf
        if len(shape) < 2:
            yield name, torch.full(shape, _const(name), dtype=dtype, device=device)
            continue
        pending.append(leaf)
        size += math.prod(shape)
        if size >= GROUP:
            yield from flush()
            pending, size = [], 0
    if pending:
        yield from flush()
