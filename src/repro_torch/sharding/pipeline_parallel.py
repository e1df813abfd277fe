"""GPipe-style pipeline parallelism over a ``stage`` mesh axis.

Port of ``repro/sharding/pipeline_parallel.py``. Each rank of the ``stage``
axis holds one stage's parameters; microbatches stream through in the
(M + S - 1)-tick schedule, the activation moving to the next stage by the
ring permute. The backward runs the reverse permute (``collectives.
ppermute``'s transpose), giving GPipe semantics (full activation stash).

As in JAX, every stage computes on every tick and selects with ``where``:
stage 0's input is its microbatch, the others' the received activation,
and only the last stage records outputs, which a sum over ``stage`` then
hands to every rank. The selections keep each rank's autograd graph the
same shape, so every rank runs the same permutes in the backward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding import collectives as C


def pipeline_apply(stage_fn: Callable, mesh, *, stage_axis: str = "stage",
                   num_microbatches: int):
    """Returns f(stage_params, x) -> y running the pipeline.

    stage_params: this rank's stage's parameters (JAX's stacked tree sliced
    at this rank's ``stage`` index).
    x: (num_microbatches, mb, ...) input microbatches, the same on every rank.
    stage_fn(params, mb_input) -> mb_output (same shape as input).
    y: (num_microbatches, mb, ...) on every rank.
    """
    S = C.axis_size(mesh, stage_axis)
    M = num_microbatches

    def run(stage_params, x):
        sid = C.axis_index(mesh, stage_axis)
        first = torch.tensor(sid == 0, device=x.device)
        last = torch.tensor(sid == S - 1, device=x.device)
        buf = torch.zeros_like(x[0])                 # the carried activation
        outs = [torch.zeros_like(x[0]) for _ in range(M)]
        for t in range(M + S - 1):
            inp = torch.where(first, x[min(t, M - 1)], buf)
            out = stage_fn(stage_params, inp)
            done = t - (S - 1)                       # the last stage finishes it
            if done >= 0:
                outs[done] = torch.where(last, out, outs[done])
            if t < M + S - 2:                        # the last tick's goes nowhere
                buf = C.ppermute(out, mesh, stage_axis, 1)
        y = torch.where(last, torch.stack(outs), torch.zeros_like(x))
        return C.psum(y, mesh, stage_axis)
    return run
