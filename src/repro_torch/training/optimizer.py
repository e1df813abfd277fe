"""Optimizers of the port: AdamW (fp32 moments) and global-norm clipping.

Port of ``repro/training/optimizer.py``. A tree is a dict from the port's
parameter names (``named_parameters()``) to tensors, so gradients, moments
and parameters line up by name. The math is the JAX package's: fp32
moments whatever the param type (``torch.optim.AdamW`` would keep bf16
moments for bf16 params), bias correction from an int32 count, weight decay
added to the step, the result cast back to the param's type. Unlike JAX,
``adamw_update`` writes the new values into the parameters in place, so a
full-width model does not hold two copies of its weights or moments.
Adafactor comes later (ROADMAP queue 1, its Adafactor item).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """fp32 sqrt of the sum of squares over every leaf."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    # the scale in each gradient's own dtype, as in JAX (no fp32 copy of the tree)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def adamw_init(params: Tree) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    count_device = next(iter(params.values())).device
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=count_device)}


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree, *, lr,
                 beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step; returns (params, state). The params are updated in
    place and the moments replaced leaf by leaf in ``state``'s own dicts, so
    each old moment is freed as soon as its new one exists."""
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - beta1 ** c
    bc2 = 1.0 - beta2 ** c
    mu, nu = state["mu"], state["nu"]
    for k, p in params.items():
        g = grads[k].float()
        m = beta1 * mu[k] + (1 - beta1) * g
        v = beta2 * nu[k] + (1 - beta2) * g.square()
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        mu[k], nu[k] = m, v
    return params, {"mu": mu, "nu": nu, "count": count}


def _adafactor(*args, **kwargs):
    raise NotImplementedError("adafactor is not ported yet: ROADMAP queue 1, "
                              "the Adafactor item (the optimizer of deepseek-v3-671b)")


def opt_init(name: str):
    return {"adamw": adamw_init, "adafactor": _adafactor}[name]


def opt_update(name: str):
    return {"adamw": adamw_update, "adafactor": _adafactor}[name]
