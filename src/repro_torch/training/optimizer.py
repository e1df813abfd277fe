"""Optimizers of the port: AdamW (fp32 moments), Adafactor (factored
second moment) and global-norm clipping.

Port of ``repro/training/optimizer.py``. A tree is a dict from the port's
parameter names (``named_parameters()``) to tensors, so gradients, moments
and parameters line up by name. The math is the JAX package's: fp32
moments whatever the param type (``torch.optim.AdamW`` would keep bf16
moments for bf16 params), bias correction from an int32 count, weight decay
added to the step, the result cast back to the param's type. Unlike JAX,
the updates write the new values into the parameters in place, so a
full-width model does not hold two copies of its weights or moments.

Adafactor (Shazeer & Stern 2018, simplified as in JAX: no momentum) is
defined on the JAX package's leaves, whose layers are stacked on leading
axes: a leaf is factored when its last two axes both exceed 1 (so a
stacked (layers, D) norm scale is factored over the layer axis) and the
update's RMS clip runs over the whole stacked leaf. The port keeps one
tensor per layer, so its Adafactor stacks each JAX path's layers for the
update (``jax_key``) and keys its ``vr``/``vc``/``v`` (fp32) by JAX path,
in the JAX layout.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

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


# Adafactor's moments are keyed by JAX path, in the stacked layout.
PATH_KEYED = ("vr", "vc", "v")


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def stacked_groups(names: Iterable[str]) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
    """(JAX path, its stacked layer axes, the port names in row-major order)
    of each leaf of the JAX tree."""
    from repro_torch.bridge import jax_key
    groups: Dict[str, list] = {}
    for name in names:
        path, idx = jax_key(name)
        groups.setdefault(path, []).append((idx, name))
    out = []
    for path, items in groups.items():
        items.sort()
        axes = tuple(max(ix) + 1 for ix in zip(*(ix for ix, _ in items)))
        out.append((path, axes, [name for _, name in items]))
    return out


def _stack(tree: Tree, names: List[str], axes: Tuple[int, ...]) -> torch.Tensor:
    if not axes:
        return tree[names[0]]
    t = torch.stack([tree[n] for n in names])
    return t.reshape(axes + tuple(t.shape[1:]))


def adafactor_init(params: Tree) -> Dict[str, Any]:
    def zeros(shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    state: Dict[str, Any] = {m: {} for m in PATH_KEYED}
    for path, axes, names in stacked_groups(params):
        p = params[names[0]]
        shape = axes + tuple(p.shape)
        fac = _factored(shape)
        state["vr"][path] = zeros(shape[:-1] if fac else (1,), p.device)
        state["vc"][path] = zeros(shape[:-2] + shape[-1:] if fac else (1,), p.device)
        state["v"][path] = zeros((1,) if fac else shape, p.device)
    state["count"] = torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device)
    return state


@torch.no_grad()
def adafactor_update(grads: Tree, state: Dict[str, Any], params: Tree, *, lr,
                     eps=1e-30, clip_threshold=1.0, weight_decay=0.0, beta2_cap=0.999):
    """One Adafactor step on each JAX leaf (its layers stacked); returns
    (params, state). The params are updated in place, the moments replaced
    in ``state``'s own dicts."""
    count = state["count"] + 1
    beta2 = torch.clamp(1.0 - count.float() ** -0.8, max=beta2_cap)
    vr_s, vc_s, v_s = (state[m] for m in PATH_KEYED)
    for path, axes, names in stacked_groups(params):
        p = _stack(params, names, axes)
        g = _stack(grads, names, axes).float()
        g2 = g.square() + eps
        if _factored(p.shape):
            vr = beta2 * vr_s[path] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * vc_s[path] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            u = g * torch.rsqrt(vhat + eps)
            vr_s[path], vc_s[path] = vr, vc
        else:
            v = beta2 * v_s[path] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + eps)
            v_s[path] = v
        rms = torch.sqrt(u.square().mean() + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.float()
        new = (p.float() - lr * u).to(p.dtype).reshape((len(names),) + tuple(
            params[names[0]].shape))
        for name, t in zip(names, new):
            params[name].copy_(t)
    return params, {**{m: state[m] for m in PATH_KEYED}, "count": count}


def opt_init(name: str):
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name]


def opt_update(name: str):
    return {"adamw": adamw_update, "adafactor": adafactor_update}[name]
