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

Under a device mesh the parameters, gradients and moments are ``DTensor``s
(``training/train.py::place_train_state``). The global norm then sums each
leaf's local squares, divided by the number of ranks that hold the same
shard, in one all-reduce; AdamW updates each leaf on the local shards of
its moments' placement (the gradient reduce-scattered to it, the new
parameter gathered back where the parameter is placed otherwise, as under
``dp_zero1``), since the update is elementwise; Adafactor, whose factored
moments and RMS clip reduce over whole leaves, runs on the DTensors.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import torch

from repro_torch.sharding.ctx import is_dtensor

Tree = Dict[str, torch.Tensor]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """fp32 sqrt of the sum of squares over every leaf."""
    leaves = list(leaves)
    if not any(is_dtensor(x) for x in leaves):
        return torch.sqrt(sum(x.float().square().sum() for x in leaves))
    import torch.distributed as dist
    total = None
    for x in leaves:
        copies = 1                                  # ranks holding this shard
        for size, pl in zip(x.device_mesh.mesh.shape, x.placements):
            copies *= 1 if pl.is_shard() else int(size)
        part = x.to_local().float().square().sum() / copies
        total = part if total is None else total + part
    dist.all_reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    # the scale in each gradient's own dtype, as in JAX (no fp32 copy of the tree)
    return {k: _scaled(g, scale) for k, g in grads.items()}, norm


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if not is_dtensor(g):
        return g * scale.to(g.dtype)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(g.to_local() * scale.to(g.dtype), g.device_mesh,
                              g.placements, run_check=False)


def adamw_init(params: Tree) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=_local(p).device)
    count_device = _local(next(iter(params.values()))).device
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
        if is_dtensor(p):
            mu[k], nu[k] = _adamw_sharded(p, grads[k], mu[k], nu[k], lr, beta1, beta2,
                                          bc1, bc2, eps, weight_decay)
            continue
        g = grads[k].float()
        m = beta1 * mu[k] + (1 - beta1) * g
        v = beta2 * nu[k] + (1 - beta2) * g.square()
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        mu[k], nu[k] = m, v
    return params, {"mu": mu, "nu": nu, "count": count}


def _adamw_sharded(p, g, mu, nu, lr, beta1, beta2, bc1, bc2, eps, weight_decay):
    """AdamW on the local shards of the moments' placement; returns the new
    moments. The parameter's new value is gathered back to its own
    placement where that differs (ZeRO-1)."""
    from torch.distributed.tensor import DTensor
    mesh, mpl = mu.device_mesh, mu.placements
    g = g.redistribute(mesh, mpl).to_local().float()
    pl = p.redistribute(mesh, mpl).to_local()
    m = beta1 * mu.to_local() + (1 - beta1) * g
    v = beta2 * nu.to_local() + (1 - beta2) * g.square()
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    step = step + weight_decay * pl.float()
    new = (pl.float() - lr * step).to(pl.dtype)
    if tuple(mpl) != tuple(p.placements):
        new = DTensor.from_local(new, mesh, mpl, run_check=False).redistribute(
            mesh, p.placements).to_local()
    p.to_local().copy_(new)
    return (DTensor.from_local(m, mesh, mpl, run_check=False),
            DTensor.from_local(v, mesh, mpl, run_check=False))


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
        g = _stack(grads, names, axes).float()
        g2 = g.square() + eps
        if _factored(g.shape):
            vr = beta2 * vr_s[path] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * vc_s[path] + (1 - beta2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            vr_s[path], vc_s[path] = vr, vc
        else:
            vhat = v_s[path] = beta2 * v_s[path] + (1 - beta2) * g2
        # each full-size buffer released once it is spent, so that a leaf's
        # update holds no more than four of them at a time
        del g2
        u = g * torch.rsqrt(vhat + eps)
        del g, vhat
        rms = torch.sqrt(u.square().mean() + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p = _stack(params, names, axes)
        if weight_decay:
            u = u + weight_decay * p.float()
        new = (p.float() - lr * u).to(p.dtype).reshape((len(names),) + tuple(
            params[names[0]].shape))
        if is_dtensor(new):                 # each layer back to its own placement
            from torch.distributed.tensor import Replicate
            new = new.redistribute(new.device_mesh, [
                Replicate() if q.is_shard(0) else q for q in new.placements])
            for name, t in zip(names, new):
                dst = params[name]
                dst.to_local().copy_(t.redistribute(dst.device_mesh, dst.placements).to_local())
            continue
        for name, t in zip(names, new):
            params[name].copy_(t)
    return params, {**{m: state[m] for m in PATH_KEYED}, "count": count}


def opt_init(name: str):
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name]


def opt_update(name: str):
    return {"adamw": adamw_update, "adafactor": adafactor_update}[name]
