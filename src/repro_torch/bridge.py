"""Weight bridge between the JAX package's parameter tree and the port's.

``params_from_jax`` takes the JAX tree as numpy arrays (``jax.tree.map(
np.asarray, params)``) and returns the port's parameter module;
``params_to_numpy`` gives the reverse, in the JAX layout. Leaves are keyed
by ``/``-joined paths, the convention of the JAX package's checkpoints
(``training/checkpoint.py::_path_str``). The JAX tree stacks the layers on
a leading axis; the port keeps one module per layer, so ``layers/*`` leaves
are unstacked and restacked. bfloat16 leaves pass through float32, which is
exact, because ``torch.from_numpy`` rejects numpy's bfloat16 extension type.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import device as dev


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/lists -> {"a/b/0/c": leaf}."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_torch(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))   # JAX's views are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def _module(tree) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _insert(tree: dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def params_from_jax(np_tree, cfg, device: dev.DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> nn.ModuleDict:
    """JAX parameter tree (numpy leaves) -> the port's parameter module.

    ``dtype=None`` keeps each leaf's type (bfloat16 stays bfloat16).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d = dev.resolve(device)
    top: dict = {}
    layers = [dict() for _ in range(cfg.num_layers)]
    for path, leaf in flatten(np_tree).items():
        parts = path.split("/")
        t = _to_torch(leaf, d, dtype)
        if parts[0] == "layers":
            if t.shape[0] != cfg.num_layers:
                raise ValueError(f"{path}: {t.shape[0]} stacked layers, "
                                 f"config has {cfg.num_layers}")
            for i in range(cfg.num_layers):
                _insert(layers[i], parts[1:], t[i].clone())
        else:
            _insert(top, parts, t)
    table = top["embed"]["table"]
    if tuple(table.shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embed/table {tuple(table.shape)} does not fit the "
                         f"config's ({cfg.padded_vocab}, {cfg.d_model})")
    params = _module(top)
    params["layers"] = nn.ModuleList([_module(lp) for lp in layers])
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(params: nn.Module) -> Dict[str, Any]:
    """The port's parameters -> the JAX tree layout, with numpy leaves.

    bfloat16 tensors come back as float32 arrays holding the same values.
    """
    out: Dict[str, Any] = {}
    stacked: Dict[str, list] = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":          # layers.<i>.<path>; i ascends
            stacked.setdefault("/".join(parts[2:]), []).append(_to_numpy(p))
        else:
            _insert(out, parts, _to_numpy(p))
    for path, per_layer in stacked.items():
        _insert(out, ["layers"] + path.split("/"), np.stack(per_layer))
    return out
