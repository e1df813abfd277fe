"""Weight bridge between the JAX package's parameter tree and the port's.

``params_from_jax`` takes the JAX tree as numpy arrays (``jax.tree.map(
np.asarray, params)``) and returns the port's parameter module;
``params_to_numpy`` gives the reverse, in the JAX layout. Leaves are keyed
by ``/``-joined paths, the convention of the JAX package's checkpoints
(``training/checkpoint.py::_path_str``). The JAX tree stacks the layers on
leading axes; the port keeps one module per layer, so stacked leaves are
unstacked and restacked: ``layers/*`` (dense, vlm, ssm, moe),
``dense_layers/*`` (moe), ``leftover/*`` (hybrid), ``enc_layers/*`` and
``dec_layers/*`` (encdec) on one axis, hybrid's ``groups/*`` on two (group,
layer in group). A moe layer's ``moe/experts/*`` keeps its expert axis
inside the leaf. ``shared/*``, ``enc_norm/*``, ``mtp/*`` and the other
leaves pass as they are. bfloat16 leaves pass
through float32, which is exact, because ``torch.from_numpy`` rejects
numpy's bfloat16 extension type.

Train states: ``state_from_jax`` takes the JAX ``init_train_state`` tree
(``params``, the optimizer's moments: AdamW's ``opt/mu`` and ``opt/nu`` or
Adafactor's ``opt/vr``, ``opt/vc`` and ``opt/v``; ``opt/count``, ``step``)
as numpy and returns the port's (``training/train.py``), its params
requiring grad and its moments keyed by parameter name; ``state_to_numpy``
gives the reverse.
``state_to_flat`` and ``load_flat`` serve the checkpoints: ``{JAX path:
CPU tensor}`` in the stacked layout with each dtype kept, and back into a
state in place.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as dev
from repro_torch.models.ssm import FP32_PARAMS as _SSM_FP32
from repro_torch.models.transformer import hybrid_split
from repro_torch.training.optimizer import PATH_KEYED

# Leaves that stay float32 under any param type: the ssm blocks' and the
# moe router (kept fp32, as in JAX).
FP32_PARAMS = _SSM_FP32 + ("router",)


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
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype or a.dtype, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))   # JAX's views are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def _module(tree) -> nn.Module:
    """A dict holding tensors becomes a ParameterDict (its sub-dicts nested in
    it, as ``ssm/gate_norm``), a dict of dicts a ModuleDict."""
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False) if isinstance(v, torch.Tensor)
            else _module(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _stacks(cfg) -> Dict[str, Tuple[int, ...]]:
    """The stacked subtrees of the JAX tree and their leading axes."""
    if cfg.family in ("dense", "vlm", "ssm"):
        return {"layers": (cfg.num_layers,)}
    if cfg.family == "moe":
        out = {"layers": (cfg.num_layers - cfg.first_k_dense,)}
        if cfg.first_k_dense:
            out["dense_layers"] = (cfg.first_k_dense,)
        return out
    if cfg.family == "encdec":
        return {"enc_layers": (cfg.num_enc_layers,), "dec_layers": (cfg.num_layers,)}
    if cfg.family == "hybrid":
        n_groups, leftover = hybrid_split(cfg)
        out = {"groups": (n_groups, cfg.shared_attn_interval)}
        if leftover:
            out["leftover"] = (leftover,)
        return out
    raise ValueError(f"unknown family {cfg.family!r}")


def _module_list(per_index: Dict[tuple, dict], shape: Tuple[int, ...]) -> nn.ModuleList:
    """{(i, j, ...): layer tree} -> nested ModuleLists, one level per axis."""
    if len(shape) == 1:
        return nn.ModuleList([_module(per_index[(i,)]) for i in range(shape[0])])
    return nn.ModuleList([
        _module_list({k[1:]: v for k, v in per_index.items() if k[0] == i}, shape[1:])
        for i in range(shape[0])])


def _insert(tree: dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def params_from_jax(np_tree, cfg, device: dev.DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> nn.ModuleDict:
    """JAX parameter tree (numpy leaves) -> the port's parameter module.

    ``dtype=None`` keeps each leaf's type (bfloat16 stays bfloat16). A
    ``dtype`` plays the part of the param type: it casts every leaf but the
    ``FP32_PARAMS``, which stay float32 under any param type.
    """
    stacks = _stacks(cfg)
    d = dev.resolve(device)
    top: dict = {}
    layers = {name: {idx: {} for idx in itertools.product(*map(range, shape))}
              for name, shape in stacks.items()}
    for path, leaf in flatten(np_tree).items():
        parts = path.split("/")
        t = _to_torch(leaf, d, None if parts[-1] in FP32_PARAMS else dtype)
        if parts[0] in stacks:
            shape = stacks[parts[0]]
            if tuple(t.shape[:len(shape)]) != shape:
                raise ValueError(f"{path}: {tuple(t.shape[:len(shape)])} stacked "
                                 f"layers, config has {shape}")
            for idx, tree in layers[parts[0]].items():
                _insert(tree, parts[1:], t[idx].clone())
        else:
            _insert(top, parts, t)
    # a stack of no layers (a moe cut of first_k_dense layers only) is empty
    # in the JAX tree too: its leaves have a leading axis of 0
    missing = [name for name, trees in layers.items()
               if trees and not trees[(0,) * len(stacks[name])]]
    if missing:
        raise ValueError(f"the config stacks {missing}, the JAX tree has none")
    table = top["embed"]["table"]
    if tuple(table.shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embed/table {tuple(table.shape)} does not fit the "
                         f"config's ({cfg.padded_vocab}, {cfg.d_model})")
    params = _module(top)
    for name, shape in stacks.items():
        params[name] = _module_list(layers[name], shape)
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_key(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> (its JAX path, its index on the stacked
    axes): ``layers.3.attn.wq`` -> (``layers/attn/wq``, (3,))."""
    parts = name.split(".")
    depth = 1
    while depth < len(parts) and parts[depth].isdigit():
        depth += 1
    if depth == 1:
        return "/".join(parts), ()
    return ("/".join([parts[0]] + parts[depth:]),
            tuple(int(i) for i in parts[1:depth]))


def _stacked(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """(port name, tensor) pairs -> {JAX path: CPU tensor}, the layer lists
    restacked on as many leading axes as they are nested deep, dtype kept."""
    out: Dict[str, torch.Tensor] = {}
    stacked: Dict[str, Dict[tuple, torch.Tensor]] = {}
    for name, t in named:
        path, idx = jax_key(name)
        t = _full(t).detach().to("cpu", copy=True)
        if idx:
            stacked.setdefault(path, {})[idx] = t
        else:
            out[path] = t
    for path, per_index in stacked.items():
        shape = tuple(max(ix) + 1 for ix in zip(*per_index))
        t = torch.stack([per_index[ix] for ix in itertools.product(*map(range, shape))])
        out[path] = t.reshape(shape + tuple(t.shape[1:]))
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> nested dicts, the inverse of ``flatten``."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        _insert(out, path.split("/"), leaf)
    return out


def params_to_numpy(params: nn.Module) -> Dict[str, Any]:
    """The port's parameters -> the JAX tree layout, with numpy leaves.

    Layer lists are restacked on as many leading axes as they are nested
    deep. bfloat16 tensors come back as float32 arrays holding the same values.
    """
    return unflatten({k: _to_numpy(t)
                      for k, t in _stacked(params.named_parameters()).items()})


def _moments(opt: Dict[str, Any]):
    """(name, tree) of an optimizer state's moments: every entry but the
    count (AdamW's mu, nu; Adafactor's vr, vc, v)."""
    return [(m, tree) for m, tree in opt.items() if m != "count"]


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective: every rank calls it)."""
    from repro_torch.sharding.ctx import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def state_to_flat(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A port train state -> {JAX path: CPU tensor} in the JAX tree's stacked
    layout, each leaf copied and its dtype kept. A state placed on a mesh
    (DTensors) is gathered, so every rank must call it."""
    flat = {f"params/{k}": t
            for k, t in _stacked(state["params"].named_parameters()).items()}
    for moment, tree in _moments(state["opt"]):
        if moment in PATH_KEYED:        # Adafactor's: already by JAX path
            flat.update({f"opt/{moment}/{k}": _full(t).detach().to("cpu", copy=True)
                         for k, t in tree.items()})
        else:
            flat.update({f"opt/{moment}/{k}": t for k, t in _stacked(tree.items()).items()})
    flat["opt/count"] = state["opt"]["count"].detach().to("cpu", copy=True)
    flat["step"] = state["step"].detach().to("cpu", copy=True)
    return flat


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """A port train state -> the JAX train-state tree with numpy leaves
    (bfloat16 as float32 holding the same values)."""
    return unflatten({k: _to_numpy(t) for k, t in state_to_flat(state).items()})


def state_from_jax(np_state, cfg, device: dev.DeviceLike = "cuda",
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX train-state tree (numpy or torch leaves) -> the port's train
    state on ``device``: params as ``params_from_jax`` makes them (``dtype``
    as there), requiring grad; fp32 moments, AdamW's keyed by parameter
    name, Adafactor's by JAX path; int32 count and step."""
    d = dev.resolve(device)
    params = params_from_jax(np_state["params"], cfg, d, dtype)
    params.requires_grad_(True)
    opt = {}
    for m, tree in _moments(np_state["opt"]):
        if m in PATH_KEYED:
            opt[m] = {k: _to_torch(v, d, torch.float32) for k, v in flatten(tree).items()}
        else:
            opt[m] = {k: p.detach() for k, p in
                      params_from_jax(tree, cfg, d).named_parameters()}
    opt["count"] = _to_torch(np_state["opt"]["count"], d, torch.int32)
    return {"params": params, "opt": opt,
            "step": _to_torch(np_state["step"], d, torch.int32)}


@torch.no_grad()
def load_flat(state: Dict[str, Any], flat: Dict[str, Any]) -> Dict[str, Any]:
    """Copies {JAX path: leaf} (the stacked layout of ``state_to_flat``) into
    ``state``'s tensors in place; returns ``state``. A DTensor takes its
    local block, so a state placed on any mesh restores."""
    from repro_torch.sharding.ctx import is_dtensor, local_slices

    def put(dst: torch.Tensor, key: str, idx: tuple) -> None:
        if key not in flat:
            raise KeyError(f"{key} is not in the checkpoint")
        src = torch.as_tensor(flat[key])[idx] if idx else torch.as_tensor(flat[key])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}{list(idx)}: {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        if is_dtensor(dst):
            dst.to_local().copy_(src[local_slices(src.shape, dst.device_mesh,
                                                  dst.placements)])
        else:
            dst.copy_(src)

    for name, p in state["params"].named_parameters():
        path, idx = jax_key(name)
        put(p, f"params/{path}", idx)
    for moment, tree in _moments(state["opt"]):
        for name, t in tree.items():
            path, idx = (name, ()) if moment in PATH_KEYED else jax_key(name)
            put(t, f"opt/{moment}/{path}", idx)
    put(state["opt"]["count"], "opt/count", ())
    put(state["step"], "step", ())
    return state
