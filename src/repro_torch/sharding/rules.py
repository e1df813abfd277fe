"""Path-based logical-axis assignment for parameter / cache / batch trees.

Port of ``repro/sharding/rules.py``: the same rule sets and tables. A tree
here is a flat dict from a JAX path (``"/"``-joined, as
``bridge.jax_key`` and the checkpoints name leaves; optimizer slots as
``mu/<path>``) to a tensor or a shape; the spec functions return a dict of
specs on the same keys, each entry by entry JAX's ``PartitionSpec``
(``ctx.to_placements`` turns one into DTensor placements, where JAX's
``to_named`` makes a ``NamedSharding``). The
stacked layer axes of the JAX tree are part of the shapes, so a dim lines
up with JAX's: ``stacked_shapes`` gives them for the port's parameters and
moments, and ``port_placements`` the placements of each port tensor (one
layer of the stack).

Rule sets:
  DEFAULT_RULES      TP/EP over ``model``, DP over ``pod``+``data``; params
                     replicated over ``data`` (small/medium archs).
  FSDP_RULES         additionally shards the d_model/lora dims of weights
                     over ``data`` (ZeRO-3-style), for the >=7B archs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.sharding.ctx import logical_to_spec, to_placements

DEFAULT_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),
    "seq_q": "model",          # blockwise-attention query rows
    "kv_seq": "model",         # split-KV decode fallback
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "lora": None,
    "embed": None,
    "tp": "model",
}

FSDP_RULES = dict(DEFAULT_RULES, embed="data", lora="data")

# ---- beyond-paper parallelism strategies (§Perf hillclimb) ----------------
# pure data parallelism over every mesh axis; params replicated, optimizer
# state ZeRO-1 sharded — optimal for small models where TP psums dominate
DP_ZERO1_RULES: Dict[str, object] = {
    "batch": ("pod", "data", "model"),
    "zero1": ("data", "model"),
    "seq_q": None, "kv_seq": ("data", "model"),
    "heads": None, "kv_heads": None, "mlp": None, "vocab": None,
    "expert": None, "ssm_inner": None, "ssm_heads": None,
    "lora": None, "embed": None, "tp": None,
}

# pure FSDP / ZeRO-3: batch over all axes, every weight's leading non-stack
# dim sharded over all axes (bf16 all-gather per use instead of f32
# activation all-reduces)
PURE_FSDP_RULES: Dict[str, object] = dict(
    DP_ZERO1_RULES, fsdp2=("data", "model"))

# archs whose params + optimizer state exceed v5e HBM when only TP-sharded
FSDP_ARCHS = {"deepseek-v3-671b", "mistral-nemo-12b", "granite-3-8b",
              "starcoder2-7b"}


# ---------------------------------------------------------------------------
# parameter logical axes
# ---------------------------------------------------------------------------

_PARAM_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    "table": ("vocab", "embed"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "wq_a": ("embed", "lora"),
    "wq_b": ("lora", "heads"),
    "wkv_a": ("embed", "lora"),
    "wkv_b": ("lora", "heads"),
    "router": ("embed", "expert"),
    "in_z": ("embed", "ssm_inner"),
    "in_x": ("embed", "ssm_inner"),
    "in_B": ("embed", None),
    "in_C": ("embed", None),
    "in_dt": ("embed", "ssm_heads"),
    "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",),
    "D_skip": ("ssm_heads",),
    "conv_x": (None, "ssm_inner"),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "out": ("ssm_inner", "embed"),
    "proj": ("embed", "tp"),
}


def _path_names(path) -> Tuple[str, ...]:
    return tuple(path.split("/")) if isinstance(path, str) else tuple(path)


def param_logical_axes(path, shape) -> Tuple[Optional[str], ...]:
    names = _path_names(path)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""

    if name == "w" and parent == "lm_head":
        base: Tuple[Optional[str], ...] = ("embed", "vocab")
    elif name in ("scale", "bias"):
        base = ("ssm_inner",) if parent == "gate_norm" else (None,)
    elif name in ("gate", "up") and parent == "experts":
        base = ("expert", "embed", "mlp")
    elif name == "down" and parent == "experts":
        base = ("expert", "mlp", "embed")
    elif name in ("gate", "up"):
        base = ("embed", "mlp")
    elif name == "down":
        base = ("mlp", "embed")
    elif name in _PARAM_TABLE:
        base = _PARAM_TABLE[name]
    else:
        base = (None,) * len(shape)

    if len(base) > len(shape):          # e.g. 1D leaf matched 2D base
        base = base[-len(shape):]
    pad = len(shape) - len(base)        # leading layer/group stack dims
    return (None,) * pad + tuple(base)


# ---------------------------------------------------------------------------
# cache logical axes (decode-state trees)
# ---------------------------------------------------------------------------

_CACHE_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "kv_heads", "kv_seq", None),
    "v": ("batch", "kv_heads", "kv_seq", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "state": ("batch", "ssm_heads", None, None),
    "conv_x": ("batch", None, "ssm_inner"),
    "conv_B": ("batch", None, None),
    "conv_C": ("batch", None, None),
}


def cache_logical_axes(path, shape) -> Tuple[Optional[str], ...]:
    names = _path_names(path)
    name = names[-1] if names else ""
    base = _CACHE_TABLE.get(name, (None,) * len(shape))
    if len(base) > len(shape):
        base = base[-len(shape):]
    pad = len(shape) - len(base)
    return (None,) * pad + tuple(base)


# ---------------------------------------------------------------------------
# batch logical axes
# ---------------------------------------------------------------------------

_BATCH_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", None),
    "targets": ("batch", None),
    "token": ("batch", None),
    "patches": ("batch", None, None),
    "frames": ("batch", None, None),
    "index": (),
}


def batch_logical_axes(path, shape) -> Tuple[Optional[str], ...]:
    names = _path_names(path)
    name = names[-1] if names else ""
    base = _BATCH_TABLE.get(name, (None,) * len(shape))
    return tuple(base)[: len(shape)] + (None,) * max(0, len(shape) - len(base))


# ---------------------------------------------------------------------------
# tree -> spec tree
# ---------------------------------------------------------------------------

def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def _specs(tree, axes_fn, mesh, rules):
    out = {}
    for path, leaf in tree.items():
        shape = _shape(leaf)
        out[path] = logical_to_spec(axes_fn(path, shape), shape, mesh, rules)
    return out


def _head_aware(axes_fn, cfg, mesh):
    """Attention-weight fallback when head counts don't divide TP: shard
    those weights on the CONTRACTING dim ("tp" = row-parallel) instead of
    the fused (H*hd) dim, whose later (B,S,H,hd) reshape would cut across
    shard boundaries."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh) if mesh is not None else {}
    if cfg is None or "model" not in sizes:
        return axes_fn
    tp = sizes["model"]
    q_bad = cfg.num_heads and cfg.num_heads % tp != 0
    kv_bad = cfg.num_kv_heads and cfg.num_kv_heads % tp != 0

    def fn(path, shape):
        axes = axes_fn(path, shape)
        names = _path_names(path)
        name = names[-1] if names else ""
        if name in ("wq", "wo") and q_bad and cfg.attention != "mla":
            pad = len(shape) - 2
            return (None,) * pad + ("tp", None)
        if name in ("wk", "wv") and kv_bad:
            pad = len(shape) - 2
            return (None,) * pad + ("tp", None)
        return axes
    return fn


def _largest_dim_axes(name_for_dim: str):
    """Strategy wrapper: shard each leaf's LARGEST dim (most likely to be
    256-divisible and memory-dominant) over the strategy axes."""
    def fn(path, shape):
        if len(shape) == 0:
            return ()
        i = max(range(len(shape)), key=lambda j: shape[j])
        return tuple(name_for_dim if j == i else None
                     for j in range(len(shape)))
    return fn


def param_specs(tree, mesh=None, rules=None, cfg=None,
                strategy: str = "baseline"):
    if strategy == "pure_fsdp":
        return _specs(tree, _largest_dim_axes("fsdp2"), mesh, rules)
    if strategy == "dp_zero1":
        return _specs(tree, lambda p, s: (None,) * len(s), mesh, rules)
    return _specs(tree, _head_aware(param_logical_axes, cfg, mesh), mesh, rules)


def cache_specs(tree, mesh=None, rules=None):
    return _specs(tree, cache_logical_axes, mesh, rules)


def batch_specs(tree, mesh=None, rules=None):
    return _specs(tree, batch_logical_axes, mesh, rules)


OPT_SLOTS = ("mu", "nu", "v", "vr", "vc", "err")


def opt_state_specs(opt_shapes, mesh=None, rules=None, cfg=None,
                    strategy: str = "baseline"):
    """Optimizer-state tree: moments reuse the param axes of their subpath;
    Adafactor factored rows/cols drop the reduced dim's axis. Under
    dp_zero1, moments shard their largest dim over the 'zero1' axes."""
    if strategy == "pure_fsdp":
        base_axes = _largest_dim_axes("fsdp2")
    elif strategy == "dp_zero1":
        base_axes = _largest_dim_axes("zero1")
    else:
        base_axes = _head_aware(param_logical_axes, cfg, mesh)

    def axes_fn(path, shape):
        names = _path_names(path)
        # find the optimizer-slot marker and strip everything up to it
        for i, n in enumerate(names):
            if n in OPT_SLOTS:
                slot, sub = n, names[i + 1:]
                break
        else:
            return (None,) * len(shape)
        if slot in ("mu", "nu", "v", "err"):
            return base_axes(sub, shape)
        # factored: vr drops last dim, vc drops second-to-last
        if slot == "vr":
            return base_axes(sub, tuple(shape) + (1,))[:-1]
        full = base_axes(sub, tuple(shape[:-1]) + (1, shape[-1]))
        return full[:-2] + (full[-1],)
    return _specs(opt_shapes, axes_fn, mesh, rules)


# ---------------------------------------------------------------------------
# the port's tensors
# ---------------------------------------------------------------------------

def stacked_shapes(named) -> Dict[str, Tuple[int, ...]]:
    """(port name, tensor) pairs -> {JAX path: stacked shape}: each layer
    list's leading axes in front of its tensors' shape, as the JAX tree
    holds them."""
    from repro_torch.bridge import jax_key
    out: Dict[str, Tuple[int, ...]] = {}
    stack: Dict[str, list] = {}
    for name, t in named:
        path, idx = jax_key(name)
        out[path] = tuple(t.shape)
        stack.setdefault(path, []).append(idx)
    for path, idxs in stack.items():
        axes = tuple(max(ix) + 1 for ix in zip(*idxs)) if idxs[0] else ()
        out[path] = axes + out[path]
    return out


def port_placements(named, specs, mesh, prefix: str = "") -> Dict[str, list]:
    """{port name: placements} of each port tensor from the specs of its
    stacked JAX leaf (keyed ``prefix + path``): a tensor is one layer of the
    stack, so the stack dims' entries drop, and an axis that sharded a stack
    dim replicates the layer's tensor."""
    from repro_torch.bridge import jax_key
    out = {}
    for name, _ in named:
        path, idx = jax_key(name)
        spec = specs[prefix + path]
        out[name] = to_placements(tuple(spec[len(idx):]) if len(spec) > len(idx)
                                  else (), mesh)
    return out


def rules_for(arch_name: str, strategy: str = "baseline") -> Dict[str, object]:
    if strategy == "dp_zero1":
        return DP_ZERO1_RULES
    if strategy == "pure_fsdp":
        return PURE_FSDP_RULES
    if strategy in ("baseline", "moe_a2a", "moe_a2a_seqshard", "moe_rs"):
        return FSDP_RULES if arch_name in FSDP_ARCHS else DEFAULT_RULES
    raise ValueError(strategy)
