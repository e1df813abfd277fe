"""Mixture-of-Experts, the local (one-device) path.

Port of ``repro/models/moe.py``: ``init_moe``, ``_route``, ``_capacity``,
``_expert_compute_local`` and ``apply_moe`` with its expert-parallel paths.
Without a mesh ``apply_moe`` runs the local path (``moe.py:228-231``). Under
a mesh (the activations ``DTensor``s) it runs, as JAX's ``shard_map``s do,
explicit SPMD on local shards with ``sharding.collectives``:

- EP over ``model`` (``_apply_moe_ep``, ``moe.py:236-288``): tokens sharded
  over the batch axes and replicated over ``model``; each rank computes its
  E/tp experts (``e0`` its ``model`` coordinate times ``e_local``) over its
  local tokens, with the capacity from the LOCAL token count, as in JAX,
  and the partial outputs are summed over ``model`` (``psum``), or under
  ``moe_rs`` reduce-scattered, cast to bf16 and all-gathered. deepseek's
  expert weights, d_model-sharded over ``data``, are all-gathered first.
- all-to-all dispatch (``_apply_moe_a2a``, ``moe.py:114-209``) under
  ``moe_a2a``/``moe_a2a_seqshard`` where B*S divides tp * dp: each
  ``model`` rank slices its rows locally, sends fixed-capacity buckets to
  the expert owners, computes, sends back, scatter-adds, and the rows are
  gathered over ``model``.
- EP off (a tp of 1, E not divisible, ``expert`` unmapped): the local path
  on every rank over all tokens (gathered), so the capacity and the dropped
  pairs are those of the global batch, as GSPMD computes it.

The routing runs on local tokens; its load-balance means are averaged over
the batch axes. Inputs replicated over an axis whose ranks each compute a
part declare a partial gradient there (``to_local(grad_placements=)``).

Dispatch is the reference's sort-based capacity buckets: the (token,
choice) pairs are sorted stably by expert (``torch.argsort(stable=True)``;
torch's default sort is not stable), ranked within their expert by
``searchsorted`` starts, and the pairs past ``cap`` dropped in that order;
the kept ones fill an (E, C, D) buffer whose expert products are batched
matrix products (E, C, D) x (E, D, F), outside any kernel, as in JAX.
Where JAX scatters (``.at[dest].set`` into the slots, ``.at[tok].add`` back
to the tokens), the port gathers in both directions with ``_GatherRows``,
an autograd Function whose backward is a gather too, over the inverse map,
summed over the k choices in a fixed order. So no ``index_add_``,
``scatter_add`` or accumulating ``index_put_`` runs: their atomics on the
card would make two runs of a train step differ in bits, and a content-keyed
cache would then never hit for the step's consumers.

The maps, for T tokens with k choices (N = T k pairs) over S = E cap slots:
``slot_flat`` (S,) names the pair in each slot, N for an empty one;
``inv`` (T, k) the slot of each pair, S for a dropped one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import enter_local
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding import ctx


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32) -> nn.ParameterDict:
    """The router (fp32, whatever the param type), the expert stacks
    (E, D, F)/(E, F, D), drawn an expert at a time in ``dtype`` (an fp32 copy
    of deepseek-v3's gate stack alone is 15 GB), and the shared expert."""
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def stack(n_in, n_out):
        w = torch.empty((E, n_in, n_out), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = L.dense_init(gen, n_in, n_out, dtype)
        return L._param(w)

    p = nn.ParameterDict({
        "router": L._param(L.dense_init(gen, D, E, torch.float32)),
        "experts": nn.ParameterDict({"gate": stack(D, Fd), "up": stack(D, Fd),
                                     "down": stack(Fd, D)}),
    })
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, D, Fd * cfg.num_shared_experts, "swiglu", dtype)
    return p


def _route(p, cfg, x: torch.Tensor, mean_over=None):
    """Returns (weights (B,S,k) in x.dtype, idx (B,S,k), aux_loss fp32).
    ``mean_over(t)`` averages the load-balance means over the ranks that
    hold the other tokens (none: x holds them all)."""
    k, E = cfg.experts_per_token, cfg.num_experts
    logits = x.float() @ p["router"].float()                # (B,S,E)
    if cfg.router_type == "sigmoid":                        # deepseek-v3
        w, idx = torch.topk(torch.sigmoid(logits), k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    else:
        w, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    # switch-style load-balance aux loss: softmax probs, f from the top-1 choice
    probs = torch.softmax(logits, dim=-1)
    f = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    pbar = probs.mean(dim=(0, 1))
    if mean_over is not None:
        f, pbar = mean_over(f), mean_over(pbar)
    aux = E * (f * pbar).sum() * cfg.aux_loss_coef
    return w.to(x.dtype), idx, aux


def _capacity(tokens: int, k: int, num_experts: int, cf: float) -> int:
    c = int(tokens * k * cf / num_experts) + 1
    return max(8, ((c + 7) // 8) * 8)                      # 8-aligned slots


class _GatherRows(torch.autograd.Function):
    """out[m] = src[idx[m]], zero where idx[m] == len(src). Backward:
    d src[t] = sum_j g[inv[t, j]] over inv's last axis in order, g's row
    len(idx) standing for zero. ``inv`` must list, for each row t of src,
    every m with idx[m] == t (padded with len(idx)): the inverse map."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        ctx.rows = (idx.numel(),) + tuple(src.shape[1:])
        return _take(src, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _take(g.reshape(ctx.rows), inv).sum(dim=inv.dim() - 1), None, None


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] with rows past the end read as zero: (idx.shape, *row)."""
    n = src.shape[0]
    flat = idx.reshape(-1)
    out = src.index_select(0, flat.clamp(max=n - 1))
    out.masked_fill_((flat >= n).reshape((-1,) + (1,) * (src.dim() - 1)), 0)
    return out.reshape(tuple(idx.shape) + tuple(src.shape[1:]))


def dispatch_maps(idx2d: torch.Tensor, e0: int, e_local: int, cap: int):
    """(slot_flat (S,), inv (T, k)) of the reference's overflow order."""
    T, k = idx2d.shape
    N, S = T * k, e_local * cap
    flat_e = idx2d.reshape(N) - e0
    in_range = (flat_e >= 0) & (flat_e < e_local)
    sort_key = torch.where(in_range, flat_e, torch.full_like(flat_e, e_local))
    order = torch.argsort(sort_key, stable=True)
    se = sort_key[order]
    starts = torch.searchsorted(se, torch.arange(e_local, device=se.device,
                                                 dtype=se.dtype))
    pos = torch.arange(N, device=se.device) - starts[se.clamp(0, e_local - 1)]
    keep = (se < e_local) & (pos < cap)
    dest = torch.where(keep, se * cap + pos, torch.full_like(se, S))  # trash slot S
    # kept destinations are distinct, so these writes do not collide but in
    # the trash slot, which is dropped (any winner will do, as in JAX)
    slot_flat = torch.full((S + 1,), N, dtype=torch.long, device=se.device)
    slot_flat[dest] = order
    inv = torch.empty(N, dtype=torch.long, device=se.device)
    inv[order] = dest
    return slot_flat[:S], inv.reshape(T, k)


def _expert_compute_local(x2d, idx2d, w2d, gate, up, down, e0: int, e_local: int,
                          cap: int) -> torch.Tensor:
    """Sort-based dispatch on one device.

    x2d: (T, D); idx2d/w2d: (T, k); gate/up/down: (El, D, F)/(El, F, D).
    Returns (T, D), the output of experts [e0, e0+El).
    """
    T, D = x2d.shape
    k = idx2d.shape[1]
    N, S = T * k, e_local * cap
    slot_flat, inv = dispatch_maps(idx2d, e0, e_local, cap)
    slot_tok = torch.where(slot_flat < N, slot_flat // k, torch.full_like(slot_flat, T))
    xin = _GatherRows.apply(x2d, slot_tok, inv).reshape(e_local, cap, D)
    slot_w = _GatherRows.apply(w2d.reshape(N, 1), slot_flat, inv.reshape(N, 1))

    dt = torch.promote_types(xin.dtype, gate.dtype)
    xin = xin.to(dt)
    h = torch.bmm(xin, gate.to(dt))
    h = F.silu(h) * torch.bmm(xin, up.to(dt))
    out = torch.bmm(h, down.to(dt))                          # (El,C,D)

    out2 = out.reshape(S, D) * slot_w
    y = _GatherRows.apply(out2, inv, slot_flat.reshape(S, 1))   # (T,k,D)
    return y.sum(dim=1)


def apply_moe(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss). The capacity comes from this
    call's own token count, so decode (B tokens) and prefill (B S tokens)
    get different capacities, as in JAX."""
    if ctx.is_dtensor(x):
        return _apply_moe_mesh(p, cfg, x)
    B, S, D = x.shape
    w, idx, aux = _route(p, cfg, x)
    E, k = cfg.num_experts, cfg.experts_per_token
    x2d = x.reshape(B * S, D)
    ex = p["experts"]
    cap = _capacity(B * S, k, E, cfg.capacity_factor)
    y = _expert_compute_local(x2d, idx.reshape(B * S, k), w.reshape(B * S, k),
                              ex["gate"], ex["up"], ex["down"], 0, E, cap)
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], x2d, "swiglu")
    return y.reshape(B, S, D).to(x.dtype), aux


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def _pl(mesh, shards):
    """Placements: ``shards`` maps an axis name to the dim it shards (or to
    a placement); the other axes replicate."""
    from torch.distributed.tensor import Placement, Replicate, Shard
    out = []
    for a in mesh.mesh_dim_names:
        v = shards.get(a)
        out.append(Replicate() if v is None else v if isinstance(v, Placement)
                   else Shard(v))
    return out


def _apply_moe_mesh(p, cfg, x):
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.launch.mesh import axis_sizes
    rules = ctx.axis_ctx()[1]
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    tp = sizes.get("model", 1)
    exp_rule = rules.get("expert") if rules else None
    ep_on = exp_rule == "model" or (isinstance(exp_rule, tuple) and "model" in exp_rule)
    strategy = ctx.current_strategy()
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    batch_axes = [a for a in ("pod", "data") if a in sizes]

    if tp == 1 or E % tp != 0 or not ep_on:
        # the local path over every token, on every rank
        rep = _pl(mesh, {})
        (xl, rl, gl, ul, dl), out = enter_local(
            [(x, rep, None), (p["router"], rep, None)] +
            [(p["experts"][n], rep, None) for n in ("gate", "up", "down")], rep)
        w, idx, aux = _route({"router": rl}, cfg, xl)
        cap = _capacity(B * S, k, E, cfg.capacity_factor)
        y = _expert_compute_local(xl.reshape(B * S, D), idx.reshape(B * S, k),
                                  w.reshape(B * S, k), gl, ul, dl, 0, E, cap)
        y = out(y.reshape(B, S, D))
        aux = out(aux)
    else:
        # tokens over the batch axes, replicated over model; grads of what
        # model ranks share are partial there
        tok = _pl(mesh, {a: 0 for a in batch_axes})
        tok_g = _pl(mesh, {**{a: 0 for a in batch_axes}, "model": Partial()})
        fsdp = sizes.get("data", 1) > 1 and cfg.name.startswith("deepseek")
        wpl, wgr = {}, {}
        for n, d_axis in (("gate", 1), ("up", 1), ("down", 2)):
            sh = {"model": 0}
            if fsdp and D % sizes["data"] == 0:
                sh["data"] = d_axis
            wpl[n] = _pl(mesh, sh)
            # each data rank's tokens give a part of the gradient
            wgr[n] = _pl(mesh, {**sh, **{a: Partial() for a in batch_axes
                                          if a not in sh}})
        (xl, rl, gl, ul, dl), out = enter_local(
            [(x, tok, tok_g), (p["router"], _pl(mesh, {}),
                                _pl(mesh, {a: Partial() for a in sizes}))] +
            [(p["experts"][n], wpl[n], wgr[n]) for n in ("gate", "up", "down")], tok)
        if fsdp and D % sizes["data"] == 0:
            gl = C.all_gather(gl, mesh, "data", 1)
            ul = C.all_gather(ul, mesh, "data", 1)
            dl = C.all_gather(dl, mesh, "data", 2)
        def mean_over(t):
            for a in batch_axes:
                t = C.psum(t, mesh, a)
            return t / dp

        Bl = xl.shape[0]
        w, idx, aux_l = _route({"router": rl}, cfg, xl, mean_over)
        # every model rank routes the same tokens: the aux gradient, summed
        # over model with the experts' partial ones, must count once
        aux_l = _GradScale.apply(aux_l, 1.0 / tp)
        x2d = xl.reshape(Bl * S, D)
        idx2d, w2d = idx.reshape(Bl * S, k), w.reshape(Bl * S, k)
        if (strategy in ("moe_a2a", "moe_a2a_seqshard")
                and (B * S) % (tp * dp) == 0):
            # this rank's rows: (B S) sharded over the batch axes, then model
            rows = DTensor.from_local(
                _apply_moe_a2a(cfg, mesh, x2d, idx2d, w2d, gl, ul, dl), mesh,
                _pl(mesh, {a: 0 for a in batch_axes + ["model"]}), run_check=False)
            y = rows.redistribute(mesh, tok).reshape(B, S, D)
        else:
            y = _apply_moe_ep(cfg, mesh, x2d, idx2d, w2d, gl, ul, dl,
                              rs=strategy == "moe_rs" and (B * S) % (tp * dp) == 0)
            y = out(y.reshape(Bl, S, D))
        aux = DTensor.from_local(aux_l, mesh, _pl(mesh, {}), run_check=False)
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], x, "swiglu")
    return y.to(x.dtype), aux


class _GradScale(torch.autograd.Function):
    """Identity forward; the backward scales the cotangent by ``c``."""

    @staticmethod
    def forward(ctx_, t, c):
        ctx_.c = c
        return t.view_as(t)

    @staticmethod
    def backward(ctx_, dy):
        return dy * ctx_.c, None


class _ReduceScatterGatherBF16(torch.autograd.Function):
    """``moe_rs``'s sum over ``model``: reduce-scatter, the part cast to
    bf16, all-gather, back to the input's dtype. Its output is replicated
    over ``model``, so the backward passes the cotangent as ``psum``'s does,
    rounded to bf16 as JAX's transpose of the pair rounds it."""

    @staticmethod
    def forward(ctx_, y, mesh):
        g = C.group(mesh, "model")
        part = C._scatter(y, g, 0).to(torch.bfloat16)
        return C._gather(part, g, 0).to(y.dtype)

    @staticmethod
    def backward(ctx_, dy):
        return dy.to(torch.bfloat16).to(dy.dtype), None


def _apply_moe_ep(cfg, mesh, x2d, idx2d, w2d, gate, up, down, *, rs: bool):
    """The mesh branch of JAX's ``apply_moe`` on this rank's tokens."""
    E, k = cfg.num_experts, cfg.experts_per_token
    tp = C.axis_size(mesh, "model")
    e_local = E // tp
    e0 = C.axis_index(mesh, "model") * e_local
    # capacity from the LOCAL token count (x2d is the local block)
    cap = _capacity(x2d.shape[0], k, E, cfg.capacity_factor)
    y = _expert_compute_local(x2d, idx2d, w2d, gate, up, down, e0, e_local, cap)
    if rs:
        return _ReduceScatterGatherBF16.apply(y, mesh)
    return C.psum(y, mesh, "model")


def _apply_moe_a2a(cfg, mesh, x2d, idx2d, w2d, gate, up, down):
    """Sequence-sharded EP with all-to-all dispatch on this rank's tokens
    (replicated over ``model``): this ``model`` rank's slice of rows is
    routed in fixed-capacity buckets (``c_send`` per destination) to the
    expert owners, computed there (``c_comp`` per expert), sent back,
    scatter-added with the routing weights. Returns this rank's t rows; the
    caller gathers them over ``model``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    tp = C.axis_size(mesh, "model")
    e_local = E // tp
    t = x2d.shape[0] // tp
    c_send = _capacity(t, k, tp, cfg.capacity_factor)       # per-dest bucket
    c_comp = _capacity(tp * c_send, 1, e_local, cfg.capacity_factor)
    m = C.axis_index(mesh, "model")
    x_ = x2d[m * t:(m + 1) * t]
    idx_, w_ = idx2d[m * t:(m + 1) * t], w2d[m * t:(m + 1) * t]
    D = x_.shape[1]
    N = t * k
    flat_e = idx_.reshape(N)
    # the pairs bucketed by owning rank, in JAX's (stable) order
    slot_flat, inv = dispatch_maps((flat_e // e_local).reshape(N, 1), 0, tp, c_send)
    slot_tok = torch.where(slot_flat < N, slot_flat // k, torch.full_like(slot_flat, t))
    valid = slot_flat < N
    s_x = _GatherRows.apply(x_, slot_tok, inv.reshape(t, k))
    s_e = torch.where(valid, flat_e[slot_flat.clamp(max=N - 1)], torch.zeros_like(slot_flat))
    s_w = _GatherRows.apply(w_.reshape(N, 1), slot_flat, inv)      # (tp c_send, 1)

    r_x = C.all_to_all(s_x, mesh, "model")
    r_e = C.all_to_all(s_e, mesh, "model")
    r_v = C.all_to_all(valid.to(torch.int8), mesh, "model").bool()

    e0 = m * e_local
    le = torch.where(r_v, r_e - e0, torch.full_like(r_e, e_local)).reshape(-1, 1)
    ones = torch.ones((tp * c_send, 1), dtype=x_.dtype, device=x_.device)
    out = _expert_compute_local(r_x, le, ones, gate, up, down, 0, e_local, c_comp)
    out = C.all_to_all(out, mesh, "model")
    # combine: weighted scatter-add back to the local tokens
    return _GatherRows.apply(out * s_w, inv.reshape(t, k), slot_flat.reshape(-1, 1)).sum(1)
