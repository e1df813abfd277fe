"""Mixture-of-Experts, the local (one-device) path.

Port of ``repro/models/moe.py``'s ``init_moe``, ``_route``, ``_capacity``,
``_expert_compute_local`` and ``apply_moe`` as the JAX ``apply_moe`` runs
them without a mesh (``moe.py:228-231``). The expert-parallel paths
(``_apply_moe_a2a``, the ``shard_map`` of ``apply_moe``, ``moe_rs``) belong
to the distributed queue.

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

from repro_torch.models import layers as L


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


def _route(p, cfg, x: torch.Tensor):
    """Returns (weights (B,S,k) in x.dtype, idx (B,S,k), aux_loss fp32)."""
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
