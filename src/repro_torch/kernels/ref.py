"""Plain PyTorch oracles for the port's kernels (the allclose ground truth).

Torch copies of ``repro/kernels/ref.py``, and the plain backward versions the
JAX package leaves to autodiff (``reference_rmsnorm_bwd``,
``reference_attention_bwd``). The CPU path of every wrapper in ``ops.py``
runs these, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card. ``reference_ssd`` is the sequential recurrence, independent of
both the chunked plain version (``ops.ssd_scan_plain``) and the kernel.
"""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, causal: bool = True, scale=None,
                        return_lse: bool = False):
    """q,k: (BH, Sq/Sk, D), v: (BH, Sk, Dv) -> (BH, Sq, Dv). Full softmax.
    ``return_lse`` also returns the rows' fp32 logsumexp of the scaled,
    masked scores, (BH, Sq), in natural-log units."""
    Sq, Sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


# Keys per block of ``reference_attention_bwd``: bounds its fp32 scores.
ATTN_BWD_BLOCK = 1024


def reference_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """Gradients of attention with scale D^-0.5, by the FA2 recurrence over
    key blocks of ``ATTN_BWD_BLOCK``, in the model layout with GQA: q (B,H,Sq,D), k
    (B,KH,Sk,D), v (B,KH,Sk,Dv), o and do (B,H,Sq,Dv), lse (B,H,Sq) fp32 in
    natural-log units. With P = exp(S*scale - lse) and D = rowsum(dO o O):
    dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K * scale, dK = dS^T Q * scale,
    dK and dV summed over the H/KH query heads of each KV head. A row with no
    valid key (lse = -inf) gets zero gradients. fp32 math; returns (dq, dk,
    dv) in the inputs' dtypes.
    """
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = D ** -0.5
    q32 = q.float().reshape(B, KH, G, Sq, D)
    do32 = do.float().reshape(B, KH, G, Sq, Dv)
    delta = (do32 * o.float().reshape(B, KH, G, Sq, Dv)).sum(-1)
    lse = lse.float().reshape(B, KH, G, Sq)
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")), lse)
    qpos = torch.arange(Sq, device=q.device)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    block = ATTN_BWD_BLOCK
    for s0 in range(0, Sk, block):
        kb, vb = k[:, :, s0:s0 + block].float(), v[:, :, s0:s0 + block].float()
        s = torch.einsum("bkgqd,bksd->bkgqs", q32, kb) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = torch.arange(s0, s0 + kb.shape[2], device=q.device)
            p = torch.where(qpos[:, None] >= kpos[None], p, torch.zeros_like(p))
        dvs.append(torch.einsum("bkgqs,bkgqe->bkse", p, do32))
        ds = p * (torch.einsum("bkgqe,bkse->bkgqs", do32, vb) - delta[..., None])
        dq += torch.einsum("bkgqs,bksd->bkgqd", ds, kb) * scale
        dks.append(torch.einsum("bkgqs,bkgqd->bksd", ds, q32) * scale)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def reference_ssd(x, dA, Bm, Cm):
    """Sequential SSD recurrence.

    x: (BH, S, P) inputs (already dt-scaled); dA: (BH, S) log-decays (<=0);
    Bm, Cm: (BH, S, N). Returns (y (BH,S,P), final_state (BH,N,P) fp32).

        h_t = exp(dA_t) * h_{t-1} + B_t (x) x_t ;   y_t = C_t . h_t
    """
    BH, S, P = x.shape
    N = Bm.shape[-1]
    x32, dA32, B32, C32 = x.float(), dA.float(), Bm.float(), Cm.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(dA32[:, t])[:, None, None] + torch.einsum(
            "bn,bp->bnp", B32[:, t], x32[:, t])
        ys.append(torch.einsum("bn,bnp->bp", C32[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def reference_rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def reference_rmsnorm_bwd(x, scale, dy, eps: float = 1e-5):
    """Gradients of ``reference_rmsnorm`` for x (..., D), in fp32 math:
    dx = rstd * (g - x_hat * mean(x_hat * g)) with g = dy * scale and
    x_hat = x * rstd; dscale = the sum over rows of dy * x_hat. Returns dx in
    x's dtype and dscale in scale's."""
    D = x.shape[-1]
    x32 = x.float().reshape(-1, D)
    dy32 = dy.float().reshape(-1, D)
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * rstd
    g = dy32 * scale.float()
    dx = rstd * (g - xhat * (xhat * g).mean(dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), (dy32 * xhat).sum(0).to(scale.dtype)


def ssd_chunk_passes(x, dA, Bm, Cm, *, chunk: int):
    """The CUDA ``ssd_scan``'s three-pass decomposition in plain PyTorch, for
    the tests only (no path of the port runs it).

    Model layout: x (Bsz,S,H,P), dA (Bsz,S,H), B/C (Bsz,S,G,N), ``chunk``
    dividing S. Every chunk at once:
      1. the chunks' own states S_c = (B o exp(cum_last - cum))^T x;
      2. the states entering each chunk, state_{c+1} = state_c exp(cum_last_c) + S_c;
      3. y = ((C B^T) o tril(exp(cum_t - cum_s))) x + (C o exp(cum)) state_c,
         with C B^T once per group.
    Returns (y (Bsz,S,H,P) in x.dtype, final state (Bsz,H,N,P) fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R, Q = H // G, chunk
    nc = S // Q
    x32 = x.float().reshape(Bsz, nc, Q, G, R, P)
    cum = dA.float().reshape(Bsz, nc, Q, G, R).cumsum(dim=2)
    B32 = Bm.float().reshape(Bsz, nc, Q, G, N)
    C32 = Cm.float().reshape(Bsz, nc, Q, G, N)

    w = (cum[:, :, -1:] - cum).exp()
    own = torch.einsum("bcsgn,bcsgr,bcsgrp->bcgrnp", B32, w, x32)

    decay = cum[:, :, -1].exp()[..., None, None]                # (Bsz,nc,G,R,1,1)
    run = torch.zeros_like(own[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * decay[:, c] + own[:, c]
    entering = torch.stack(entering, dim=1)                     # (Bsz,nc,G,R,N,P)

    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None]                  # (Bsz,nc,Qt,Qs,G,R)
    Lmat = torch.where(tri[:, :, None, None], seg.exp(), 0.0)
    CB = torch.einsum("bctgn,bcsgn->bcgts", C32, B32)
    y = torch.einsum("bcgts,bctsgr,bcsgrp->bctgrp", CB, Lmat, x32)
    y = y + torch.einsum("bctgn,bctgr,bcgrnp->bctgrp", C32, cum.exp(), entering)
    return y.reshape(Bsz, S, H, P).to(x.dtype), run.reshape(Bsz, H, N, P)


def attention_bwd_tiles(q, k, v, o, lse, do, *, causal: bool = True, q_step: int = 64,
                        keys: int = 128, q_rows: int = 128, key_tile: int = 64,
                        half: int = 64):
    """The CUDA bf16 flash backward's tiling in plain PyTorch (fp32), for the
    tests only (no path of the port runs it). Model layout with GQA, as
    ``reference_attention_bwd``; the lse in log2 units (+inf for -inf) and
    P = exp2(S * scale * log2(e) - lse2), as the kernels compute them.

    dK/dV: blocks of ``keys`` keys per KV head, each split in warpgroup
    halves of ``half`` keys; a block walks the q tiles of ``q_step`` rows of
    each query head of its group, from its first key on under the causal
    mask, and a half skips a tile whose every pair is masked (or whose keys
    all lie past Sk). dQ: blocks of ``q_rows`` rows in halves of ``half``,
    each half summing its ``key_tile``-key tiles in order up to the causal
    limit. Returns (dq, dk, dv, visits): visits counts the (half, tile)
    products of each kernel, over the KV heads and query heads of batch 0.
    """
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = D ** -0.5
    log2e = 1.4426950408889634
    q32 = q.float().reshape(B, KH, G, Sq, D)
    do32 = do.float().reshape(B, KH, G, Sq, Dv)
    k32, v32 = k.float(), v.float()
    delta = (do32 * o.float().reshape(B, KH, G, Sq, Dv)).sum(-1)
    l2 = lse.float().reshape(B, KH, G, Sq) * log2e
    l2 = torch.where(torch.isneginf(l2), torch.full_like(l2, float("inf")), l2)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    dq = torch.zeros_like(q32)
    visits = {"dkdv": 0, "dq": 0}

    for k0 in range(0, Sk, keys):
        q_first = k0 if causal else 0
        for kw0 in range(k0, k0 + keys, half):
            if kw0 >= Sk:
                continue
            ks = slice(kw0, min(kw0 + half, Sk))
            for hh in range(G):
                for q0 in range(q_first, Sq, q_step):
                    if causal and q0 + q_step - 1 < kw0:
                        continue
                    visits["dkdv"] += KH
                    qs = slice(q0, min(q0 + q_step, Sq))
                    qt, dot = q32[:, :, hh, qs], do32[:, :, hh, qs]
                    s_t = torch.einsum("bkid,bkjd->bkij", k32[:, :, ks], qt)
                    p_t = torch.exp2(s_t * (scale * log2e) - l2[:, :, hh, None, qs])
                    if causal:
                        valid = kpos[ks, None] <= qpos[None, qs]
                        p_t = torch.where(valid, p_t, torch.zeros_like(p_t))
                    dp_t = torch.einsum("bkie,bkje->bkij", v32[:, :, ks], dot)
                    ds_t = p_t * (dp_t - delta[:, :, hh, None, qs])
                    dv[:, :, ks] += torch.einsum("bkij,bkje->bkie", p_t, dot)
                    dk[:, :, ks] += torch.einsum("bkij,bkjd->bkid", ds_t, qt)

    for q0 in range(0, Sq, q_rows):
        n_tiles = -(-(min(Sk, q0 + q_rows) if causal else Sk) // key_tile)
        for q0w in range(q0, q0 + q_rows, half):
            if q0w >= Sq:
                continue
            wg_tiles = -(-min(Sk, q0w + half) // key_tile) if causal else n_tiles
            rows = slice(q0w, min(q0w + half, Sq))
            for j in range(wg_tiles):
                visits["dq"] += H
                ks = slice(j * key_tile, min((j + 1) * key_tile, Sk))
                s = torch.einsum("bkgid,bkjd->bkgij", q32[:, :, :, rows], k32[:, :, ks])
                p = torch.exp2(s * (scale * log2e) - l2[:, :, :, rows, None])
                if causal:
                    valid = kpos[None, ks] <= qpos[rows, None]
                    p = torch.where(valid, p, torch.zeros_like(p))
                dp = torch.einsum("bkgie,bkje->bkgij", do32[:, :, :, rows], v32[:, :, ks])
                ds = p * (dp - delta[:, :, :, rows, None])
                dq[:, :, :, rows] += torch.einsum("bkgij,bkjd->bkgid", ds, k32[:, :, ks])
    return ((dq * scale).reshape(B, H, Sq, D).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype), visits)


def rmsnorm_bwd_partials(x, scale, dy, *, path: str, grid: int, eps: float = 1e-5,
                         warps: int = 4, slices: int = 8):
    """The CUDA ``rmsnorm_bwd``'s order of summation in plain PyTorch (fp32),
    for the tests only. x, dy (R, D); ``path`` and ``grid`` as
    ``rmsnorm.plan_bwd`` gives them. On ``warp_per_row`` warp w of block b
    takes rows b*warps + w, then + grid*warps, ..., summing dy * x_hat of
    its rows in order, and the block adds its warps in order; on the other
    paths block b takes rows b, b + grid, ... Then, per column, ``slices``
    running sums over the blocks b = y, y + slices, ... are added in order
    of y. Returns (dx, dscale, partials (grid, D) fp32), dx in x's dtype,
    dscale in scale's."""
    R, D = x.shape
    x32, dy32, s32 = x.float(), dy.float(), scale.float()
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    g = dy32 * s32
    dx = rstd * g - x32 * (rstd ** 3 * (x32 * g).sum(-1, keepdim=True) / D)
    contrib = dy32 * (x32 * rstd)
    per_block = warps if path == "warp_per_row" else 1
    partials = torch.zeros((grid, D), dtype=torch.float32, device=x.device)
    for b in range(grid):
        for w in range(per_block):
            acc = torch.zeros(D, dtype=torch.float32, device=x.device)
            for r in range(b * per_block + w, R, grid * per_block):
                acc = acc + contrib[r]
            partials[b] = partials[b] + acc
    total = torch.zeros(D, dtype=torch.float32, device=x.device)
    for y in range(slices):
        acc = torch.zeros(D, dtype=torch.float32, device=x.device)
        for b in range(y, grid, slices):
            acc = acc + partials[b]
        total = total + acc
    return dx.to(x.dtype), total.to(scale.dtype), partials
