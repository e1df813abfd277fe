"""Plain PyTorch oracles for the port's kernels (the allclose ground truth).

Torch copies of ``repro/kernels/ref.py``, and the plain backward versions the
JAX package leaves to autodiff (``reference_rmsnorm_bwd``,
``reference_attention_bwd``, ``ssd_scan_bwd``). The CPU path of every wrapper in ``ops.py``
runs these, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card. ``reference_ssd`` is the sequential recurrence, independent of
both the chunked plain version (``ops.ssd_scan_plain``) and the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import SPLIT_PIECES


def attention_mask(Sq: int, Sk: int, prefix_len: int = 0, device=None):
    """The causal mask with a bidirectional prefix, (Sq, Sk) bool: key j is
    valid for row i iff j <= i or j < prefix_len (``_block_attn``'s, with
    the row indices as positions)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None]
    return (kpos <= qpos) | (kpos < prefix_len)


def reference_attention(q, k, v, *, causal: bool = True, scale=None,
                        return_lse: bool = False, prefix_len: int = 0):
    """q,k: (BH, Sq/Sk, D), v: (BH, Sk, Dv) -> (BH, Sq, Dv). Full softmax,
    under ``causal`` with keys below ``prefix_len`` valid for every row.
    ``return_lse`` also returns the rows' fp32 logsumexp of the scaled,
    masked scores, (BH, Sq), in natural-log units."""
    Sq, Sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = attention_mask(Sq, Sk, prefix_len, q.device)
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


# Keys per block of ``reference_attention_bwd``: bounds its fp32 scores.
ATTN_BWD_BLOCK = 1024


def reference_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            prefix_len: int = 0):
    """Gradients of attention with scale D^-0.5, by the FA2 recurrence over
    key blocks of ``ATTN_BWD_BLOCK``, in the model layout with GQA: q (B,H,Sq,D), k
    (B,KH,Sk,D), v (B,KH,Sk,Dv), o and do (B,H,Sq,Dv), lse (B,H,Sq) fp32 in
    natural-log units. With P = exp(S*scale - lse) and D = rowsum(dO o O):
    dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K * scale, dK = dS^T Q * scale,
    dK and dV summed over the H/KH query heads of each KV head; the mask is
    ``reference_attention``'s (``causal``, ``prefix_len``). A row with no
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
    mask = attention_mask(Sq, Sk, prefix_len, q.device) if causal else None
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    block = ATTN_BWD_BLOCK
    for s0 in range(0, Sk, block):
        kb, vb = k[:, :, s0:s0 + block].float(), v[:, :, s0:s0 + block].float()
        s = torch.einsum("bkgqd,bksd->bkgqs", q32, kb) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            p = torch.where(mask[:, s0:s0 + block], p, torch.zeros_like(p))
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


def ssd_scan_bwd(x, dA, Bm, Cm, dy, dstate=None, *, chunk: int,
                 carry_state_grad: bool = True):
    """Gradients of the chunked SSD scan (``ops.ssd_scan_plain``) in the CUDA
    ``ssd_scan_bwd``'s decomposition, plain PyTorch in fp32, as
    ``ops.ssd_scan_plain`` computes the forward. The autograd Function's CPU
    backward; ``chip_smoke.py`` holds the kernel against it.

    Model layout: x (Bsz,S,H,P) dt-scaled, dA (Bsz,S,H), B/C (Bsz,S,G,N),
    dy (Bsz,S,H,P), dstate (Bsz,H,N,P) the gradient of the final state or
    None; ``chunk`` divides S. Per chunk, with cum the running sum of dA in
    the chunk, e_t = exp(cum_t), w_s = exp(cum_last - cum_s), h_c the state
    entering chunk c and G_c the gradient of the state leaving it:
      1. D_c = sum_t e_t C_t dy_t^T;
      2. in reverse over the chunks, G_last = dstate, G_{c-1} = exp(cum_last) G_c + D_c;
      3. per head, with L_ts = exp(cum_t - cum_s) for s <= t (else 0):
         dx_s = sum_t (C_t.B_s) L_ts dy_t + w_s G_c^T B_s,
         dB_s = sum_t L_ts (dy_t.x_s) C_t + w_s G_c x_s,
         dC_t = sum_s L_ts (dy_t.x_s) B_s + e_t h_c dy_t;
      4. dB and dC summed over each group's heads; d cum_t = C_t.dC_t - B_t.dB_t
         per head (the within-chunk terms, the cross-chunk ones and the
         decays w: each M_ts = (C_t.B_s)(dy_t.x_s) L_ts enters C_t.dC_t and
         B_s.dB_s once);
      5. d dA_s = sum_{t >= s in the chunk} d cum_t + <h_{c+1}, G_c>, the last
         row's cum scaling the whole leaving state; summed in fp64.
    cum itself is summed in fp64, as the kernels sum it.
    ``carry_state_grad=False`` sets every G_c to zero: the control that
    shows a check can see a missing state gradient. Returns (dx fp32,
    d dA fp32, dB, dC in B's and C's dtypes).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R, Q = H // G, chunk
    nc = S // Q
    x_ = x.float().reshape(Bsz, nc, Q, G, R, P)
    dy_ = dy.float().reshape(Bsz, nc, Q, G, R, P)
    # cum in fp64, as the kernels sum it: over a chunk of thousands of rows it
    # reaches thousands, where fp32 differences would leave 1e-3 in the decays
    cum = dA.double().reshape(Bsz, nc, Q, G, R).cumsum(dim=2)
    B_ = Bm.float().reshape(Bsz, nc, Q, G, N)
    C_ = Cm.float().reshape(Bsz, nc, Q, G, N)

    # the forward's states: entering each chunk, and leaving it
    w = (cum[:, :, -1:] - cum).exp().float()
    e = cum.exp().float()
    decay = cum[:, :, -1].exp().float()[..., None, None]        # (Bsz,nc,G,R,1,1)
    own = torch.einsum("bcsgn,bcsgr,bcsgrp->bcgrnp", B_, w, x_)
    run = torch.zeros_like(own[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * decay[:, c] + own[:, c]
    leaving = torch.stack(entering[1:] + [run], dim=1)
    entering = torch.stack(entering, dim=1)                     # (Bsz,nc,G,R,N,P)

    # 1-2. the state gradients
    D = torch.einsum("bctgn,bctgr,bctgrp->bcgrnp", C_, e, dy_)
    run = (torch.zeros_like(D[:, 0]) if dstate is None
           else dstate.float().reshape(Bsz, G, R, N, P))
    grads = [None] * nc
    for c in reversed(range(nc)):
        grads[c] = run
        run = run * decay[:, c] + D[:, c]
    Gst = torch.stack(grads, dim=1)                             # (Bsz,nc,G,R,N,P)
    if not carry_state_grad:
        Gst = torch.zeros_like(Gst)

    # 3. per head
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None]                  # (Bsz,nc,Qt,Qs,G,R)
    Lmat = torch.where(tri[:, :, None, None], seg.exp(), 0.0).float()
    del seg
    CB = torch.einsum("bctgn,bcsgn->bctsg", C_, B_)
    LDX = Lmat * torch.einsum("bctgrp,bcsgrp->bctsgr", dy_, x_)
    dx = (torch.einsum("bctsg,bctsgr,bctgrp->bcsgrp", CB, Lmat, dy_)
          + torch.einsum("bcsgr,bcsgn,bcgrnp->bcsgrp", w, B_, Gst))
    dBh = (torch.einsum("bctsgr,bctgn->bcsgrn", LDX, C_)
           + torch.einsum("bcsgr,bcsgrp,bcgrnp->bcsgrn", w, x_, Gst))
    dCh = (torch.einsum("bctsgr,bcsgn->bctgrn", LDX, B_)
           + torch.einsum("bctgr,bctgrp,bcgrnp->bctgrn", e, dy_, entering))

    # 4. over the heads of each group; d cum per head
    dcum = (torch.einsum("bctgn,bctgrn->bctgr", C_, dCh)
            - torch.einsum("bctgn,bctgrn->bctgr", B_, dBh))
    # 5. the reverse running sum in the chunk, in fp64
    last = torch.einsum("bcgrnp,bcgrnp->bcgr", leaving, Gst)
    ddA = dcum.double().flip(2).cumsum(2).flip(2) + last.double()[:, :, None]
    return (dx.reshape(Bsz, S, H, P), ddA.float().reshape(Bsz, S, H),
            dBh.sum(4).reshape(Bsz, S, G, N).to(Bm.dtype),
            dCh.sum(4).reshape(Bsz, S, G, N).to(Cm.dtype))


def split_mm(eq, a, b, pieces=0):
    """``torch.einsum(eq, a, b)`` of fp32 operands, or the CUDA
    ``ssd_scan_bwd``'s tensor-core product: with ``pieces`` n (or a pair,
    one count per operand) each operand as bf16 pieces (hi = bf16(a), each
    next piece bf16 of what the ones before leave), and the pieces' exact
    products i.j with i + j below the larger count summed in fp32 (hi.hi,
    lo.hi, hi.lo for two pieces each; six terms for three). An operand exact
    in bf16 has only its first piece, so one piece of it loses nothing."""
    if not pieces:
        return torch.einsum(eq, a, b)
    pa, pb = (pieces, pieces) if isinstance(pieces, int) else pieces

    def split(t, n):
        out = []
        for _ in range(n):
            out.append(t.bfloat16().float())
            t = t - out[-1]
        return out

    sa, sb = split(a, pa), split(b, pb)
    out = torch.einsum(eq, sa[0], sb[0])
    for i in range(pa):
        for j in range(pb):
            if (i or j) and i + j < max(pa, pb):
                out = out + torch.einsum(eq, sa[i], sb[j])
    return out


def ssd_bwd_tiles(x, dA, Bm, Cm, dy, dstate=None, *, chunk: int, tile: int = 64,
                  heads_per_block: int = 1, route=None, pieces: int = 0):
    """The CUDA ``ssd_scan_bwd``'s decomposition in plain PyTorch, for the
    tests only (no path of the port runs it). Arguments and results as
    ``ssd_scan_bwd``; ``route`` ("bf16_bc", "split_bc") emulates the
    kernel's split products with ``ssd_scan.SPLIT_PIECES``, ``pieces`` n splits
    every operand of every product in n (``split_mm``); neither keeps plain
    fp32 products.

    Per chunk and own tile of ``tile`` rows, every head of a group at once:
      phase A, rows s of the tile: dx_s and dB_s start from the cross-chunk
        terms w_s G_c^T B_s and w_s G_c x_s, then add, over the slabs t >= s
        in order, T1^T dy and T2^T C with T1 = (C B^T) o L (C B^T once per
        group) and T2 = M' = (dy x^T) o L;
      phase B, rows t: dC_t starts from e_t h_c dy_t and adds T2 B over the
        slabs s <= t in order (M' formed again from the same operands);
      d cum per head, C_t.dC_t - B_t.dB_t, from row sums of M = T1 o (dy x^T)
        and the dot products of the cross-chunk terms, so that dB and dC
        leave a block summed over its ``heads_per_block`` heads, and the
        head blocks are summed in order.
    L_ts = exp(c_t - c_s) for s <= t with c = cum less cum at the tile's
    first row, in fp32, as the kernel takes its decays; cum in fp64.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R, Q = H // G, chunk
    nc = S // Q

    names = {"bctgn,bctgrp->bcgrnp": "C^T (e o dy)", "bcsgn,bcgrnp->bcsgrp": "G_c^T B",
             "bcsgrp,bcgrnp->bcsgrn": "G_c x", "bcsgn,bctgn->bcgst": "C B^T",
             "bctgn,bcsgn->bcgts": "C B^T", "bcsgrp,bctgrp->bcgrst": "dy x^T",
             "bctgrp,bcsgrp->bcgrts": "dy x^T", "bcgrst,bctgrp->bcsgrp": "T1^T dy",
             "bcgrst,bctgn->bcsgrn": "T2^T C", "bcgrts,bcsgn->bctgrn": "T2 B",
             "bctgrp,bcgrnp->bctgrn": "h_c dy"}

    def mm(eq, a, b):
        return split_mm(eq, a, b, SPLIT_PIECES[route][names[eq]] if route else pieces)

    x_ = x.float().reshape(Bsz, nc, Q, G, R, P)
    dy_ = dy.float().reshape(Bsz, nc, Q, G, R, P)
    cum = dA.double().reshape(Bsz, nc, Q, G, R).cumsum(dim=2)
    B_ = Bm.float().reshape(Bsz, nc, Q, G, N)
    C_ = Cm.float().reshape(Bsz, nc, Q, G, N)
    w = (cum[:, :, -1:] - cum).exp().float()
    e = cum.exp().float()
    decay = cum[:, :, -1].exp().float()[..., None, None]

    own = torch.einsum("bcsgn,bcsgr,bcsgrp->bcgrnp", B_, w, x_)
    run = torch.zeros_like(own[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * decay[:, c] + own[:, c]
    leaving = torch.stack(entering[1:] + [run], dim=1)
    entering = torch.stack(entering, dim=1)                     # (Bsz,nc,G,R,N,P)

    D = mm("bctgn,bctgrp->bcgrnp", C_, e[..., None] * dy_)
    run = (torch.zeros_like(D[:, 0]) if dstate is None
           else dstate.float().reshape(Bsz, G, R, N, P))
    grads = [None] * nc
    for c in reversed(range(nc)):
        grads[c] = run
        run = run * decay[:, c] + D[:, c]
    Gst = torch.stack(grads, dim=1)

    dx = torch.zeros_like(x_)
    dBh = torch.zeros((Bsz, nc, Q, G, R, N))
    dCh = torch.zeros_like(dBh)
    dcum = torch.zeros((Bsz, nc, Q, G, R))
    rows = [slice(r0, min(r0 + tile, Q)) for r0 in range(0, Q, tile)]

    def decays(rt, rs, t0):
        """L over the rows rt (t) and rs (s), (Bsz,nc,G,R,t,s): fp32
        differences of cum less cum at row t0, masked to s <= t."""
        base = cum[:, :, t0:t0 + 1]
        ct, cs = (cum[:, :, rt] - base).float(), (cum[:, :, rs] - base).float()
        seg = (ct[:, :, :, None] - cs[:, :, None]).permute(0, 1, 4, 5, 2, 3)
        t_idx = torch.arange(Q)[rt][:, None]
        s_idx = torch.arange(Q)[rs][None]
        return torch.where(t_idx >= s_idx, seg.exp(), 0.0)

    for r, own_rows in enumerate(rows):
        t0 = own_rows.start
        B_o, C_o = B_[:, :, own_rows], C_[:, :, own_rows]
        x_o, dy_o = x_[:, :, own_rows], dy_[:, :, own_rows]
        w_o, e_o = w[:, :, own_rows], e[:, :, own_rows]
        # phase A: dx and dB of the rows s
        acc_x = w_o[..., None] * mm("bcsgn,bcgrnp->bcsgrp", B_o, Gst)
        tmp = mm("bcsgrp,bcgrnp->bcsgrn", x_o, Gst)
        dc = -w_o * torch.einsum("bcsgn,bcsgrn->bcsgr", B_o, tmp)
        acc_b = w_o[..., None] * tmp
        for slab in rows[r:]:
            Lt = decays(slab, own_rows, t0).transpose(-1, -2)          # [s][t]
            cbt = mm("bcsgn,bctgn->bcgst", B_o, C_[:, :, slab])
            dxt = mm("bcsgrp,bctgrp->bcgrst", x_o, dy_[:, :, slab])
            t1 = cbt[:, :, :, None] * Lt
            t2 = dxt * Lt
            dc = dc - (t1 * dxt).sum(-1).permute(0, 1, 4, 2, 3)
            acc_x = acc_x + mm("bcgrst,bctgrp->bcsgrp", t1, dy_[:, :, slab])
            acc_b = acc_b + mm("bcgrst,bctgn->bcsgrn", t2, C_[:, :, slab])
        # phase B: dC of the rows t
        tmp = mm("bctgrp,bcgrnp->bctgrn", dy_o, entering)
        dc = dc + e_o * torch.einsum("bctgn,bctgrn->bctgr", C_o, tmp)
        acc_c = e_o[..., None] * tmp
        for slab in rows[:r + 1]:
            L = decays(own_rows, slab, t0)                             # [t][s]
            cb = mm("bctgn,bcsgn->bcgts", C_o, B_[:, :, slab])
            t2 = mm("bctgrp,bcsgrp->bcgrts", dy_o, x_[:, :, slab]) * L
            dc = dc + (t2 * cb[:, :, :, None]).sum(-1).permute(0, 1, 4, 2, 3)
            acc_c = acc_c + mm("bcgrts,bcsgn->bctgrn", t2, B_[:, :, slab])
        dx[:, :, own_rows] = acc_x
        dBh[:, :, own_rows] = acc_b
        dCh[:, :, own_rows] = acc_c
        dcum[:, :, own_rows] = dc

    def over_heads(t):
        blocks = [t[..., h:h + heads_per_block, :].sum(4)
                  for h in range(0, R, heads_per_block)]
        out = blocks[0]
        for blk in blocks[1:]:
            out = out + blk
        return out

    last = torch.einsum("bcgrnp,bcgrnp->bcgr", leaving, Gst)
    ddA = dcum.double().flip(2).cumsum(2).flip(2) + last.double()[:, :, None]
    return (dx.reshape(Bsz, S, H, P), ddA.float().reshape(Bsz, S, H),
            over_heads(dBh).reshape(Bsz, S, G, N).to(Bm.dtype),
            over_heads(dCh).reshape(Bsz, S, G, N).to(Cm.dtype))


def attention_bwd_tiles(q, k, v, o, lse, do, *, causal: bool = True, q_step: int = 64,
                        keys: int = 128, q_rows: int = 128, key_tile: int = 64,
                        half: int = 64, prefix_len: int = 0):
    """The CUDA bf16 flash backward's tiling in plain PyTorch (fp32), for the
    tests only (no path of the port runs it). Model layout with GQA, as
    ``reference_attention_bwd``; the lse in log2 units (+inf for -inf) and
    P = exp2(S * scale * log2(e) - lse2), as the kernels compute them.

    dK/dV: blocks of ``keys`` keys per KV head, each split in warpgroup
    halves of ``half`` keys; a block walks the q tiles of ``q_step`` rows of
    each query head of its group, from its first key on under the causal
    mask (from row 0 where the block starts inside the prefix), and a half
    skips a tile whose every pair is masked (or whose keys all lie past Sk).
    The mask is applied only where the kernels apply it: on a dK/dV tile
    with a key past a row and past the prefix, on a dQ (and forward) edge
    tile, so a wrong edge test shows as a wrong gradient. dQ: blocks of ``q_rows`` rows in halves of ``half``, each half summing
    its ``key_tile``-key tiles in order up to the causal limit, or to the
    prefix where it lies further. The mask is ``reference_attention``'s
    (``causal``, ``prefix_len``). Returns (dq, dk, dv, visits): visits
    counts the (half, tile) products of each kernel, over the KV heads and
    query heads of batch 0.
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
    mask = attention_mask(Sq, Sk, prefix_len, q.device)

    def keys_seen(row0, rows):          # the kernels' k_end
        return min(Sk, max(row0 + rows, prefix_len)) if causal else Sk

    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    dq = torch.zeros_like(q32)
    visits = {"dkdv": 0, "dq": 0}

    for k0 in range(0, Sk, keys):
        q_first = k0 if causal and k0 >= prefix_len else 0
        for kw0 in range(k0, k0 + keys, half):
            if kw0 >= Sk:
                continue
            ks = slice(kw0, min(kw0 + half, Sk))
            for hh in range(G):
                for q0 in range(q_first, Sq, q_step):
                    if causal and q0 + q_step - 1 < kw0 and kw0 >= prefix_len:
                        continue
                    visits["dkdv"] += KH
                    qs = slice(q0, min(q0 + q_step, Sq))
                    qt, dot = q32[:, :, hh, qs], do32[:, :, hh, qs]
                    s_t = torch.einsum("bkid,bkjd->bkij", k32[:, :, ks], qt)
                    p_t = torch.exp2(s_t * (scale * log2e) - l2[:, :, hh, None, qs])
                    # the kernel masks only where some pair may be masked
                    if causal and q0 < kw0 + half and kw0 + half > prefix_len:
                        p_t = torch.where(mask[qs, ks].T, p_t, torch.zeros_like(p_t))
                    dp_t = torch.einsum("bkie,bkje->bkij", v32[:, :, ks], dot)
                    ds_t = p_t * (dp_t - delta[:, :, hh, None, qs])
                    dv[:, :, ks] += torch.einsum("bkij,bkje->bkie", p_t, dot)
                    dk[:, :, ks] += torch.einsum("bkij,bkjd->bkid", ds_t, qt)

    for q0 in range(0, Sq, q_rows):
        n_tiles = -(-keys_seen(q0, q_rows) // key_tile)
        for q0w in range(q0, q0 + q_rows, half):
            if q0w >= Sq:
                continue
            wg_tiles = -(-keys_seen(q0w, half) // key_tile)
            rows = slice(q0w, min(q0w + half, Sq))
            for j in range(wg_tiles):
                visits["dq"] += H
                k0 = j * key_tile
                ks = slice(k0, min(k0 + key_tile, Sk))
                # the kernels' edge tile (the forward's too): a key past a
                # row and past the prefix (keys past Sk are cut off here)
                edge = causal and k0 + key_tile - 1 > q0w and k0 + key_tile > prefix_len
                s = torch.einsum("bkgid,bkjd->bkgij", q32[:, :, :, rows], k32[:, :, ks])
                p = torch.exp2(s * (scale * log2e) - l2[:, :, :, rows, None])
                if edge:
                    p = torch.where(mask[rows, ks], p, torch.zeros_like(p))
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
