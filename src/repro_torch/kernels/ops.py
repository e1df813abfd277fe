"""Public kernel entry points of the port.

Each wrapper launches its hand-written CUDA kernel for a tensor on a CUDA
device and runs its plain PyTorch version for a tensor on the CPU. There is
no fallback from one to the other: a CUDA tensor the kernel cannot take
raises. ``LAUNCHES`` counts kernel launches, one per call that launched,
and nothing else, so a run can show that its path went through the kernels.

``rmsnorm`` always, and ``flash_attention`` and ``ssd_scan`` where an input
requires grad (and grad is enabled), go through ``torch.autograd.Function``s
whose backward is a kernel too: ``_RMSNormFn`` saves x and scale and
launches ``rmsnorm_bwd``; ``_FlashAttentionFn`` saves q, k, v, o and the
forward's lse and launches ``flash_attention_bwd`` (without grad the forward
skips the lse output); ``_SSDScanFn`` saves x, dA, B, C and the forward's
scratch (cum, the chunk states, the final state) and launches
``ssd_scan_bwd`` (without grad the scratch is dropped). Each backward call
counts one in ``LAUNCHES`` under its own name. On the CPU the same Functions
run the plain forward and backward versions (``ref.py``).

Under a device mesh the inputs arrive as ``DTensor``s, and the kernels take
raw pointers, so each wrapper enters on local shards (``enter_local``): the
inputs are redistributed to the placements the kernel can compute on
locally, the kernel (or the plain version) runs once on this rank's shards,
exactly as it runs unsharded, and the result is wrapped back. rmsnorm keeps
rows sharded; flash keeps batch and heads sharded (``heads`` over
``model``, as ``repro/models/attention.py:120-122`` sets them), ssd_scan
batch and ``ssm_heads``; every other sharded dim is gathered. K/V (or the B/C
groups) that cannot follow q's (x's) head sharding are gathered and cut to
this rank's heads locally. An input replicated over an axis on which the
result is sharded gets a partial gradient there (the rmsnorm scale, such
K/V or B/C). The counts in ``LAUNCHES`` stay one per call.

Inside ``dry_run()`` (the dry run and ``roofline.count_step`` enter it),
every wrapper takes fake tensors only (a real one raises) and treats them
as card tensors: the kernel's own launcher checks and plans them, so its
refusals are the card's, and returns empty outputs with the kernel's
shapes, dtypes and strides without a launch; the call is recorded in the
list the context yields, and ``LAUNCHES`` is left as it was. Outside the
context a fake tensor on the card's device raises in its launcher
(``build.dry``) before any count moves; nothing else changes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.sharding import ctx

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 0,
            "rmsnorm_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The open dry run's records: (kernel name, its call's shape fields).
_DRY: Optional[List[Tuple[str, Dict[str, object]]]] = None


@contextlib.contextmanager
def dry_run():
    """Kernels planned on fake tensors, none launched; yields the list of
    (name, fields) records, one per wrapper call, in call order."""
    global _DRY
    if _DRY is not None:
        raise RuntimeError("ops.dry_run() does not nest")
    _DRY, build.DRY_RUN = [], True
    try:
        yield _DRY
    finally:
        _DRY, build.DRY_RUN = None, False


def _launched(name: str, fields) -> None:
    """One call of kernel ``name``: counted, or in a dry run recorded with
    ``fields()``, its call's shape fields (built only then: the wrappers
    sit on every decode step's host path)."""
    if _DRY is None:
        LAUNCHES[name] += 1
    else:
        _DRY.append((name, fields()))


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _attn_fields(q, k, v, causal, prefix_len, **more):
    B, H, Sq, D = q.shape
    return dict(B=B, H=H, KH=k.shape[1], Sq=Sq, Sk=k.shape[2], D=D, Dv=v.shape[3],
                dtype=_dtype(q), causal=bool(causal), prefix_len=prefix_len, **more)


def _ssd_fields(x, Bm, chunk):
    Bsz, S, H, P = x.shape
    return dict(B=Bsz, S=S, H=H, G=Bm.shape[2], P=P, N=Bm.shape[3], chunk=chunk,
                bc_dtype=_dtype(Bm))


def _on_card(*ts: torch.Tensor) -> bool:
    if _DRY is not None:
        if not all(build.is_fake(t) for t in ts):
            raise RuntimeError("inside ops.dry_run() the kernels take fake tensors "
                               "only: a real tensor would run its plain version")
        return True
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise RuntimeError(f"tensors on {sorted(kinds)}: the kernels take "
                           "CUDA tensors and the plain versions CPU tensors")
    return True


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if _on_card(x, scale):
            out = rmsnorm_cuda(x, scale, eps)
            _launched("rmsnorm", lambda: dict(R=x.shape[0], D=x.shape[1], dtype=_dtype(x),
                                              scale_dtype=_dtype(scale)))
            return out
        return ref.reference_rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if _on_card(x, scale, dy):
            dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, ctx.eps)
            _launched("rmsnorm_bwd", lambda: dict(R=x.shape[0], D=x.shape[1],
                                                  dtype=_dtype(x), scale_dtype=_dtype(scale)))
        else:
            dx, dscale = ref.reference_rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D); scale: (D,). Returns (R, D) in x.dtype, fp32 math."""
    if ctx.is_dtensor(x):
        keep = _kept(x, (0,))
        (xl, sl), out = enter_local([(x, keep, None), (scale, _none(keep), _partial(keep))],
                                    keep)
        return out(_RMSNormFn.apply(xl, sl, eps))
    return _RMSNormFn.apply(x, scale, eps)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          return_lse: bool = False, prefix_len: int = 0):
    """The plain version of ``flash_attention`` in the 4-D model layout, on
    any device: K/V heads repeated for GQA, then ``ref.reference_attention``.
    ``return_lse`` also returns the (B, H, Sq) fp32 logsumexp."""
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    k = k.repeat_interleave(H // KH, dim=1)
    v = v.repeat_interleave(H // KH, dim=1)
    o = ref.reference_attention(q.reshape(B * H, Sq, D),
                                k.reshape(B * H, Sk, D),
                                v.reshape(B * H, Sk, Dv), causal=causal,
                                return_lse=return_lse, prefix_len=prefix_len)
    if return_lse:
        return o[0].reshape(B, H, Sq, Dv), o[1].reshape(B, H, Sq)
    return o.reshape(B, H, Sq, Dv)


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len):
        if _on_card(q, k, v):
            fa.plan_bwd(q, k, v, prefix_len)      # refuse before the forward runs
            o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True,
                                             prefix_len=prefix_len)
            _launched("flash_attention",
                      lambda: _attn_fields(q, k, v, causal, prefix_len, lse=True))
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                           prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_card(q, k, v, do):
            if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not fa.rows_16b(do)):
                do = do.contiguous()              # a layout the kernel reads by rows
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, ctx.causal,
                                                ctx.prefix_len)
            _launched("flash_attention_bwd",
                      lambda: _attn_fields(q, k, v, ctx.causal, ctx.prefix_len))
        else:
            grads = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                                prefix_len=ctx.prefix_len)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """Attention with scale D^-0.5 and, under ``causal``, the prefix-LM mask
    of ``models/attention.py::_block_attn`` on the row indices: key j is
    valid for row i iff j <= i or j < ``prefix_len``. ``prefix_len`` 0 is
    the plain causal mask (qpos >= kpos); a prefix of Sk or more makes every
    key valid, which is the same mask as ``causal=False`` (an encoder), and
    goes to that mode of the kernels.

    Either the Pallas contract, q/k (BH, S, D) and v (BH, S, Dv), or the model
    layout, q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv) with KH
    dividing H. Returns q's leading dims with Dv.
    """
    fa._check_prefix(prefix_len)
    if ctx.is_dtensor(q):
        return _split_heads(flash_attention, (q, k, v), 1,
                            dict(causal=causal, prefix_len=prefix_len))
    three_d = q.dim() == 3
    if three_d:
        q, k, v = q[:, None], k[:, None], v[:, None]
    if not causal or prefix_len >= k.shape[2]:
        causal, prefix_len = False, 0
    if _needs_grad(q, k, v):
        o = _FlashAttentionFn.apply(q, k, v, causal, prefix_len)
    elif _on_card(q, k, v):
        o = fa.flash_attention_cuda(q, k, v, causal, prefix_len=prefix_len)
        _launched("flash_attention",
                  lambda: _attn_fields(q, k, v, causal, prefix_len, lse=False))
    else:
        o = flash_attention_plain(q, k, v, causal=causal, prefix_len=prefix_len)
    return o[:, 0] if three_d else o


def ssd_scan_plain(x, dA, Bm, Cm, *, chunk: int):
    """The plain version of ``ssd_scan`` in the model layout, on any device.

    The chunk loop of ``repro/models/ssm.py::ssd_chunked``, with one chunk's
    (Q x Q) term live at a time; B and C are viewed per group, not repeated.
    ``chunk`` divides S. Returns (y (Bsz,S,H,P) in x.dtype, state (Bsz,H,N,P)
    fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    x32 = x.float().reshape(Bsz, S, G, R, P)
    a32 = dA.float().reshape(Bsz, S, G, R)
    B32, C32 = Bm.float(), Cm.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, G, R, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        a_k, x_k = a32[:, c0:c0 + chunk], x32[:, c0:c0 + chunk]
        B_k, C_k = B32[:, c0:c0 + chunk], C32[:, c0:c0 + chunk]
        cum = a_k.cumsum(dim=1)                                  # (B,Q,G,R)
        seg = cum[:, :, None] - cum[:, None]                     # (B,Qt,Qs,G,R)
        Lmat = torch.where(tri[None, :, :, None, None], seg.exp(), 0.0)
        CB = torch.einsum("btgn,bsgn->bgts", C_k, B_k)
        y = torch.einsum("bgts,btsgr,bsgrp->btgrp", CB, Lmat, x_k)
        y = y + torch.einsum("btgn,btgr,bgrnp->btgrp", C_k, cum.exp(), state)
        decay_to_end = (cum[:, -1:] - cum).exp()                 # (B,Q,G,R)
        s_chunk = torch.einsum("bsgn,bsgr,bsgrp->bgrnp", B_k, decay_to_end, x_k)
        state = state * cum[:, -1].exp()[..., None, None] + s_chunk
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(Bsz, S, H, P).to(x.dtype)
    return y, state.reshape(Bsz, H, N, P)


class _SSDScanFn(torch.autograd.Function):
    """(x fp32, dA, B, C) -> (y fp32, final state fp32) in the model layout.
    The final state's gradient is None where it is not used (it is not
    materialised), and the backward then takes zero for it."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if _on_card(x, dA, Bm, Cm):
            y, state, cum, states = ssd_scan_cuda(x, dA, Bm, Cm, chunk, True)
            _launched("ssd_scan", lambda: _ssd_fields(x, Bm, chunk))
            ctx.save_for_backward(x, dA, Bm, Cm, cum, states, state)
        else:
            y, state = ssd_scan_plain(x, dA, Bm, Cm, chunk=chunk)
            ctx.save_for_backward(x, dA, Bm, Cm)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dA, Bm, Cm, *scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if _on_card(x, dA, Bm, Cm, dy):
            cum, states, state = scratch
            dx, ddA, dB, dC = ssd_scan_bwd_cuda(x, dA, Bm, Cm, ctx.chunk, cum, states,
                                                state, dy, dstate)
            _launched("ssd_scan_bwd",
                      lambda: dict(_ssd_fields(x, Bm, ctx.chunk), dstate=dstate is not None))
        else:
            dx, ddA, dB, dC = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, dstate, chunk=ctx.chunk)
        return dx, ddA, dB, dC, None


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128, return_state: bool = False):
    """Mamba2 SSD chunked scan; ``chunk`` (capped at S) must divide S.

    Either the Pallas contract, x (BH, S, P), dA (BH, S), Bm/Cm (BH, S, N), or
    the model layout, x (Bsz, S, H, P), dA (Bsz, S, H), Bm/Cm (Bsz, S, G, N)
    with G dividing H (head h reads group h // (H // G)). x is already
    dt-scaled and dA holds the log-decays. Returns y in x's layout and dtype
    and, with ``return_state``, also the final state in fp32: (BH, N, P) or
    (Bsz, H, N, P).
    """
    if ctx.is_dtensor(x):
        return _split_heads(ssd_scan, (x, dA, Bm, Cm), 2,
                            dict(chunk=chunk, return_state=return_state),
                            state_heads=1 if return_state else None)
    three_d = x.dim() == 3
    if three_d:
        x, dA, Bm, Cm = x[:, :, None], dA[:, :, None], Bm[:, :, None], Cm[:, :, None]
    S = x.shape[1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} must divide the sequence length {S}")
    if _needs_grad(x, dA, Bm, Cm):
        # the kernels take x in fp32, as the model hands it over; the casts
        # stay outside the Function, so autograd carries them
        y, state = _SSDScanFn.apply(x.float(), dA, Bm, Cm, Q)
        y = y.to(x.dtype)
    elif _on_card(x, dA, Bm, Cm):
        y, state, _, _ = ssd_scan_cuda(x.float(), dA, Bm, Cm, Q, return_state)
        y = y.to(x.dtype)
        _launched("ssd_scan", lambda: _ssd_fields(x, Bm, Q))
    else:
        y, state = ssd_scan_plain(x, dA, Bm, Cm, chunk=Q)
    if three_d:
        y, state = y[:, :, 0], state[:, 0] if state is not None else None
    return (y, state) if return_state else y


# ---------------------------------------------------------------------------
# the kernel boundary under a mesh
# ---------------------------------------------------------------------------

def _kept(x, dims):
    """x's placements with a Shard of one of ``dims`` kept and every other
    placement (another dim's Shard, a Partial) turned to Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]


def _none(placements):
    from torch.distributed.tensor import Replicate
    return [Replicate()] * len(placements)


def _partial(placements):
    """Partial where the result is sharded (the local gradient of an input
    replicated there covers this rank's shard only), Replicate elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(p, Shard) else Replicate() for p in placements]


def enter_local(args, out_placements):
    """[(tensor, placements, grad placements or None)] -> (the local shards,
    a function wrapping a local result as a DTensor with ``out_placements``).
    A plain tensor among the args is one every rank holds in full."""
    from torch.distributed.tensor import DTensor
    mesh = args[0][0].device_mesh
    local = []
    for t, pl, gpl in args:
        if not ctx.is_dtensor(t):
            t = DTensor.from_local(t, mesh, _none(pl), run_check=False)
        t = t.redistribute(mesh, pl)
        local.append(t.to_local(grad_placements=gpl) if gpl is not None else t.to_local())

    def out(y, placements=out_placements):
        return DTensor.from_local(y, mesh, placements, run_check=False)
    return local, out


def _split_heads(fn, args, head_dim, kwargs, state_heads=None):
    """``fn`` on local shards of (q, k, v) / (x, dA, B, C): batch (dim 0) and
    heads (``head_dim``) stay sharded as the first input has them. An input
    of lower rank (dA) takes the same placements; the others (K/V heads, B/C
    groups, on ``head_dim`` too) follow where their count divides the
    shards, else they are gathered and expanded to this rank's heads, with a
    partial gradient over the head axes. ``state_heads``: the head dim of a
    second output (ssd_scan's final state), sharded as the heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    first = args[0]
    main = _kept(first, (0, head_dim))
    mesh = first.device_mesh
    sizes = list(mesh.mesh.shape)
    head_axes = [i for i, p in enumerate(main) if isinstance(p, Shard) and p.dim == head_dim]
    n_shards = 1
    for i in head_axes:
        n_shards *= sizes[i]
    H = first.shape[head_dim]
    batch_only = [p if i not in head_axes else Replicate() for i, p in enumerate(main)]
    entries, groups = [(first, main, None)], []
    for t in args[1:]:
        if t.dim() < first.dim() or t.shape[head_dim] % n_shards == 0:
            entries.append((t, main, None))
            groups.append(None)
        else:
            entries.append((t, batch_only, [Partial() if i in head_axes else p
                                            for i, p in enumerate(batch_only)]))
            groups.append(t.shape[head_dim])
    local, out = enter_local(entries, main)
    if any(g is not None for g in groups):
        h_loc = local[0].shape[head_dim]
        h0 = ctx.local_slices(first.shape, mesh, main)[head_dim].start
        for j, n in enumerate(groups):
            if n is not None:                       # this rank's heads' groups
                t = local[j + 1].repeat_interleave(H // n, dim=head_dim)
                local[j + 1] = t.narrow(head_dim, h0, h_loc)
    res = fn(*local, **kwargs)
    if state_heads is None:
        return out(res)
    y, state = res
    spl = [Shard(state_heads) if i in head_axes else p for i, p in enumerate(main)]
    return out(y), out(state, spl)
