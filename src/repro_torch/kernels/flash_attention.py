"""Flash-attention forward on Hopper: the launcher of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``
and, on the model path, ``models/attention.py::blockwise_attention``. It takes
the model layout directly: q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv),
each through its strides with a unit last stride, so the transposed views the
model makes are not copied and GQA needs no repeated K/V. Any Sq and Sk.

The mask is ``models/attention.py::_block_attn``'s: with ``causal``, key j
is valid for row i iff j <= i or j < ``prefix_len`` (the vlm family's
prefix-LM mask; 0 is the plain causal mask); without it every key is valid.

Two routes, chosen by dtype alone, with no fallback between them:

- bfloat16 runs on the tensor cores (``flash_attention_fwd_bf16``: wgmma fed by
  a cp.async ring). D and Dv must be multiples of 16 up to 256; they are
  zero-padded to the smallest instantiated tile pair in ``BF16_TILES``. Every
  tensor must start 16-byte aligned with strides in multiples of 8 elements,
  because the kernel copies rows 16 bytes at a time.
- float32 runs on the CUDA cores (``flash_attention_fwd_f32``) in exact fp32
  products: TF32 on the tensor cores would break the fp32 tolerance.

``flash_attention_cuda(..., return_lse=True)`` also writes each row's fp32
logsumexp of the scaled scores, (B, H, Sq), in natural-log units, which
``flash_attention_bwd_cuda`` reads. The backward takes D and Dv up to
``MAX_BWD_HEAD_DIM``, by dtype as the forward: bf16 on the tensor cores
(``flash_attention_bwd_bf16``: wgmma fed by cp.async rings; D and Dv
multiples of 16, padded to the tile of ``BWD_TILES``; 16-byte rows of q, k,
v, o and do), fp32 on the CUDA cores (``flash_attention_bwd_f32``). The
padding is exact: the tile loads zero-fill the columns past D and Dv and
the stores stop at them, so MLA's 192/128 runs on the width-256 tile.
``plan_bwd`` checks what it takes on any device and names its route and
tile. It returns dq, dk, dv with the strides of q, k, v where those are
dense, so the model's transposed views get their gradients in their own
layout.

``ROUTE`` names the route of the last forward launch, ``BWD_ROUTE`` the
route and tile of the last backward launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 256       # stablelm 64, mistral-nemo 128, MLA 192/128, paligemma 256
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# (D, Dv) tile widths the bf16 kernel is built for, smallest first.
BF16_TILES = ((64, 64), (128, 128), (192, 128), (256, 256))
# The bf16 backward's tiles: the width D and Dv are padded to, and the q rows
# its dK/dV block takes a step (wgmma N; 32 at width 128 and 256 keeps a
# warpgroup's dK and dV accumulators in registers). Up to width 128 a dK/dV
# block owns BWD_KEYS keys, 64 a warpgroup; a dQ block BWD_Q_ROWS q rows
# over key tiles of BWD_KEY_TILE. At width 256 both warpgroups of a dK/dV
# block take the same BWD_WIDE_KEYS keys, each owning half the width of dK
# and dV, and the dQ key tiles hold BWD_WIDE_KEY_TILE keys (``bwd_blocks``).
BWD_TILES = ((64, 64), (128, 32), (256, 32))
BWD_KEYS, BWD_Q_ROWS, BWD_KEY_TILE = 128, 128, 64
BWD_WIDE_KEYS, BWD_WIDE_KEY_TILE = 64, 32
# Above this width the backward runs the width-256 tile.
WIDE_BWD_FROM = 128

ROUTE: Optional[str] = None
BWD_ROUTE: Optional[Tuple[str, Optional[Tuple[int, int]]]] = None


def bf16_tile(D: int, Dv: int) -> Tuple[int, int]:
    """The smallest instantiated (D, Dv) tile pair that holds D and Dv."""
    if D % 16 or Dv % 16 or D < 1 or Dv < 1:
        raise ValueError(f"the bf16 kernel takes head dims in multiples of 16, "
                         f"got D {D}, Dv {Dv}")
    for d, dv in BF16_TILES:
        if D <= d and Dv <= dv:
            return d, dv
    raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got D {D}, Dv {Dv}")


def _check_prefix(prefix_len: int) -> None:
    if not isinstance(prefix_len, int) or prefix_len < 0:
        raise ValueError(f"prefix_len must be an int >= 0, got {prefix_len!r}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_len: int = 0):
    """Checks what the kernels take, on any device; returns (route, tile), the
    tile None on the fp32 route. Raises on what no route takes."""
    _check_prefix(prefix_len)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda takes 4-D q, k, v")
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, KH, Sk, D) or v.shape[:3] != (B, KH, Sk)
            or H % KH != 0 or Sk < 1):
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got {D}, {Dv}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs a unit last stride")
    if q.dtype != torch.bfloat16:
        return ROUTES[q.dtype], None
    tile = bf16_tile(D, Dv)
    _check_rows_16b(q, k, v)
    return ROUTES[q.dtype], tile


def _strides(t: torch.Tensor):
    """Batch, head and row strides; 0 for a dim of size 1, never stepped over."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def rows_16b(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels can copy ``t``'s rows 16 bytes at a time."""
    return build.aligned16(t) and all(st % 8 == 0 for st in _strides(t))


def _check_rows_16b(*ts: torch.Tensor) -> None:
    for t in ts:
        if not rows_16b(t):
            raise ValueError("the bf16 kernels copy 16-byte rows: they need "
                             "16-byte aligned tensors with strides in multiples "
                             f"of 8, got strides {t.stride()}")


def _check_bwd_dims(D: int, Dv: int) -> None:
    if D > MAX_BWD_HEAD_DIM or Dv > MAX_BWD_HEAD_DIM:
        raise ValueError(f"the flash backward takes head dims up to {MAX_BWD_HEAD_DIM}, "
                         f"got D {D}, Dv {Dv}")


def bwd_tile(D: int, Dv: int) -> Tuple[int, int]:
    """The bf16 backward's (width, q rows per dK/dV step) for D and Dv."""
    _check_bwd_dims(D, Dv)
    return next((width, q_step) for width, q_step in BWD_TILES
                if D <= width and Dv <= width)


def bwd_blocks(width: int) -> Tuple[int, int]:
    """(keys of a dK/dV block, keys of a dQ key tile) at a ``bwd_tile`` width."""
    if width > WIDE_BWD_FROM:
        return BWD_WIDE_KEYS, BWD_WIDE_KEY_TILE
    return BWD_KEYS, BWD_KEY_TILE


def plan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_len: int = 0):
    """Checks, on any device, that the backward kernels take these inputs
    (the forward's checks, then D and Dv up to ``MAX_BWD_HEAD_DIM``);
    returns (route, tile), the tile ``bwd_tile``'s, None on the fp32 route."""
    _check_prefix(prefix_len)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_bwd_cuda takes 4-D q, k, v")
    D, Dv = q.shape[3], v.shape[3]
    _check_bwd_dims(D, Dv)
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and (D % 16 or Dv % 16):
        raise ValueError(f"the bf16 backward takes head dims in multiples of 16, "
                         f"got D {D}, Dv {Dv}")
    B, H, Sq, _ = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if (k.shape != (B, KH, Sk, D) or v.shape[:3] != (B, KH, Sk)
            or H % KH != 0 or Sk < 1):
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype != torch.bfloat16:
        return ROUTES[q.dtype], None
    return ROUTES[q.dtype], bwd_tile(D, Dv)


def _one_card(*ts: torch.Tensor) -> None:
    if not build.on_card(*ts):
        raise ValueError("the flash kernels need every tensor on one CUDA device")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False,
                         prefix_len: int = 0):
    """Returns a contiguous (B, H, Sq, Dv) in q.dtype; scale D^-0.5. With
    ``return_lse``, (o, lse) with lse (B, H, Sq) fp32, natural-log units."""
    global ROUTE
    route, tile = plan(q, k, v, prefix_len)
    _one_card(q, k, v)
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if build.dry(q):                           # a dry run: planned, not launched
        return (o, lse) if return_lse else o
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KH, Sq, Sk, D, Dv,
            *_strides(q), *_strides(k), *_strides(v), D ** -0.5, int(causal),
            prefix_len]
    name = "flash_attention_fwd_bf16" if tile else "flash_attention_fwd_f32"
    fn = getattr(build.library().lib, name)
    with torch.cuda.device(q.device):
        code = fn(*args, *(tile or ()), build.stream_handle(q.device))
    build.check(code, name)
    ROUTE = route
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, prefix_len: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention_cuda`` in q's dtype, from
    its output o, its lse and the output's gradient do, each read through its
    strides with a unit last stride (do may be a transposed view). Three
    launches: D = rowsum(do o o) and the lse in log2 units into an fp32
    scratch, dK/dV over key tiles (GQA summed in the block), dQ over q
    tiles."""
    global BWD_ROUTE
    route = plan_bwd(q, k, v, prefix_len)
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (B, H, Sq, Dv) or do.shape != o.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v, o, do)) or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd_cuda needs a unit last stride "
                         "and a contiguous lse")
    _one_card(q, k, v, o, lse, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        _check_rows_16b(q, k, v, o, do, dq, dk, dv)
    delta = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
    if build.dry(q):                           # a dry run: planned, not launched
        return dq, dk, dv
    name = ("flash_attention_bwd_bf16" if q.dtype == torch.bfloat16
            else "flash_attention_bwd_f32")
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in _strides(t)]
    with torch.cuda.device(q.device):
        code = getattr(build.library().lib, name)(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            B, H, KH, Sq, Sk, D, Dv, *strides, D ** -0.5, int(causal), prefix_len,
            build.stream_handle(q.device))
    build.check(code, name)
    BWD_ROUTE = route
    return dq, dk, dv
