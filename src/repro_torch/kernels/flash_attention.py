"""Flash-attention forward on Hopper: the launcher of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``
and, on the model path, ``models/attention.py::blockwise_attention``. It takes
the model layout directly: q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv),
each through its strides with a unit last stride, so the transposed views the
model makes are not copied and GQA needs no repeated K/V. Any Sq and Sk.

Two routes, chosen by dtype alone, with no fallback between them:

- bfloat16 runs on the tensor cores (``flash_attention_fwd_bf16``: wgmma fed by
  a cp.async ring). D and Dv must be multiples of 16 up to 256; they are
  zero-padded to the smallest instantiated tile pair in ``BF16_TILES``. Every
  tensor must start 16-byte aligned with strides in multiples of 8 elements,
  because the kernel copies rows 16 bytes at a time.
- float32 runs on the CUDA cores (``flash_attention_fwd_f32``) in exact fp32
  products: TF32 on the tensor cores would break the fp32 tolerance.

``ROUTE`` names the route of the last launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# (D, Dv) tile widths the bf16 kernel is built for, smallest first.
BF16_TILES = ((64, 64), (128, 128), (192, 128), (256, 256))

ROUTE: Optional[str] = None


def bf16_tile(D: int, Dv: int) -> Tuple[int, int]:
    """The smallest instantiated (D, Dv) tile pair that holds D and Dv."""
    if D % 16 or Dv % 16 or D < 1 or Dv < 1:
        raise ValueError(f"the bf16 kernel takes head dims in multiples of 16, "
                         f"got D {D}, Dv {Dv}")
    for d, dv in BF16_TILES:
        if D <= d and Dv <= dv:
            return d, dv
    raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got D {D}, Dv {Dv}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Checks what the kernels take, on any device; returns (route, tile), the
    tile None on the fp32 route. Raises on what no route takes."""
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
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in _strides(t)):
            raise ValueError("the bf16 kernel copies 16-byte rows: it needs "
                             "16-byte aligned tensors with strides in multiples "
                             f"of 8, got strides {t.stride()}")
    return ROUTES[q.dtype], tile


def _strides(t: torch.Tensor):
    """Batch, head and row strides; 0 for a dim of size 1, never stepped over."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Returns a contiguous (B, H, Sq, Dv) in q.dtype; scale D^-0.5."""
    global ROUTE
    route, tile = plan(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KH, Sq, Sk, D, Dv,
            *_strides(q), *_strides(k), *_strides(v), D ** -0.5, int(causal)]
    name = "flash_attention_fwd_bf16" if tile else "flash_attention_fwd_f32"
    fn = getattr(build.library().lib, name)
    with torch.cuda.device(q.device):
        code = fn(*args, *(tile or ()), build.stream_handle(q.device))
    build.check(code, name)
    ROUTE = route
    return o
