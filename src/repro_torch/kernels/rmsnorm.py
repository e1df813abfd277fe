"""Fused RMSNorm on Hopper: the launcher of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``. Any row
count is taken, rows up to ``MAX_DIM`` wide. ``plan`` picks one of the
kernel's three paths and its launch shape, on any device:

- ``warp_per_row``: one warp per row, the row and the warp's part of
  ``scale`` in registers, a grid-stride loop over rows with the grid sized
  to the SMs, the next row loaded while the current one is scaled where a
  lane holds at most 8 vectors; rows of at most 8 KB (bf16 D <= 4096, fp32
  D <= 2048, for x and scale alike);
- ``block_per_row``: 256 threads per row, for wider rows, and for fewer
  rows than ``FEW_ROWS_PER_SM`` per SM (decode), where one row's latency,
  not bandwidth, is the time and 256 threads shorten it;
- ``scalar``: one block per row, element by element, where D or a pointer
  does not allow 16-byte accesses.

The plain version is ``ref.reference_rmsnorm``; ``ops.rmsnorm`` picks
between them. ``PLAN`` is the plan of the last launch.

``rmsnorm_bwd_cuda`` launches the backward (``rmsnorm_bwd``): dx per row,
and dscale in two deterministic stages, per-block fp32 partials, then a
reduction over the blocks in a fixed order. ``plan_bwd`` picks its path and
grid, on any device:

- ``warp_per_row``: one warp per row, x and dy read once into registers
  with the warp's part of ``scale``, each lane summing dscale for its own
  columns over the rows it walks, the block adding its warps in order at
  the end; x rows of at most ``BWD_WARP_ROW_BYTES`` (and scale's), and at
  least ``FEW_ROWS_PER_SM`` rows per SM;
- ``block_per_row``: 256 threads per row otherwise, up to ``MAX_DIM``;
- ``scalar``: where D or a pointer does not allow 16-byte accesses.

``PLAN_BWD`` is the plan of the last backward launch.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_DIM = 8192
H100_SMS = 132
WARP_ROW_BYTES = 8192          # the most a warp holds in registers per row
PATH_CODE = {"warp_per_row": 0, "block_per_row": 1, "scalar": 2}
THREADS = {"warp_per_row": 128, "block_per_row": 256, "scalar": 256}
ROW_THREADS = {"warp_per_row": 32, "block_per_row": 256}
FEW_ROWS_PER_SM = 2
# Grid of the vector paths, in blocks per SM, each block going round many
# rows: two where the warp path prefetches the next row (a lane holds at most
# 8 vectors and the scale is no wider than x, as ``launch_vec`` decides),
# four elsewhere. On the H100 (NVIDIA H100 80GB HBM3, 700 W) these were the
# faster of 1, 2, 3 and 4 (scripts/flash_variants.py --kernel rmsnorm
# --blocks-per-sm).
BLOCKS_PER_SM = {True: 2, False: 4}
PREFETCH_MAX_VECTORS = 8
BWD_BLOCKS_PER_SM = 2          # the backward's row blocks, each holding a dscale partial
# The most of a row of x (and of scale) a warp of the backward holds: the
# lane keeps x, dy, scale and its fp32 dscale columns in registers.
BWD_WARP_ROW_BYTES = 4096


@dataclass(frozen=True)
class Plan:
    path: str
    grid: int
    threads: int          # per block
    vectors: int          # 16-byte vectors of x each thread holds; 0 on ``scalar``


PLAN: Optional[Plan] = None
PLAN_BWD: Optional[Plan] = None


def plan(R: int, D: int, x_dtype: torch.dtype, scale_dtype: torch.dtype, *,
         aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The path and launch shape for an (R, D) x and a (D,) scale.
    ``aligned``: x, scale and the output start on 16-byte boundaries."""
    if x_dtype not in build.DTYPE_CODE or scale_dtype not in build.DTYPE_CODE:
        raise TypeError(f"rmsnorm takes float32/bfloat16, got {x_dtype}, {scale_dtype}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"rmsnorm_cuda takes 1 <= D <= {MAX_DIM}, got {D}")
    vec = 16 // x_dtype.itemsize
    if not aligned or D % vec:
        return Plan("scalar", R, THREADS["scalar"], 0)
    nvec = D // vec
    row_bytes = D * max(x_dtype.itemsize, scale_dtype.itemsize)
    path = ("warp_per_row" if row_bytes <= WARP_ROW_BYTES and R >= FEW_ROWS_PER_SM * sms
            else "block_per_row")
    per_thread = -(-nvec // ROW_THREADS[path])
    vectors = 1 << (per_thread - 1).bit_length()          # 1, 2, 4, 8 or 16
    rows_per_block = THREADS[path] // ROW_THREADS[path]
    prefetch = (path == "warp_per_row" and vectors <= PREFETCH_MAX_VECTORS
                and scale_dtype.itemsize <= x_dtype.itemsize)
    grid = min(-(-R // rows_per_block), sms * BLOCKS_PER_SM[prefetch])
    return Plan(path, max(grid, 1), THREADS[path], vectors)


@functools.lru_cache(maxsize=None)
def _sms(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index or 0).multi_processor_count


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) on a CUDA device; scale: (D,). Returns (R, D) in x.dtype."""
    global PLAN
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (R, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not x.is_cuda or scale.device != x.device:
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and scale")
    R, D = x.shape
    out = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    p = plan(R, D, x.dtype, scale.dtype, aligned=aligned,
             sms=_sms(x.device.index))
    with torch.cuda.device(x.device):
        code = build.library().lib.rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D, float(eps),
            build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[scale.dtype],
            PATH_CODE[p.path], p.grid, p.vectors, build.stream_handle(x.device))
    build.check(code, "rmsnorm_fwd")
    PLAN = p
    return out


def bwd_grid(R: int, sms: int = H100_SMS, rows_per_block: int = 1) -> int:
    """Row blocks of the backward: each takes ``rows_per_block`` rows from
    blockIdx * rows_per_block, then the same + grid * rows_per_block, ..."""
    return max(1, min(-(-R // rows_per_block), sms * BWD_BLOCKS_PER_SM))


def plan_bwd(R: int, D: int, x_dtype: torch.dtype, scale_dtype: torch.dtype, *,
             aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The backward's path and launch shape for an (R, D) x and dy and a (D,)
    scale. ``aligned``: x, dy, dx and scale start on 16-byte boundaries."""
    if x_dtype not in build.DTYPE_CODE or scale_dtype not in build.DTYPE_CODE:
        raise TypeError(f"rmsnorm_bwd takes float32/bfloat16, got {x_dtype}, {scale_dtype}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"rmsnorm_bwd_cuda takes 1 <= D <= {MAX_DIM}, got {D}")
    vec = 16 // x_dtype.itemsize
    if not aligned or D % vec:
        return Plan("scalar", bwd_grid(R, sms), THREADS["scalar"], 0)
    row_bytes = D * max(x_dtype.itemsize, scale_dtype.itemsize)
    path = ("warp_per_row" if row_bytes <= BWD_WARP_ROW_BYTES and R >= FEW_ROWS_PER_SM * sms
            else "block_per_row")
    per_thread = -(-(D // vec) // ROW_THREADS[path])
    vectors = 1 << (per_thread - 1).bit_length()          # 1, 2, 4 or 8
    grid = bwd_grid(R, sms, THREADS[path] // ROW_THREADS[path])
    return Plan(path, grid, THREADS[path], vectors)


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5):
    """x, dy: (R, D) on a CUDA device, dy in x's dtype; scale: (D,). Returns
    (dx in x.dtype, dscale in scale.dtype); rstd is recomputed from x."""
    if x.dim() != 2 or scale.shape != (x.shape[1],) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd takes x and dy (R, D) and scale (D,), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)} and {tuple(scale.shape)}")
    if x.dtype not in build.DTYPE_CODE or scale.dtype not in build.DTYPE_CODE:
        raise TypeError(f"rmsnorm_bwd takes float32/bfloat16, got {x.dtype}, {scale.dtype}")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy must be {x.dtype}, got {dy.dtype}")
    if not (x.is_cuda and scale.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda needs x, scale and dy on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda needs contiguous x, scale and dy")
    global PLAN_BWD
    R, D = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy, dx))
    p = plan_bwd(R, D, x.dtype, scale.dtype, aligned=aligned, sms=_sms(x.device.index))
    partials = torch.empty((p.grid, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = build.library().lib.rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partials.data_ptr(), dscale.data_ptr(), R, D, float(eps),
            build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[scale.dtype], p.grid,
            PATH_CODE[p.path], p.vectors, build.stream_handle(x.device))
    build.check(code, "rmsnorm_bwd")
    PLAN_BWD = p
    return dx, dscale
