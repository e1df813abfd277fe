// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (body _rmsnorm_kernel,
// pallas_call at rmsnorm.py:32). Computes, for each row of an (R, D) array,
//     y = x * rsqrt(mean(x^2) + eps) * scale
// in fp32, and writes y in x's type. x is float32 or bfloat16; scale is
// float32 or bfloat16, independently.
//
// What bounds it: device memory. Each element is read once and written once
// (about 4*R*D bytes in bf16) against ~4 flops, far below the H100's
// ~295 flop/byte ridge, so what matters is keeping enough 16-byte loads in
// flight and spending nothing else per row.
//
// Three paths; the launcher (kernels/rmsnorm.py::plan) picks one and the
// launch shape, and this file checks that the shape holds the row:
//
// - warp_per_row (a row of at most 8 KB, x and scale alike: bf16 D <= 4096,
//   fp32 D <= 2048): one warp per row, four warps a block, a grid-stride
//   loop over rows with the grid sized to the SMs. Each lane holds up to 16
//   vectors of 16 bytes of the row in registers between the sum of squares
//   and the scaling; the sum is reduced by warp shuffles alone. There is no
//   shared memory and no block barrier. Each warp loads its lanes' part of
//   `scale` once, in vectors, and keeps it in registers for every row it
//   takes.
//   Where a lane holds at most 8 vectors, the next row's loads go out
//   before the current row is scaled.
// - block_per_row (wider rows, up to 8192, and too few rows to give each SM
//   two, as in decode, where one row's latency is the time): the same with
//   256 threads a row, the row in registers across the block's warps and the
//   warps' sums added through shared memory.
// - scalar (D or a pointer does not allow 16-byte accesses): one block per
//   row, element by element, the row staged in shared memory as fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 8192;
constexpr int kWarpBlock = 128;     // warp_per_row: four rows a block
constexpr int kRowBlock = 256;      // block_per_row and scalar: one row a block

// Path codes shared with kernels/rmsnorm.py.
constexpr int kWarpPerRow = 0;
constexpr int kBlockPerRow = 1;
constexpr int kScalar = 2;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC values of T read or written as one access (16 bytes of x; scale's
// matching VEC values take 8, 16 or 32 bytes).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC >= 16 ? 16 : sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Rows of `dim` values; ROW_THREADS threads (a warp or the block) share a row
// and each holds up to VPT vectors of VEC values of it, vector i of the row
// at thread i % ROW_THREADS. Rows go round the grid-stride loop. The warp
// path loads the next row while it scales the current one (PREFETCH).
template <typename TX, typename TS, int VPT, int ROW_THREADS, bool PREFETCH>
__global__ void __launch_bounds__(ROW_THREADS == 32 ? kWarpBlock : kRowBlock)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   TX* __restrict__ out, int rows, int dim, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int BLOCK = ROW_THREADS == 32 ? kWarpBlock : kRowBlock;
  constexpr int ROWS_PER_BLOCK = BLOCK / ROW_THREADS;
  __shared__ float warp_sums[ROW_THREADS == 32 ? 1 : kRowBlock / 32];

  const int lane = threadIdx.x % ROW_THREADS;
  const int nvec = dim / VEC;
  using XV = Vec<TX, VEC>;
  using SV = Vec<TS, VEC>;

  SV sv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = i * ROW_THREADS + lane;
    if (v < nvec) sv[i] = reinterpret_cast<const SV*>(scale)[v];
  }

  const int row_step = gridDim.x * ROWS_PER_BLOCK;
  int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_THREADS;
  XV xv[VPT];
  auto load_row = [&](XV (&dst)[VPT], int r) {
    const XV* xr = reinterpret_cast<const XV*>(x + static_cast<int64_t>(r) * dim);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = i * ROW_THREADS + lane;
      if (v < nvec) dst[i] = xr[v];
    }
  };
  if constexpr (PREFETCH) {
    if (row < rows) load_row(xv, row);
  }
  for (; row < rows; row += row_step) {
    XV nx[PREFETCH ? VPT : 1];
    if constexpr (PREFETCH) {             // the next row's loads go out now
      if (row + row_step < rows) load_row(nx, row + row_step);
    } else {
      const XV* xr = reinterpret_cast<const XV*>(x + static_cast<int64_t>(row) * dim);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = i * ROW_THREADS + lane;
        if (v < nvec) xv[i] = xr[v];
      }
    }
    // one partial sum per vector, so the adds do not form one long chain
    float part[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      part[i] = 0.f;
      if (i * ROW_THREADS + lane < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f(xv[i].v[j]);
          part[i] = fmaf(f, f, part[i]);
        }
      }
    }
#pragma unroll
    for (int w = 1; w < VPT; w <<= 1)
#pragma unroll
      for (int i = 0; i + w < VPT; i += 2 * w) part[i] += part[i + w];
    float ss = part[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (ROW_THREADS != 32) {
      if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < kRowBlock / 32; ++w) ss += warp_sums[w];
      __syncthreads();                 // warp_sums is rewritten for the next row
    }
    const float rstd = rsqrtf(ss / static_cast<float>(dim) + eps);
    if constexpr (VPT > 8) {
      // An empty asm that may change the packed scale: without it the compiler
      // hoists the scale's fp32 conversion out of the row loop, which at 16
      // vectors of bf16 takes 128 more registers and spills.
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        uint32_t* words = reinterpret_cast<uint32_t*>(&sv[i]);
#pragma unroll
        for (int k = 0; k < static_cast<int>(sizeof(SV) / 4); ++k) asm volatile("" : "+r"(words[k]));
      }
    }
    XV* outr = reinterpret_cast<XV*>(out + static_cast<int64_t>(row) * dim);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = i * ROW_THREADS + lane;
      if (v < nvec) {
        XV o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<TX>(to_f(xv[i].v[j]) * rstd * to_f(sv[i].v[j]));
        outr[v] = o;
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) xv[i] = nx[i];
    }
  }
}

// The scalar path: one block per row, one element per access.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kRowBlock)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                      TX* __restrict__ out, int dim, float eps) {
  extern __shared__ float row[];                 // dim fp32 values
  __shared__ float warp_sums[kRowBlock / 32];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * dim;
  const TX* xr = x + base;
  TX* outr = out + base;

  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += kRowBlock) {
    const float f = to_f(xr[i]);
    row[i] = f;
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kRowBlock / 32; ++w) total += warp_sums[w];
  const float rstd = rsqrtf(total / static_cast<float>(dim) + eps);
  for (int i = threadIdx.x; i < dim; i += kRowBlock)
    outr[i] = from_f<TX>(row[i] * rstd * to_f(scale[i]));
}

// The warp path prefetches where the scale is no wider than x and a lane
// holds at most 8 vectors: the registers of a second row then fit beside it
// (about 120). With 16 vectors the prefetching kernel took 224 registers and
// ran 1.5x slower on the H100 (NVIDIA H100 80GB HBM3, 700 W,
// scripts/flash_variants.py --kernel rmsnorm).
template <typename TX, typename TS, int VPT, int ROW_THREADS>
cudaError_t launch_vec(const TX* x, const TS* s, TX* o, int rows, int dim,
                       float eps, int grid, cudaStream_t stream) {
  constexpr bool kPrefetch = ROW_THREADS == 32 && sizeof(TS) <= sizeof(TX) && VPT <= 8;
  rmsnorm_vec_kernel<TX, TS, VPT, ROW_THREADS, kPrefetch>
      <<<grid, ROW_THREADS == 32 ? kWarpBlock : kRowBlock, 0, stream>>>(x, s, o, rows, dim, eps);
  return cudaGetLastError();
}

template <typename TX, typename TS, int ROW_THREADS>
cudaError_t dispatch_vpt(const TX* x, const TS* s, TX* o, int rows, int dim,
                         float eps, int grid, int vpt, cudaStream_t stream) {
  // The most vectors a thread can need: rows up to 8 KB of x and of scale on
  // the warp path, up to kMaxDim on the block path.
  constexpr int kWide = sizeof(TS) > sizeof(TX) ? sizeof(TS) : sizeof(TX);
  constexpr int kMaxVpt = ROW_THREADS == 32
      ? 8192 / kWide / (16 / sizeof(TX)) / 32
      : kMaxDim / (16 / sizeof(TX)) / kRowBlock;
  switch (vpt) {
    case 1: return launch_vec<TX, TS, 1, ROW_THREADS>(x, s, o, rows, dim, eps, grid, stream);
    case 2: return launch_vec<TX, TS, 2, ROW_THREADS>(x, s, o, rows, dim, eps, grid, stream);
    case 4: return launch_vec<TX, TS, 4, ROW_THREADS>(x, s, o, rows, dim, eps, grid, stream);
    case 8:
      if constexpr (kMaxVpt >= 8)
        return launch_vec<TX, TS, 8, ROW_THREADS>(x, s, o, rows, dim, eps, grid, stream);
      return cudaErrorInvalidValue;
    case 16:
      if constexpr (kMaxVpt >= 16)
        return launch_vec<TX, TS, 16, ROW_THREADS>(x, s, o, rows, dim, eps, grid, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int dim, float eps, int path, int grid, int vpt,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  TX* op = static_cast<TX*>(out);
  if (path == kScalar) {
    rmsnorm_scalar_kernel<TX, TS><<<rows, kRowBlock, dim * sizeof(float), stream>>>(
        xp, sp, op, dim, eps);
    return cudaGetLastError();
  }
  // The vector paths: 16-byte rows and pointers, and a shape that holds the row.
  const int row_threads = path == kWarpPerRow ? 32 : kRowBlock;
  const bool aligned = dim % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (!aligned || grid < 1 || dim / kVec > vpt * row_threads) return cudaErrorInvalidValue;
  if (path == kWarpPerRow)
    return dispatch_vpt<TX, TS, 32>(xp, sp, op, rows, dim, eps, grid, vpt, stream);
  return dispatch_vpt<TX, TS, kRowBlock>(xp, sp, op, rows, dim, eps, grid, vpt, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. path: 0 warp_per_row,
// 1 block_per_row, 2 scalar; `grid` and `vpt` (16-byte vectors per thread)
// are the vector paths' launch shape. Returns a cudaError_t as int.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int dim, float eps, int x_dtype,
                           int scale_dtype, int path, int grid, int vpt,
                           void* stream) {
  if (dim < 1 || dim > kMaxDim || rows < 0 || x_dtype < 0 || x_dtype > 1 ||
      scale_dtype < 0 || scale_dtype > 1 || path < 0 || path > 2) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, dim, eps, path, grid, vpt, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, dim, eps, path, grid, vpt, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, dim, eps, path, grid, vpt, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, dim, eps, path, grid, vpt, s);
}
