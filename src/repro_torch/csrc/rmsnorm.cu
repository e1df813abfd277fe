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
//
// Backward (rmsnorm_bwd): the JAX package differentiates the jnp model code
// (src/repro/models/layers.py::apply_rmsnorm) and has no backward kernel;
// this one is the port's own, for training. With g = dy * scale, rstd
// recomputed from x (the forward saves nothing), and x_hat = x * rstd:
//     dx     = rstd * (g - x_hat * mean(x_hat * g))
//            = rstd * g - x * (rstd^3 * sum(x * g) / D)
//     dscale = sum over rows of dy * x_hat
// Bound by bytes like the forward: x and dy read once, dx written once
// (6*R*D bytes in bf16: 101 MB, 0.030 ms at (8192, 2048)), so the design
// reads each row once, 16 bytes an access, and keeps dscale's partial sums
// out of device memory until the end. Two launches, no atomics, so dscale
// is the same run to run:
//  1. rows, on one of three paths (kernels/rmsnorm.py::plan_bwd picks it
//     and the grid, sized to the SMs; each block walks rows blockIdx,
//     + grid, ... in a grid-stride loop):
//     - warp_per_row (x rows of at most 4 KB, and scale's: bf16 D <= 2048,
//       fp32 D <= 1024): a warp per row, four a block; a lane holds its
//       vectors of x and dy in registers, loaded once, and its part of
//       scale for every row. Sum(x^2) and sum(x*g) reduce by warp shuffles
//       alone, dx is written from the registers, and dy * x_hat adds into
//       the lane's own fp32 dscale columns in registers. At the end the
//       block adds its four warps' columns in warp order through shared
//       memory and writes its partial to `partials` (grid x D);
//     - block_per_row (wider rows, up to 8192, or too few rows to give each
//       SM two): the same with 256 threads a row, the sums added across
//       warps through shared memory; each thread writes its own columns of
//       the block's partial;
//     - scalar (D or a pointer does not allow 16-byte accesses): a block of
//       256 threads per row, element by element, two passes over the row
//       (the second from L1/L2), the block's partial in shared memory.
//  2. scale: a block of 32 columns x 8 slices sums the partials over the
//     blocks in a fixed order and writes dscale in scale's type.

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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kScaleCols = 32;      // dscale reduction: columns per block
constexpr int kScaleSlices = 8;     // and slices of the partials' rows

// The scalar path: a block per row, element by element.
template <typename TX, typename TS>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                        const TX* __restrict__ dy, TX* __restrict__ dx,
                        float* __restrict__ partials, int rows, int dim, float eps) {
  extern __shared__ float dsc[];                  // dim fp32: this block's partial
  __shared__ float red[2][kBwdThreads / 32];
  for (int c = threadIdx.x; c < dim; c += kBwdThreads) dsc[c] = 0.f;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t base = static_cast<int64_t>(row) * dim;
    float ss = 0.f, sxg = 0.f;
    for (int c = threadIdx.x; c < dim; c += kBwdThreads) {
      const float xv = to_f(x[base + c]);
      const float g = to_f(dy[base + c]) * to_f(scale[c]);
      ss = fmaf(xv, xv, ss);
      sxg = fmaf(xv, g, sxg);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sxg += __shfl_xor_sync(0xffffffffu, sxg, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[0][threadIdx.x >> 5] = ss;
      red[1][threadIdx.x >> 5] = sxg;
    }
    __syncthreads();
    ss = 0.f;
    sxg = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      ss += red[0][w];
      sxg += red[1][w];
    }
    __syncthreads();                               // red is rewritten for the next row
    const float rstd = rsqrtf(ss / static_cast<float>(dim) + eps);
    const float coef = rstd * rstd * rstd * sxg / static_cast<float>(dim);
    for (int c = threadIdx.x; c < dim; c += kBwdThreads) {
      const float xv = to_f(x[base + c]);
      const float dyv = to_f(dy[base + c]);
      dx[base + c] = from_f<TX>(rstd * dyv * to_f(scale[c]) - xv * coef);
      dsc[c] = fmaf(dyv, xv * rstd, dsc[c]);
    }
  }
  float* part = partials + static_cast<int64_t>(blockIdx.x) * dim;
  for (int c = threadIdx.x; c < dim; c += kBwdThreads) part[c] = dsc[c];
}

template <typename V>
__device__ __forceinline__ void fence_words(V& v) {
  uint32_t* words = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(V) / 4); ++k) asm volatile("" : "+r"(words[k]));
}

// The vector paths: ROW_THREADS threads (a warp or the block) share a row,
// vector i of the row at thread i % ROW_THREADS, as in the forward. Each
// thread holds up to VPT vectors of x and of dy, its part of scale, and
// fp32 dscale sums of its columns over the rows it walks.
template <typename TX, typename TS, int VPT, int ROW_THREADS>
__global__ void __launch_bounds__(ROW_THREADS == 32 ? kWarpBlock : kRowBlock)
rmsnorm_bwd_vec_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                       const TX* __restrict__ dy, TX* __restrict__ dx,
                       float* __restrict__ partials, int rows, int dim, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int BLOCK = ROW_THREADS == 32 ? kWarpBlock : kRowBlock;
  constexpr int ROWS_PER_BLOCK = BLOCK / ROW_THREADS;
  extern __shared__ float warp_ds[];       // warp path: ROWS_PER_BLOCK x dim
  __shared__ float red[2][ROW_THREADS == 32 ? 1 : kRowBlock / 32];

  const int lane = threadIdx.x % ROW_THREADS;
  const int nvec = dim / VEC;
  using XV = Vec<TX, VEC>;
  using SV = Vec<TS, VEC>;

  SV sv[VPT];
  float ds[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = i * ROW_THREADS + lane;
    if (v < nvec) sv[i] = reinterpret_cast<const SV*>(scale)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) ds[i][j] = 0.f;
  }

  const int row_step = gridDim.x * ROWS_PER_BLOCK;
  for (int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_THREADS; row < rows;
       row += row_step) {
    const int64_t base = static_cast<int64_t>(row) * dim;
    const XV* xr = reinterpret_cast<const XV*>(x + base);
    const XV* gr = reinterpret_cast<const XV*>(dy + base);
    XV xv[VPT], gv[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = i * ROW_THREADS + lane;
      if (v < nvec) {
        xv[i] = xr[v];
        gv[i] = gr[v];
      }
    }
    // one partial sum per vector, so the adds do not form one long chain
    float ss[VPT], sxg[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      ss[i] = sxg[i] = 0.f;
      if (i * ROW_THREADS + lane < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f(xv[i].v[j]);
          ss[i] = fmaf(xf, xf, ss[i]);
          sxg[i] = fmaf(xf, to_f(gv[i].v[j]) * to_f(sv[i].v[j]), sxg[i]);
        }
      }
    }
#pragma unroll
    for (int w = 1; w < VPT; w <<= 1)
#pragma unroll
      for (int i = 0; i + w < VPT; i += 2 * w) {
        ss[i] += ss[i + w];
        sxg[i] += sxg[i + w];
      }
    float s2 = ss[0], sg = sxg[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if constexpr (ROW_THREADS != 32) {
      if ((threadIdx.x & 31) == 0) {
        red[0][threadIdx.x >> 5] = s2;
        red[1][threadIdx.x >> 5] = sg;
      }
      __syncthreads();
      s2 = sg = 0.f;
#pragma unroll
      for (int w = 0; w < kRowBlock / 32; ++w) {
        s2 += red[0][w];
        sg += red[1][w];
      }
      __syncthreads();                     // red is rewritten for the next row
    }
    const float rstd = rsqrtf(s2 / static_cast<float>(dim) + eps);
    const float coef = rstd * rstd * rstd * sg / static_cast<float>(dim);
    if constexpr (VPT >= 8) {
      // An empty asm that may change the packed x, dy and scale: without it
      // the compiler keeps their fp32 conversions from the sums above (and
      // hoists scale's out of the row loop), which at 8 vectors takes more
      // than 255 registers and spills; converting again costs a few ALU ops.
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        fence_words(xv[i]);
        fence_words(gv[i]);
        fence_words(sv[i]);
      }
    }
    XV* dr = reinterpret_cast<XV*>(dx + base);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = i * ROW_THREADS + lane;
      if (v < nvec) {
        XV o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f(xv[i].v[j]);
          const float gf = to_f(gv[i].v[j]);
          o.v[j] = from_f<TX>(rstd * gf * to_f(sv[i].v[j]) - xf * coef);
          ds[i][j] = fmaf(gf, xf * rstd, ds[i][j]);
        }
        dr[v] = o;
      }
    }
  }

  // The block's dscale partial: the warp path adds its warps in order
  // through shared memory; on the block path each thread owns its columns.
  float* part = partials + static_cast<int64_t>(blockIdx.x) * dim;
  float* own = ROW_THREADS == 32 ? warp_ds + (threadIdx.x / 32) * dim : part;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = i * ROW_THREADS + lane;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(own + v * VEC + j) =
            make_float4(ds[i][j], ds[i][j + 1], ds[i][j + 2], ds[i][j + 3]);
    }
  }
  if constexpr (ROW_THREADS == 32) {
    __syncthreads();
    for (int c = threadIdx.x; c < dim; c += BLOCK) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < ROWS_PER_BLOCK; ++w) acc += warp_ds[w * dim + c];
      part[c] = acc;
    }
  }
}

template <typename TS>
__global__ void __launch_bounds__(kScaleCols * kScaleSlices)
rmsnorm_bwd_scale_kernel(const float* __restrict__ partials, int nparts, int dim,
                         TS* __restrict__ dscale) {
  __shared__ float sums[kScaleSlices][kScaleCols];
  const int c = blockIdx.x * kScaleCols + threadIdx.x;
  float acc = 0.f;
  if (c < dim)
    for (int b = threadIdx.y; b < nparts; b += kScaleSlices)
      acc += partials[static_cast<int64_t>(b) * dim + c];
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < dim) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kScaleSlices; ++y) total += sums[y][threadIdx.x];
    dscale[c] = from_f<TS>(total);
  }
}

template <typename TX, typename TS, int ROW_THREADS>
cudaError_t launch_bwd_vec(const TX* x, const TS* s, const TX* dy, TX* dx, float* partials,
                           int rows, int dim, float eps, int grid, int vpt,
                           cudaStream_t stream) {
  constexpr int kBlock = ROW_THREADS == 32 ? kWarpBlock : kRowBlock;
  // The most vectors a thread can need: rows of at most 4 KB of x and of
  // scale on the warp path, up to kMaxDim on the block path.
  constexpr int kWide = sizeof(TS) > sizeof(TX) ? sizeof(TS) : sizeof(TX);
  constexpr int kMaxVpt = ROW_THREADS == 32 ? 4096 / kWide / (16 / sizeof(TX)) / 32
                                            : kMaxDim / (16 / sizeof(TX)) / kRowBlock;
  // the warp path's per-warp dscale columns
  const size_t smem = ROW_THREADS == 32 ? static_cast<size_t>(kBlock / 32) * dim * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
#define RMS_BWD_VEC(V)                                                                   \
  if constexpr (V <= kMaxVpt) {                                                          \
    rmsnorm_bwd_vec_kernel<TX, TS, V, ROW_THREADS><<<grid, kBlock, smem, stream>>>(      \
        x, s, dy, dx, partials, rows, dim, eps);                                         \
    return cudaGetLastError();                                                           \
  }                                                                                      \
  return cudaErrorInvalidValue
  switch (vpt) {
    case 1: RMS_BWD_VEC(1);
    case 2: RMS_BWD_VEC(2);
    case 4: RMS_BWD_VEC(4);
    case 8: RMS_BWD_VEC(8);
    default: return cudaErrorInvalidValue;
  }
#undef RMS_BWD_VEC
}

template <typename TX, typename TS>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                       float* partials, void* dscale, int rows, int dim, float eps,
                       int grid, int path, int vpt, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  const TX* gp = static_cast<const TX*>(dy);
  TX* dp = static_cast<TX*>(dx);
  cudaError_t e;
  if (path == kScalar) {
    const size_t smem = static_cast<size_t>(dim) * sizeof(float);   // up to 32 KB
    rmsnorm_bwd_rows_kernel<TX, TS><<<grid, kBwdThreads, smem, stream>>>(
        xp, sp, gp, dp, partials, rows, dim, eps);
    e = cudaGetLastError();
  } else {
    // the vector paths: 16-byte rows and pointers, and a shape that holds the row
    const int row_threads = path == kWarpPerRow ? 32 : kRowBlock;
    uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                     reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
                     reinterpret_cast<uintptr_t>(partials);
    if (dim % kVec != 0 || ptrs % 16 != 0 || dim / kVec > vpt * row_threads)
      return cudaErrorInvalidValue;
    e = path == kWarpPerRow
        ? launch_bwd_vec<TX, TS, 32>(xp, sp, gp, dp, partials, rows, dim, eps, grid, vpt, stream)
        : launch_bwd_vec<TX, TS, kRowBlock>(xp, sp, gp, dp, partials, rows, dim, eps, grid, vpt,
                                            stream);
  }
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_scale_kernel<TS><<<(dim + kScaleCols - 1) / kScaleCols,
                                 dim3(kScaleCols, kScaleSlices), 0, stream>>>(
      partials, grid, dim, static_cast<TS*>(dscale));
  return cudaGetLastError();
}

}  // namespace

// Backward. dy and dx have x's type, dscale scale's; `partials` is an fp32
// scratch of grid x dim. path: 0 warp_per_row, 1 block_per_row, 2 scalar,
// with `grid` blocks and, on the vector paths, `vpt` 16-byte vectors of x a
// thread. rows may be 0 (dscale is then zero). Returns a cudaError_t as int.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partials, void* dscale, int rows, int dim, float eps,
                           int x_dtype, int scale_dtype, int grid, int path, int vpt,
                           void* stream) {
  if (dim < 1 || dim > kMaxDim || rows < 0 || grid < 1 || x_dtype < 0 || x_dtype > 1 ||
      scale_dtype < 0 || scale_dtype > 1 || path < 0 || path > 2) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
#define RMS_BWD_ARGS x, scale, dy, dx, part, dscale, rows, dim, eps, grid, path, vpt, s
  if (x_dtype == 0 && scale_dtype == 0) return launch_bwd<float, float>(RMS_BWD_ARGS);
  if (x_dtype == 0 && scale_dtype == 1) return launch_bwd<float, __nv_bfloat16>(RMS_BWD_ARGS);
  if (x_dtype == 1 && scale_dtype == 0) return launch_bwd<__nv_bfloat16, float>(RMS_BWD_ARGS);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(RMS_BWD_ARGS);
#undef RMS_BWD_ARGS
}

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
