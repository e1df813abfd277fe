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
// ~295 flop/byte ridge, so the only thing that matters is moving each byte
// once at full width.
//
// Design: one block per row, so R needs no divisibility (the Pallas kernel
// asserted R % block_rows == 0). Each thread reads 16 bytes at a time when D
// and the pointers allow it, neighbouring threads on neighbouring addresses.
// The row is staged in shared memory as fp32 during the sum-of-squares pass,
// so the scaling pass does not go back to device memory. The sum is reduced
// with warp shuffles and then across the block's warps in shared memory.
// D up to 8192 (32 KB of fp32 staging) is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 8192;

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

// VEC elements of TX per access: 16 bytes when the row allows it, else 1.
template <typename TX, typename TS, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ out, int dim, float eps) {
  extern __shared__ float row[];                 // dim fp32 values
  __shared__ float warp_sums[kThreads / 32];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * dim;
  const TX* xr = x + base;
  TX* outr = out + base;
  const int nvec = dim / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    alignas(16) TX vals[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(vals) = reinterpret_cast<const uint4*>(xr)[i];
    } else {
      vals[0] = xr[i];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(vals[j]);
      row[i * VEC + j] = f;
      ss = fmaf(f, f, ss);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float rstd = rsqrtf(total / static_cast<float>(dim) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    alignas(16) TX vals[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int d = i * VEC + j;
      vals[j] = from_f<TX>(row[d] * rstd * to_f(scale[d]));
    }
    if constexpr (VEC > 1) {
      reinterpret_cast<uint4*>(outr)[i] = *reinterpret_cast<const uint4*>(vals);
    } else {
      outr[i] = vals[0];
    }
  }
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int dim, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec_ok = dim % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = static_cast<size_t>(dim) * sizeof(float);
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  TX* op = static_cast<TX*>(out);
  if (vec_ok) {
    rmsnorm_kernel<TX, TS, kVec><<<rows, kThreads, smem, stream>>>(xp, sp, op, dim, eps);
  } else {
    rmsnorm_kernel<TX, TS, 1><<<rows, kThreads, smem, stream>>>(xp, sp, op, dim, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int dim, float eps, int x_dtype,
                           int scale_dtype, void* stream) {
  if (dim < 1 || dim > kMaxDim || rows < 0 || x_dtype < 0 || x_dtype > 1 ||
      scale_dtype < 0 || scale_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0) return launch<float, float>(x, scale, out, rows, dim, eps, s);
  if (x_dtype == 0 && scale_dtype == 1) return launch<float, __nv_bfloat16>(x, scale, out, rows, dim, eps, s);
  if (x_dtype == 1 && scale_dtype == 0) return launch<__nv_bfloat16, float>(x, scale, out, rows, dim, eps, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, dim, eps, s);
}
