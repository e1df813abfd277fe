// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel, pallas_call at flash_attention.py:102). Computes
//     o = softmax(q k^T * D^-0.5 [+ causal mask qpos >= kpos]) v
// with an online softmax: the running max m, the denominator l and the
// output accumulator are fp32 and never leave the chip, so the (Sq x Sk)
// score matrix is never written to device memory.
//
// Layout: q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv), each read
// through its own batch/head/row strides with a unit last stride; o is a
// contiguous (B, H, Sq, Dv). GQA takes kv head h / (H / KH), so K and V are
// never repeated in memory. The Pallas contract (BH, S, D) is B = BH with
// H = KH = 1. D and Dv may differ, each up to 256. Sq and Sk need no
// divisibility: rows and keys past the end are masked at the tile edge.
// Positions are the row indices (qpos = i, kpos = j), as in the Pallas kernel.
//
// What bounds it: at the model's shapes (head dim 64-128, S >= 128) the work
// is 4*S^2*D/2 flops against 4*S*D elements moved, so it is bound by
// arithmetic. This first version does the products on CUDA cores in fp32
// FMAs (no tensor cores), so it sits well under the bf16 tensor-core bound;
// wgmma with TMA-fed tiles is the later step.
//
// Design: one block of 256 threads per (64-row q tile, head, batch). The q
// tile and each 64-row K/V tile are staged in shared memory as fp32 (rows of
// Q and K padded by one float so that the 16 threads reading 16 K rows hit 16
// banks). Each thread owns a 4x4 patch of the score tile (rows ty*4.., cols
// tx + 16*j) and a 4 x ceil(Dv/16) patch of the accumulator in registers. Row
// max and row sum reduce over the 16 threads of a row with warp shuffles.
// Under the causal mask, K tiles strictly above the diagonal are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;   // finite start for the running max
static_assert(kBlockQ == kBlockK, "load_tile stages 64-row tiles of q, k and v");

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, group, Sq, Sk, D, Dv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;   // D^-0.5 * log2(e): scores are kept in log2 units
  int causal;
};

// Loads rows [row0, row0 + 64) of a (rows, width) matrix with row stride
// `ld_src` into shared memory with row stride `ld_dst`; rows past `nrows`
// are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld_dst, const T* src,
                                          int64_t ld_src, int row0, int nrows,
                                          int width) {
  for (int idx = threadIdx.x; idx < kBlockK * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int gr = row0 + r;
    dst[r * ld_dst + c] = gr < nrows ? to_f(src[gr * ld_src + c]) : 0.f;
  }
}

// DVT: accumulator columns per thread, ceil(Dv / 16).
template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + 1;
  constexpr int ldp = kBlockK + 1;
  float* Qs = smem;                        // kBlockQ x ldq
  float* Ks = Qs + kBlockQ * ldq;          // kBlockK x ldq
  float* Vs = Ks + kBlockK * ldq;          // kBlockK x Dv
  float* Ps = Vs + kBlockK * Dv;           // kBlockQ x ldp

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.group;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  const int tx = threadIdx.x & 15;         // score cols tx + 16*j, acc cols tx + 16*jj
  const int ty = threadIdx.x >> 4;         // rows ty*4 .. ty*4+3

  load_tile(Qs, ldq, qb, p.q_ss, q0, p.Sq, D);

  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DVT; ++jj) acc[i][jj] = 0.f;
  }

  // Keys a tile of q rows can see: all of them, or up to its last row.
  const int k_end = p.causal ? min(p.Sk, q0 + kBlockQ) : p.Sk;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                       // the last tile's Ks/Vs/Ps are consumed
    load_tile(Ks, ldq, kb, p.k_ss, k0, p.Sk, D);
    load_tile(Vs, Dv, vb, p.v_ss, k0, p.Sk, Dv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool valid = kc < p.Sk && (!p.causal || kc <= qr);
        s[i][j] = valid ? s[i][j] * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = exp2f(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = exp2f(s[i][j] - mx);   // masked: exp2(-inf) = 0
        Ps[(ty * 4 + i) * ldp + tx + 16 * j] = pij;
        rs += pij;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int jj = 0; jj < DVT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    for (int kc = 0; kc < kBlockK; ++kc) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * ldp + kc];
#pragma unroll
      for (int jj = 0; jj < DVT; ++jj) {
        const int c = tx + 16 * jj;
        const float vv = c < Dv ? Vs[kc * Dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

  T* ob = static_cast<T*>(p.o) + (static_cast<int64_t>(b) * p.H + h) * p.Sq * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DVT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < Dv) ob[static_cast<int64_t>(qr) * Dv + c] = from_f<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBlockQ + kBlockK) * (p.D + 1) +
       static_cast<size_t>(kBlockK) * p.Dv + static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  static size_t smem_set = 48 * 1024;     // per instantiation: the most allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_kernel<T, DVT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dv(const Params& p, int B, cudaStream_t stream) {
  if (p.Dv <= 64) return launch<T, 4>(p, B, stream);
  if (p.Dv <= 128) return launch<T, 8>(p, B, stream);
  return launch<T, 16>(p, B, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Strides are in elements.
// Returns a cudaError_t as int.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int dtype, void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || Sq < 0 || Sk < 1 ||
      D < 1 || D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim ||
      B > 65535 || H > 65535 || dtype < 0 || dtype > 1) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.H = H; p.group = H / KH; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dv<float>(p, B, s);
  return dispatch_dv<__nv_bfloat16>(p, B, s);
}

// Message for a code returned by the entry points above.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
