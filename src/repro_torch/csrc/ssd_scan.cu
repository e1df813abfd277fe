// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel,
// pallas_call at ssd_scan.py:76) and, on the model path, the chunk loop of
// src/repro/models/ssm.py::ssd_chunked. For each (batch, head) the sequence
// runs chunk by chunk, Q rows at a time. Per chunk, with cum = cumsum(dA):
//     y     = ((C B^T) o tril(exp(cum_t - cum_s))) x  +  (C o exp(cum)) state
//     state = state * exp(cum_last) + (B o exp(cum_last - cum))^T x
// The (N, P) state is fp32 and stays in shared memory from chunk to chunk.
//
// Layout: x (Bsz, S, H, P), already dt-scaled; dA (Bsz, S, H) in fp32; B and
// C (Bsz, S, G, N). Head h reads group h / (H / G), so B and C are never
// repeated per head. Each is read through its batch/sequence/head strides
// with a unit last stride. x is fp32, as the model hands it over (the wrapper
// casts any other x); B and C are fp32 or bf16; all arithmetic is fp32. y is
// a contiguous fp32 (Bsz, S, H, P); the final state, when asked for, a
// contiguous fp32 (Bsz, H, N, P). The Pallas contract (BH, S, P) is the case
// H = G = 1.
//
// What bounds it: operations. The least work is the recurrence's, about
// 5*N*P flops per row and head (decay and rank-1 update of the state, then
// C . state), against 2P + 2N + 1 elements moved per row and head. The
// chunked form this kernel runs does about Q*(N+P) + 4*N*P per row and head,
// at Q 256, N 128, P 64 twice the recurrence's. This first version runs the
// products on CUDA cores in fp32 FMAs; tensor cores, C B^T shared across the
// heads of a group, and a chunk-parallel scan are later steps.
//
// Design: one block of 256 threads per (head, batch); the chunk loop runs
// inside the block, in place of the TPU grid's sequential chunk axis. A chunk
// of 256 rows with N = 128 does not fit in shared memory whole (B and C alone
// are 256 KB in fp32), so it is cut into 64-row tiles: for each row tile the
// C tile is staged, the cross-chunk term is read from the resident state,
// and then the column tiles s <= t of B and x are staged in turn. The decay
// exp(cum_t - cum_s) is evaluated only where s <= t: cum falls along the
// chunk, so there it is at most 1, while above the diagonal it can overflow
// and a product with a zero mask would give NaN. The state update is a pass
// of its own over the chunk's B and x tiles, after every row tile has read
// the old state. Each thread owns a 4 x ceil(P/16) patch of a y tile (rows
// ty*4.., columns tx + 16*j), a 4x4 patch of the score tile and a
// ceil(N/16) x ceil(P/16) patch of the state update; rows of C and B are
// padded by one float so that 16 threads reading 16 rows hit 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // rows of a y tile and of a B/x tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kMaxChunk = 4096;
constexpr int kNT = kMaxN / 16;     // state-update rows per thread, at most
constexpr int kPT = kMaxP / 16;     // y and state columns per thread, at most
static_assert(kThreads == 16 * 16 && kTile == 4 * 16,
              "a 16 x 16 thread grid covers a 64 x 64 tile in 4x4 patches");

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Params {
  const float* x;
  const float* dA;
  const void* b;
  const void* c;
  float* y;
  float* state;       // null: the final state is not wanted
  int S, H, rep, P, N, Q;   // rep = H / G heads per group
  int64_t x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// Stages rows [row0, row0 + kTile) of a (rows, width) matrix with row stride
// `ld_src` into shared memory with row stride `ld_dst`; rows at or past
// `row_end` (the end of the chunk) are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld_dst, const T* src,
                                          int64_t ld_src, int row0, int row_end,
                                          int width) {
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int gr = row0 + r;
    dst[r * ld_dst + c] = gr < row_end ? to_f(src[gr * ld_src + c]) : 0.f;
  }
}

// cum[r] = dA[r0] + ... + dA[r0 + r] for r < Q: a block-wide inclusive scan,
// kThreads rows at a time, with warp shuffles and the warps' totals.
__device__ __forceinline__ void chunk_cumsum(float* cum, float* warp_tot,
                                             const float* da, int64_t ld,
                                             int r0, int Q) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kThreads) {
    const int r = base + threadIdx.x;
    float v = r < Q ? da[static_cast<int64_t>(r0 + r) * ld] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float before = carry, total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
    if (r < Q) cum[r] = v + before;
    carry += total;
    __syncthreads();                      // warp_tot is rewritten next round
  }
}

template <typename TB>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  extern __shared__ float smem[];
  const int N = p.N, P = p.P, Q = p.Q;
  const int ldn = N + 1;                  // padded rows of C and B
  constexpr int ldt = kTile + 1;          // padded rows of the score tile
  float* St = smem;                       // N x P, the carried state
  float* Cs = St + N * P;                 // kTile x ldn
  float* Bs = Cs + kTile * ldn;           // kTile x ldn
  float* Xs = Bs + kTile * ldn;           // kTile x P
  float* Ts = Xs + kTile * P;             // kTile x ldt, masked scores
  float* cum = Ts + kTile * ldt;          // Q
  float* warp_tot = cum + Q;              // kWarps

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / p.rep;
  const float* xb = p.x + b * p.x_sb + h * p.x_sh;
  const float* ab = p.dA + b * p.a_sb + h * p.a_sh;
  const TB* bb = static_cast<const TB*>(p.b) + b * p.b_sb + g * p.b_sg;
  const TB* cb = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  float* yb = p.y + static_cast<int64_t>(b) * p.S * y_ss + static_cast<int64_t>(h) * P;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int i = threadIdx.x; i < N * P; i += kThreads) St[i] = 0.f;

  for (int r0 = 0; r0 < p.S; r0 += Q) {
    const int r_end = r0 + Q;
    __syncthreads();                      // the last chunk's state is written
    chunk_cumsum(cum, warp_tot, ab, p.a_ss, r0, Q);
    const float cum_last = cum[Q - 1];

    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();                    // the last row tile's Cs is consumed
      load_rows(Cs, ldn, cb, p.c_ss, r0 + t0, r_end, N);
      __syncthreads();

      // Cross-chunk term: acc = exp(cum_t) * (C_t . state).
      float acc[4][kPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int col = tx + 16 * j;
          if (col < P) {
            const float sv = St[n * P + col];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(cv[i], sv, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        float d = 0.f;                    // cum holds Q values: guard, not select
        if (t < Q) d = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] *= d;
      }

      // Within-chunk term over the column tiles s0 <= t0.
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();                  // the last column tile is consumed
        load_rows(Bs, ldn, bb, p.b_ss, r0 + s0, r_end, N);
        load_rows(Xs, P, xb, p.x_ss, r0 + s0, r_end, P);
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float v = 0.f;
            if (s <= t && t < Q) v = sc[i][j] * expf(cum[t] - cum[s]);
            Ts[(ty * 4 + i) * ldt + tx + 16 * j] = v;
          }
        }
        __syncthreads();

        const int kn = min(kTile, Q - s0);
        for (int k = 0; k < kn; ++k) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ts[(ty * 4 + i) * ldt + k];
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
            const int col = tx + 16 * j;
            if (col < P) {
              const float xv = Xs[k * P + col];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= Q) continue;
        float* yr = yb + static_cast<int64_t>(r0 + t) * y_ss;
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int col = tx + 16 * j;
          if (col < P) yr[col] = acc[i][j];
        }
      }
    }

    // State update, after every row tile has read the old state:
    // state = state * exp(cum_last) + sum_s exp(cum_last - cum_s) B_s^T x_s.
    float st[kNT][kPT];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int j = 0; j < kPT; ++j) st[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      __syncthreads();                    // Bs and Xs are consumed
      load_rows(Bs, ldn, bb, p.b_ss, r0 + s0, r_end, N);
      load_rows(Xs, P, xb, p.x_ss, r0 + s0, r_end, P);
      __syncthreads();
      const int kn = min(kTile, Q - s0);
      for (int k = 0; k < kn; ++k) {
        const float w = expf(cum_last - cum[s0 + k]);
        float bv[kNT];
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const int n = ty + 16 * i;
          bv[i] = n < N ? Bs[k * ldn + n] * w : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int col = tx + 16 * j;
          if (col < P) {
            const float xv = Xs[k * P + col];
#pragma unroll
            for (int i = 0; i < kNT; ++i) st[i][j] = fmaf(bv[i], xv, st[i][j]);
          }
        }
      }
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const int col = tx + 16 * j;
        if (n < N && col < P) St[n * P + col] = St[n * P + col] * decay + st[i][j];
      }
    }
  }

  if (p.state != nullptr) {
    __syncthreads();
    float* sb = p.state + (static_cast<int64_t>(b) * p.H + h) * N * P;
    for (int i = threadIdx.x; i < N * P; i += kThreads) sb[i] = St[i];
  }
}

template <typename TB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(p.N) * p.P + 2 * static_cast<size_t>(kTile) * (p.N + 1) +
       static_cast<size_t>(kTile) * p.P + static_cast<size_t>(kTile) * (kTile + 1) +
       p.Q + kWarps);
  static size_t smem_set = 48 * 1024;     // per instantiation: the most allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();   // clear it, so that the next launch's check reports that launch
      return e;
    }
    smem_set = smem;
  }
  const dim3 grid(p.H, B);
  ssd_scan_kernel<TB><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16. x, dA, y and state are float32.
// Strides are in elements. `state` may be null. Returns a cudaError_t as int.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dA, const void* b, const void* c, void* y,
    void* state, int B, int S, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int bc_dtype, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
      S % Q != 0 || bc_dtype < 0 || bc_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  Params p;
  p.x = static_cast<const float*>(x); p.dA = static_cast<const float*>(dA);
  p.b = b; p.c = c; p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.S = S; p.H = H; p.rep = H / G; p.P = P; p.N = N; p.Q = Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.a_sb = a_sb; p.a_ss = a_ss; p.a_sh = a_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch<float>(p, B, s);
  return launch<__nv_bfloat16>(p, B, s);
}
