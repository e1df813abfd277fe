// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel,
// pallas_call at ssd_scan.py:76) and, on the model path, the chunk loop of
// src/repro/models/ssm.py::ssd_chunked. Per chunk of Q rows, with
// cum = cumsum(dA) inside the chunk:
//     y_c     = ((C B^T) o tril(exp(cum_t - cum_s))) x  +  (C o exp(cum)) state_c
//     S_c     = (B o exp(cum_last - cum))^T x
//     state_{c+1} = state_c * exp(cum_last) + S_c
// The (N, P) states are fp32.
//
// Layout: x (Bsz, S, H, P), already dt-scaled, fp32; dA (Bsz, S, H) fp32; B
// and C (Bsz, S, G, N), fp32 or bf16. Head h reads group h / (H / G), so B and
// C are never repeated per head. Each is read through its batch/sequence/head
// strides with a unit last stride. y is a contiguous fp32 (Bsz, S, H, P); the
// final state, when asked for, a contiguous fp32 (Bsz, H, N, P). The Pallas
// contract (BH, S, P) is the case H = G = 1.
//
// What bounds it: operations. The least work is the recurrence's, about
// 5*N*P flops per row and head. The chunked form this kernel runs does
// Q*P + 4*N*P fp32 flops per row and head, and C B^T's Q*N per row once per
// group, not per head.
//
// Design: three launches, each parallel over chunks, so that the card fills
// at batch 1 too.
//  1. chunk_state, one block per (batch, chunk, head, 64 x 64 tile of the
//     state): the chunk's cum in fp64 (written to `cum`, (Bsz, H, S)), then
//     S_c = (B o w)^T x with w = exp(cum_last - cum), written to `states`
//     (Bsz, H, nc, N, P).
//  2. state_pass, one thread per (batch, head, n, p): walks the chunks in
//     order and overwrites S_c with the state that enters chunk c; writes the
//     final state when it is asked for.
//  3. chunk_out, one block per (batch, chunk, 64-row tile, 64-column tile of
//     P, group, pair of heads of the group), the longest row tiles first:
//     the cross-chunk term (C o exp(cum_t)) state_c, then the within-chunk
//     term over the 64-row column slabs s0 <= t0. C B^T
//     is computed once per slab and kept in registers for every head of the
//     block: on the tensor cores (mma.sync m16n8k16, bf16 products exact,
//     fp32 sums) when B and C are bf16, in fp32 FMAs when they are fp32.
//     Each head then only masks and decays it, L = CB * exp(cum_t - cum_s)
//     for s <= t (above the diagonal the exponent can overflow, so it is
//     never evaluated there), and runs L x, while cp.async brings the next
//     (slab, head) x tile into a second buffer.
// Every product with x, a decay or a state is an fp32 FMA on the CUDA cores,
// in 64 x 64 tiles from shared memory with each thread holding a 4 x 4 patch.
// cum is summed in fp64 and each tile's decays are taken from differences to
// its first row, so that a 4096-row chunk, whose cum reaches thousands, keeps
// fp32-grade decays.
//
// Two heads per block (not more) keep chunk_out at 128 registers, two blocks
// an SM, without spills; on the H100 (NVIDIA H100 80GB HBM3, 700 W) four
// heads per block spilled and were no faster (scripts/flash_variants.py).
//
// Backward (ssd_scan_bwd). No TPU kernel: the JAX package differentiates
// src/repro/models/ssm.py::ssd_chunked. Per chunk c, with cum_t the running
// sum of dA in the chunk (the forward's, saved), h_c the state entering the
// chunk (the forward's `states`, saved), e_t = exp(cum_t), w_s = exp(cum_Q -
// cum_s), L_ts = exp(cum_t - cum_s) for s <= t (else 0) and G_c the gradient
// of the state leaving chunk c:
//     G_last = d(final state),  G_{c-1} = exp(cum_Q) G_c + sum_t e_t C_t dy_t^T
//     dx_s = sum_{t>=s} (C_t.B_s) L_ts dy_t + w_s G_c^T B_s
//     dB_s = sum_{t>=s} L_ts (dy_t.x_s) C_t + w_s G_c x_s
//     dC_t = sum_{s<=t} L_ts (dy_t.x_s) B_s + e_t h_c dy_t
//     d cum_t = C_t.dC_t - B_t.dB_t  (per head; with M_ts = (C_t.B_s)(dy_t.x_s)
//               L_ts this is sum_s M_ts - sum_t' M_t't + e_t (C_t^T h_c).dy_t
//               - w_t B_t^T G_c x_t)  + [t = Q-1] <h_{c+1}, G_c>
//     d dA_s  = sum_{t>=s in the chunk} d cum_t
// where the last row's term, sum_s w_s B_s^T G_c x_s + exp(cum_Q) <h_c, G_c>,
// is the state leaving the chunk dotted with its gradient.
//
// What bounds it: operations. Counted from this code, per row and head:
// D_c 2*N*P flops, the three cross-chunk products 6*N*P, the within-chunk
// products 2*Q*P + 2*Q*N over the causal half (dy x^T and (CB o L)^T dy;
// (DX o L)^T C and (DX o L) B), and C B^T's Q*N per row and group; the
// reverse recurrence would need about 16*N*P.
//
// Design: five launches, each parallel over chunks (or rows), no atomics, so
// two runs give equal bits.
//  1. chunk_dstate, one block per (batch, chunk, head, 64 x 64 tile of the
//     state): D_c = (C o e)^T dy, into `dstates` (Bsz, H, nc, N, P).
//  2. dstate_pass, one thread per (batch, head, n, p): walks the chunks in
//     reverse and overwrites D_c with G_c.
//  3. chunk_grads, one block per (batch, chunk, head, 64-row tile r): dx and
//     dB of rows r over the column slabs t >= r, then dC of rows r over the
//     slabs s <= r, so every block runs nT + 1 slabs. Each slab forms the
//     masked, decayed C B^T and dy x^T tiles in shared memory, all in fp32
//     FMAs with a 4 x 4 patch a thread; the block's own x, B and dy rows stay
//     in shared memory throughout. dB and dC are per head, fp32, (Bsz, S, H, N).
//  4. reduce_rows, one block per (batch, row): dB and dC summed over the heads
//     of each group in head order, cast to B's type, and d cum per head.
//  5. dA_scan, one block per (batch, chunk, head): <h_{c+1}, G_c> in a fixed
//     order, then the reverse running sum of d cum in fp64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // rows and columns of every output tile
constexpr int kSlab1 = 32;           // rows of B and x per step of chunk_state
constexpr int kHB = 2;               // heads per chunk_out block (see above)
constexpr int kLdL = kTile + 4;      // row stride of the L tile
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kMaxChunk = 4096;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Params {
  const float* x;
  const float* dA;
  const void* b;
  const void* c;
  float* y;
  float* state;       // null: the final state is not wanted
  double* cum;        // (Bsz, H, S) scratch
  float* states;      // (Bsz, H, nc, N, P) scratch
  int S, H, G, rep, P, N, Q, nc;   // rep = H / G heads per group
  bool x_vec;         // x and P allow float4 rows: 16-byte base, strides and P in 4s
  int64_t x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// cum[r] = dA[r0] + ... + dA[r0 + r] for r < Q: a block-wide inclusive scan,
// kThreads rows at a time, with warp shuffles and the warps' totals. In fp64:
// over a chunk of 4096 rows cum reaches thousands, where fp32 sums would
// leave errors of 1e-2 in the differences cum_t - cum_s that the decays take.
__device__ __forceinline__ void chunk_cumsum(double* cum, double* warp_tot,
                                             const float* da, int64_t ld,
                                             int r0, int Q) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double carry = 0.0;
  for (int base = 0; base < Q; base += kThreads) {
    const int r = base + threadIdx.x;
    double v = r < Q ? da[static_cast<int64_t>(r0 + r) * ld] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    double before = carry, total = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const double t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
    if (r < Q) cum[r] = v + before;
    carry += total;
    __syncthreads();                      // warp_tot is rewritten next round
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][j] += sum_{k < K} A[k][ty*4 + i] * Bm[k][tx*4 + j]: both operands
// k-major, one float4 of each per k.
__device__ __forceinline__ void mm_kk(float (&acc)[4][4], const float* A, int lda,
                                      const float* Bm, int ldb, int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = ld4(A + k * lda + ty * 4);
    const float4 b = ld4(Bm + k * ldb + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(comp(a, i), comp(b, j), acc[i][j]);
  }
}

// acc[i][j] += sum_{k < K} A[ty*4 + i][k] * Bm[k][tx*4 + j]: A row-major,
// Bm k-major; K a multiple of 4 (operands zero-padded to it).
__device__ __forceinline__ void mm_rk(float (&acc)[4][4], const float* A, int lda,
                                      const float* Bm, int ldb, int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty * 4 + i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = ld4(Bm + (k + kk) * ldb + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = comp(a[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, comp(b, j), acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. chunk_state
// ---------------------------------------------------------------------------
template <typename TB>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(const Params p) {
  extern __shared__ double cum[];         // Q of cum, then Q floats of w
  __shared__ __align__(16) float Bs[kSlab1][kTile];
  __shared__ __align__(16) float Xs[kSlab1][kTile];
  __shared__ double warp_tot[kWarps];

  const int N = p.N, P = p.P, Q = p.Q;
  const int nN = (N + kTile - 1) / kTile, nP = (P + kTile - 1) / kTile;
  const int c = blockIdx.x / (nN * nP);
  const int nt = (blockIdx.x / nP) % nN;
  const int pt = blockIdx.x % nP;
  const int n0 = nt * kTile, p0 = pt * kTile;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  const int r0 = c * Q;
  const float* xb = p.x + b * p.x_sb + h * p.x_sh + r0 * p.x_ss;
  const TB* bb = static_cast<const TB*>(p.b) + b * p.b_sb + g * p.b_sg + r0 * p.b_ss;

  float* w = reinterpret_cast<float*>(cum + Q);   // exp(cum_last - cum)
  chunk_cumsum(cum, warp_tot, p.dA + b * p.a_sb + h * p.a_sh, p.a_ss, r0, Q);
  const double cum_last = cum[Q - 1];
  if (nt == 0 && pt == 0) {
    double* cg = p.cum + (static_cast<int64_t>(b) * p.H + h) * p.S + r0;
    for (int r = threadIdx.x; r < Q; r += kThreads) cg[r] = cum[r];
  }
  for (int r = threadIdx.x; r < Q; r += kThreads)
    w[r] = expf(static_cast<float>(cum_last - cum[r]));

  float acc[4][4] = {};
  for (int s0 = 0; s0 < Q; s0 += kSlab1) {
    __syncthreads();                      // w is written; the last slab is consumed
    for (int idx = threadIdx.x; idx < kSlab1 * kTile; idx += kThreads) {
      const int r = idx / kTile, col = idx % kTile, s = s0 + r;
      const bool row_ok = s < Q;
      const int n = n0 + col, pp = p0 + col;
      Bs[r][col] = row_ok && n < N ? to_f(bb[s * p.b_ss + n]) : 0.f;
      Xs[r][col] = row_ok && pp < P ? xb[s * p.x_ss + pp] * w[s] : 0.f;
    }
    __syncthreads();
    mm_kk(acc, &Bs[0][0], kTile, &Xs[0][0], kTile, min(kSlab1, Q - s0));
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* st = p.states + ((static_cast<int64_t>(b) * p.H + h) * p.nc + c) * N * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (n < N && pp < P) st[n * P + pp] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state_pass
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) state_pass_kernel(const Params p) {
  const int NP = p.N * p.P;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= NP) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * p.H + blockIdx.y;
  float* st = p.states + bh * p.nc * NP + i;
  const double* cum_last = p.cum + bh * p.S + p.Q - 1;
  // Eight chunks' loads go out before the first store, so that their
  // latencies overlap.
  constexpr int kBatch = 8;
  float run = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += kBatch) {
    float own[kBatch], decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < p.nc) {
        own[k] = st[static_cast<int64_t>(c0 + k) * NP];
        decay[k] = expf(static_cast<float>(cum_last[static_cast<int64_t>(c0 + k) * p.Q]));
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < p.nc) {
        st[static_cast<int64_t>(c0 + k) * NP] = run;   // the state entering chunk c0 + k
        run = fmaf(run, decay[k], own[k]);
      }
    }
  }
  if (p.state != nullptr) p.state[bh * NP + i] = run;
}

// ---------------------------------------------------------------------------
// 3. chunk_out
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));   // 0 bytes read: zero-fill
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// C B^T of one 64 x 64 (t, s) tile, in registers, from the tile's fp32 C rows
// `Cr` and the slab's B rows `Bs`; t_of and s_of name the (t, s) of value r
// of group q.
template <typename TB> struct CBTile;

// fp32 B and C: FMAs; thread (ty, tx) holds t = ty*4 + r, s = tx + 16*q.
template <> struct CBTile<float> {
  float v[4][4];     // [r][q]
  __device__ __forceinline__ void compute(const float* Cr, int ldc, const void* Bs,
                                          int ldb, int K) {
    const float* Br = static_cast<const float*>(Bs);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float4 a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(Cr + (ty * 4 + i) * ldc + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(Br + (tx + 16 * j) * ldb + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[i][j] = fmaf(a[i].x, bv[j].x, v[i][j]);
          v[i][j] = fmaf(a[i].y, bv[j].y, v[i][j]);
          v[i][j] = fmaf(a[i].z, bv[j].z, v[i][j]);
          v[i][j] = fmaf(a[i].w, bv[j].w, v[i][j]);
        }
    }
  }
  __device__ __forceinline__ float at(int r, int q) const { return v[r][q]; }
  __device__ __forceinline__ int t_of(int r, int) const { return (threadIdx.x >> 4) * 4 + r; }
  __device__ __forceinline__ int s_of(int, int q) const { return (threadIdx.x & 15) + 16 * q; }
};

// bf16 B and C: mma.sync m16n8k16 (bf16 x bf16 -> fp32). Warp w holds rows
// 16*(w % 4) .. +16 and columns 32*(w / 4) .. +32 as four 16 x 8 tiles q;
// value r of tile q sits at t = 16*(w%4) + lane/4 + 8*(r/2),
// s = 32*(w/4) + 8*q + 2*(lane%4) + r%2. The A fragments are the fp32 C rows
// packed back to bf16, which is exact: C arrived in bf16.
template <> struct CBTile<__nv_bfloat16> {
  float v[4][4];     // [q][r]
  __device__ __forceinline__ void compute(const float* Cr, int ldc, const void* Bs,
                                          int ldb, int K16) {
    const __nv_bfloat16* Bb = static_cast<const __nv_bfloat16*>(Bs);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const int mt = (warp & 3) * 16, nb = (warp >> 2) * 32;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[q][r] = 0.f;
    auto pack = [](const float* f) {
      const float2 v2 = *reinterpret_cast<const float2*>(f);
      const __nv_bfloat162 h = __floats2bfloat162_rn(v2.x, v2.y);
      return *reinterpret_cast<const uint32_t*>(&h);
    };
    for (int k0 = 0; k0 < K16; k0 += 16) {
      const float* ar = Cr + (mt + g) * ldc + k0 + 2 * q4;
      const uint32_t a0 = pack(ar), a1 = pack(ar + 8 * ldc);
      const uint32_t a2 = pack(ar + 8), a3 = pack(ar + 8 * ldc + 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat16* br = Bb + (nb + 8 * q + g) * ldb + k0 + 2 * q4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(v[q][0]), "+f"(v[q][1]), "+f"(v[q][2]), "+f"(v[q][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  __device__ __forceinline__ float at(int r, int q) const { return v[q][r]; }
  __device__ __forceinline__ int t_of(int r, int) const {
    return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (r >> 1);
  }
  __device__ __forceinline__ int s_of(int r, int q) const {
    return (threadIdx.x >> 7) * 32 + 8 * q + 2 * (threadIdx.x & 3) + (r & 1);
  }
};

// Shared memory of chunk_out, in bytes, and its parts' offsets.
struct OutSmem {
  int kw, np4, ldc, ldb;
  size_t cr, u, bs, ct, et, cs, total;
  __host__ __device__ OutSmem(int N, bool bf16) {
    np4 = round_up(N, 4);
    kw = bf16 ? round_up(N, 16) : np4;    // C B^T's depth: mma steps of 16
    ldc = kw + 4;                         // fp32 rows of C (and B): 16-byte aligned
    ldb = round_up(N, 16) + 8;            // bf16 rows of B: conflict-free fragments
    const size_t f = sizeof(float);
    const size_t ss = static_cast<size_t>(np4) * kTile;
    const size_t xl = 2 * kTile * kTile + kTile * kLdL;
    cr = 0;
    u = cr + kTile * ldc * f;
    bs = u + f * (ss > xl ? ss : xl);
    ct = bs + (bf16 ? kTile * ldb * sizeof(__nv_bfloat16) : kTile * ldc * f);
    et = ct + kHB * kTile * f;
    cs = et + kHB * kTile * f;
    total = cs + kHB * kTile * f;
  }
};

template <typename TB>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(TB) == 2;
  const int N = p.N, P = p.P, Q = p.Q;
  const OutSmem L(N, kBf16);
  float* Cr = reinterpret_cast<float*>(smem + L.cr);     // 64 x ldc, C rows
  float* Ss = reinterpret_cast<float*>(smem + L.u);      // np4 x 64, a state tile
  float* Xs = Ss;                                        // 2 x 64 x 64, x rows
  float* Ls = Ss + 2 * kTile * kTile;                    // 64 x kLdL, L tile
  void* Bs = smem + L.bs;                                // 64 rows of B
  // Per head: cum at the tile's rows t and at a slab's rows s, each less cum
  // at row t0 (so that their differences keep fp32 precision), and exp(cum_t).
  float* ct = reinterpret_cast<float*>(smem + L.ct);     // kHB x 64
  float* et = reinterpret_cast<float*>(smem + L.et);     // kHB x 64
  float* cs = reinterpret_cast<float*>(smem + L.cs);     // kHB x 64

  const int nT = (Q + kTile - 1) / kTile, nP = (P + kTile - 1) / kTile;
  const int c = blockIdx.x / (nT * nP);
  const int t0 = (nT - 1 - (blockIdx.x / nP) % nT) * kTile;   // the longest tiles first
  const int p0 = (blockIdx.x % nP) * kTile;
  const int nHB = (p.rep + kHB - 1) / kHB;
  const int g = blockIdx.y / nHB;
  const int hb0 = (blockIdx.y % nHB) * kHB;
  const int nh = min(kHB, p.rep - hb0);
  const int h0 = g * p.rep + hb0;
  const int b = blockIdx.z;
  const int r0 = c * Q;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TB* cbase = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg + r0 * p.c_ss;
  const TB* bbase = static_cast<const TB*>(p.b) + b * p.b_sb + g * p.b_sg + r0 * p.b_ss;
  const double* cumb = p.cum + (static_cast<int64_t>(b) * p.H + h0) * p.S + r0;

  // The C tile (rows t0 .. t0+63 of the chunk, a warp per row, zero past the
  // chunk and past N) and the decays at those rows.
  for (int t = warp; t < kTile; t += kWarps) {
    const bool row_ok = t0 + t < Q;
    const TB* src = cbase + (t0 + t) * p.c_ss;
    for (int n = lane; n < L.kw; n += 32)
      Cr[t * L.ldc + n] = row_ok && n < N ? to_f(src[n]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < kHB * kTile; idx += kThreads) {
    const int hh = idx / kTile, t = idx % kTile;
    const double* cum_h = cumb + static_cast<int64_t>(hh) * p.S;
    const bool ok = hh < nh && t0 + t < Q;
    ct[idx] = ok ? static_cast<float>(cum_h[t0 + t] - cum_h[t0]) : 0.f;
    et[idx] = ok ? __expf(static_cast<float>(cum_h[t0 + t])) : 0.f;
  }
  __syncthreads();

  float acc[kHB][4][4];
#pragma unroll
  for (int hh = 0; hh < kHB; ++hh)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][i][j] = 0.f;

  // Cross-chunk term: (C o exp(cum_t)) state_c; the state entering chunk 0 is 0.
  if (c > 0) {
#pragma unroll
    for (int hh = 0; hh < kHB; ++hh) {
      if (hh >= nh) break;
      const float* st = p.states +
          ((static_cast<int64_t>(b) * p.H + h0 + hh) * p.nc + c) * N * P;
      if (P % 4 == 0) {                   // float4 rows
        for (int idx = threadIdx.x; idx < L.np4 * kTile / 4; idx += kThreads) {
          const int n = idx / (kTile / 4), pp = p0 + 4 * (idx % (kTile / 4));
          *reinterpret_cast<float4*>(Ss + 4 * idx) =
              n < N && pp < P ? ld4(st + n * P + pp) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int idx = threadIdx.x; idx < L.np4 * kTile; idx += kThreads) {
          const int n = idx / kTile, pp = p0 + idx % kTile;
          Ss[idx] = n < N && pp < P ? st[n * P + pp] : 0.f;
        }
      }
      __syncthreads();
      mm_rk(acc[hh], Cr, L.ldc, Ss, kTile, L.np4);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = et[hh * kTile + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[hh][i][j] *= d;
      }
    }
  }

  // Within-chunk term, over the pairs (column slab s0 <= t0, head): the x
  // tile of the next pair is copied asynchronously (cp.async) into the other
  // of two buffers while the current pair is multiplied.
  auto stage_x = [&](float* dst, int s0, int hh) {
    const float* xh = p.x + b * p.x_sb + (h0 + hh) * p.x_sh + (r0 + s0) * p.x_ss;
    if (p.x_vec) {
      for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += kThreads) {
        const int s = idx / (kTile / 4), pp = p0 + 4 * (idx % (kTile / 4));
        const bool ok = s0 + s < Q && pp < P;
        cp_async16(dst + 4 * idx, ok ? xh + s * p.x_ss + pp : xh, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
        const int s = idx / kTile, pp = p0 + idx % kTile;
        dst[idx] = s0 + s < Q && pp < P ? xh[s * p.x_ss + pp] : 0.f;
      }
    }
    cp_async_commit();
  };
  const int npairs = (t0 / kTile + 1) * nh;
  CBTile<TB> cb;
  stage_x(Xs, 0, 0);
  for (int j = 0; j < npairs; ++j) {
    const int s0 = (j / nh) * kTile, hh = j % nh;
    if (hh == 0) {                        // a new slab: its B rows and cum
      for (int s = warp; s < kTile; s += kWarps) {
        const bool row_ok = s0 + s < Q;
        const TB* src = bbase + (s0 + s) * p.b_ss;
        for (int n = lane; n < L.kw; n += 32) {
          const TB v = row_ok && n < N ? src[n] : TB(0.f);
          if constexpr (kBf16) {
            static_cast<__nv_bfloat16*>(Bs)[s * L.ldb + n] = v;
          } else {
            static_cast<float*>(Bs)[s * L.ldc + n] = v;
          }
        }
      }
      for (int idx = threadIdx.x; idx < kHB * kTile; idx += kThreads) {
        const int h = idx / kTile, s = idx % kTile;
        const double* cum_h = cumb + static_cast<int64_t>(h) * p.S;
        cs[idx] = h < nh && s0 + s < Q ? static_cast<float>(cum_h[s0 + s] - cum_h[t0]) : 0.f;
      }
    }
    if (j + 1 < npairs) {
      stage_x(Xs + ((j + 1) & 1) * kTile * kTile, ((j + 1) / nh) * kTile, (j + 1) % nh);
    } else {
      cp_async_commit();                  // an empty group keeps the count
    }
    if (hh == 0) {
      __syncthreads();
      cb.compute(Cr, L.ldc, Bs, kBf16 ? L.ldb : L.ldc, L.kw);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = cb.t_of(r, q), s = cb.s_of(r, q);
        float v = 0.f;
        if (s0 + s <= t0 + t && t0 + t < Q)
          v = cb.at(r, q) * __expf(ct[hh * kTile + t] - cs[hh * kTile + s]);
        Ls[t * kLdL + s] = v;
      }
    cp_async_wait_all_but_newest();       // this pair's x tile has landed
    __syncthreads();
    const float* xs = Xs + (j & 1) * kTile * kTile;
    const int kn = round_up(min(kTile, Q - s0), 4);
#pragma unroll
    for (int k = 0; k < kHB; ++k)
      if (k == hh) mm_rk(acc[k], Ls, kLdL, xs, kTile, kn);
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < kHB; ++hh) {
    if (hh >= nh) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= Q) continue;
      float* yr = p.y + ((static_cast<int64_t>(b) * p.S + r0 + t) * p.H + h0 + hh) * P;
      const int pp = p0 + tx * 4;
      if (P % 4 == 0 && pp + 3 < P) {
        *reinterpret_cast<float4*>(yr + pp) =
            make_float4(acc[hh][i][0], acc[hh][i][1], acc[hh][i][2], acc[hh][i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (pp + j < P) yr[pp + j] = acc[hh][i][j];
      }
    }
  }
}

// Raises a kernel's dynamic shared memory limit once it needs more than 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it, so that the next launch's check reports that launch
    return e;
  }
  allowed = bytes;
  return cudaSuccess;
}

template <typename TB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int nN = (p.N + kTile - 1) / kTile, nP = (p.P + kTile - 1) / kTile;
  const int nT = (p.Q + kTile - 1) / kTile;
  const size_t smem1 = p.Q * (sizeof(double) + sizeof(float));
  static size_t allowed1 = 0;             // per instantiation: the most allowed so far
  cudaError_t e = allow_smem(chunk_state_kernel<TB>, smem1, allowed1);
  if (e != cudaSuccess) return e;
  chunk_state_kernel<TB><<<dim3(p.nc * nN * nP, p.H, B), kThreads, smem1, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  state_pass_kernel<<<dim3((p.N * p.P + kThreads - 1) / kThreads, p.H, B),
                      kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const OutSmem L(p.N, sizeof(TB) == 2);
  static size_t allowed = 48 * 1024;      // per instantiation: the most allowed so far
  e = allow_smem(chunk_out_kernel<TB>, L.total, allowed);
  if (e != cudaSuccess) return e;
  const int nHB = (p.rep + kHB - 1) / kHB;
  chunk_out_kernel<TB><<<dim3(p.nc * nT * nP, p.G * nHB, B), kThreads, L.total,
                         stream>>>(p);
  return cudaGetLastError();
}

// ===========================================================================
// Backward
// ===========================================================================

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct BwdParams {
  const float* x;
  const void* b;
  const void* c;
  const double* cum;       // (Bsz, H, S), the forward's
  const float* states;     // (Bsz, H, nc, N, P), the states entering each chunk
  const float* state;      // (Bsz, H, N, P), the final state; null when dstate is
  const float* dy;         // (Bsz, S, H, P), contiguous
  const float* dstate;     // (Bsz, H, N, P) or null (zero)
  float* dx;               // (Bsz, S, H, P)
  float* ddA;              // (Bsz, S, H)
  void* db;                // (Bsz, S, G, N) in B's type
  void* dc;
  float* dstates;          // (Bsz, H, nc, N, P) scratch: D_c, then G_c
  float* dbh;              // (Bsz, S, H, N) scratch: dB per head
  float* dch;              // (Bsz, S, H, N) scratch: dC per head
  float* dcum;             // (Bsz, H, S) scratch: d cum per head
  int S, H, G, rep, P, N, Q, nc;
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// acc[i][j] += sum_{k < K} A[ty*4 + i][k] * Bt[tx + 16*j][k]: both row-major
// (k contiguous); K a multiple of 4.
__device__ __forceinline__ void mm_rr(float (&acc)[4][4], const float* A, int lda,
                                      const float* Bt, int ldb, int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; k += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty * 4 + i) * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(Bt + (tx + 16 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// 1. chunk_dstate: D_c = (C o exp(cum))^T dy
// ---------------------------------------------------------------------------
template <typename TB>
__global__ void __launch_bounds__(kThreads) chunk_dstate_kernel(const BwdParams p) {
  extern __shared__ float e[];            // Q of exp(cum)
  __shared__ __align__(16) float Cs[kSlab1][kTile];
  __shared__ __align__(16) float Ys[kSlab1][kTile];

  const int N = p.N, P = p.P, Q = p.Q;
  const int nN = (N + kTile - 1) / kTile, nP = (P + kTile - 1) / kTile;
  const int c = blockIdx.x / (nN * nP);
  const int n0 = ((blockIdx.x / nP) % nN) * kTile;
  const int p0 = (blockIdx.x % nP) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  const int r0 = c * Q;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const double* cumc = p.cum + bh * p.S + r0;
  for (int r = threadIdx.x; r < Q; r += kThreads) e[r] = expf(static_cast<float>(cumc[r]));
  const TB* cb = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg + r0 * p.c_ss;
  const float* yb = p.dy + ((static_cast<int64_t>(b) * p.S + r0) * p.H + h) * P;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;

  float acc[4][4] = {};
  for (int t0 = 0; t0 < Q; t0 += kSlab1) {
    __syncthreads();                      // e is written; the last slab is consumed
    for (int idx = threadIdx.x; idx < kSlab1 * kTile; idx += kThreads) {
      const int r = idx / kTile, col = idx % kTile, t = t0 + r;
      const bool row_ok = t < Q;
      const int n = n0 + col, pp = p0 + col;
      Cs[r][col] = row_ok && n < N ? to_f(cb[t * p.c_ss + n]) : 0.f;
      Ys[r][col] = row_ok && pp < P ? yb[t * y_ss + pp] * e[t] : 0.f;
    }
    __syncthreads();
    mm_kk(acc, &Cs[0][0], kTile, &Ys[0][0], kTile, min(kSlab1, Q - t0));
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* st = p.dstates + (bh * p.nc + c) * N * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (n < N && pp < P) st[n * P + pp] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dstate_pass: G_last = dstate, G_{c-1} = exp(cum_Q) G_c + D_c
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) dstate_pass_kernel(const BwdParams p) {
  const int NP = p.N * p.P;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= NP) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * p.H + blockIdx.y;
  float* st = p.dstates + bh * p.nc * NP + i;
  const double* cum_last = p.cum + bh * p.S + p.Q - 1;
  constexpr int kBatch = 8;
  float run = p.dstate != nullptr ? p.dstate[bh * NP + i] : 0.f;
  for (int c0 = p.nc - 1; c0 >= 0; c0 -= kBatch) {
    float own[kBatch], decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 - k >= 0) {
        own[k] = st[static_cast<int64_t>(c0 - k) * NP];
        decay[k] = expf(static_cast<float>(cum_last[static_cast<int64_t>(c0 - k) * p.Q]));
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 - k >= 0) {
        st[static_cast<int64_t>(c0 - k) * NP] = run;   // the gradient leaving chunk c0 - k
        run = fmaf(run, decay[k], own[k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk_grads
// ---------------------------------------------------------------------------

// Shared memory of chunk_grads, in floats: the block's own x, B and dy rows,
// then a region U that holds either two slabs and the two 64 x 64 tiles, or
// one (N, P) state (or its transpose), then four vectors of 64.
struct GradSmem {
  int kP, kN, ldP, ldN, ldS;
  size_t xo, bo, yo, s1, s2, t1, t2, u, vec, total;
  __host__ __device__ GradSmem(int N, int P) {
    kP = round_up(P, kTile);
    kN = round_up(N, kTile);
    ldP = kP + 4;
    ldN = kN + 4;
    ldS = ldP > ldN ? ldP : ldN;
    xo = 0;
    bo = xo + kTile * ldP;
    yo = bo + kTile * ldN;
    u = yo + kTile * ldP;
    s1 = u;
    s2 = s1 + kTile * ldS;
    t1 = s2 + kTile * ldS;
    t2 = t1 + kTile * kLdL;
    size_t uend = t2 + kTile * kLdL;
    const size_t st1 = u + static_cast<size_t>(kN) * ldP, st2 = u + static_cast<size_t>(kP) * ldN;
    if (st1 > uend) uend = st1;
    if (st2 > uend) uend = st2;
    vec = uend;
    total = (vec + 4 * kTile) * sizeof(float);
  }
};

template <typename TB>
__global__ void __launch_bounds__(kThreads, 1) chunk_grads_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float sm[];
  const int N = p.N, P = p.P, Q = p.Q;
  const GradSmem L(N, P);
  float* xo = sm + L.xo;          // 64 x ldP: x of the block's rows
  float* bo = sm + L.bo;          // 64 x ldN: B of the block's rows
  float* yo = sm + L.yo;          // 64 x ldP: dy of the block's rows
  float* S1 = sm + L.s1;          // 64 x ldS: a slab of C (phase A) or B (phase B)
  float* S2 = sm + L.s2;          // 64 x ldS: a slab of dy (phase A) or x (phase B)
  float* T1 = sm + L.t1;          // 64 x kLdL: (C B^T o L) [t][s]
  float* T2 = sm + L.t2;          // 64 x kLdL: (dy x^T o L) [t][s]
  float* U = sm + L.u;            // a state, (N, P) or (P, N)
  float* c_own = sm + L.vec;      // cum at the block's rows, less cum at its first
  float* c_slab = c_own + kTile;  // cum at a slab's rows, less the same
  float* w_own = c_slab + kTile;  // exp(cum_Q - cum) at the block's rows
  float* e_own = w_own + kTile;   // exp(cum) at the block's rows

  const int nT = (Q + kTile - 1) / kTile;
  const int nP = L.kP / kTile, nN = L.kN / kTile;
  const int c = blockIdx.x / nT, r = blockIdx.x % nT, t0 = r * kTile;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  const int r0 = c * Q;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const double* cumc = p.cum + bh * p.S + r0;
  const float* xb = p.x + b * p.x_sb + h * p.x_sh + r0 * p.x_ss;
  const TB* bb = static_cast<const TB*>(p.b) + b * p.b_sb + g * p.b_sg + r0 * p.b_ss;
  const TB* cb = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg + r0 * p.c_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const float* yb = p.dy + ((static_cast<int64_t>(b) * p.S + r0) * p.H + h) * P;
  const int64_t NP = static_cast<int64_t>(N) * P;

  // rows [q0, q0 + 64) of the chunk into a 64 x ld tile, zero past Q and
  // past the width
  auto load_f = [&](float* dst, int ld, int width, int kw, const float* src,
                    int64_t ss, int q0) {
    for (int idx = threadIdx.x; idx < kTile * kw; idx += kThreads) {
      const int s = idx / kw, col = idx % kw;
      dst[s * ld + col] = q0 + s < Q && col < width ? src[(q0 + s) * ss + col] : 0.f;
    }
  };
  auto load_b = [&](float* dst, const TB* src, int64_t ss, int q0) {
    for (int idx = threadIdx.x; idx < kTile * L.kN; idx += kThreads) {
      const int s = idx / L.kN, col = idx % L.kN;
      dst[s * L.ldN + col] = q0 + s < Q && col < N ? to_f(src[(q0 + s) * ss + col]) : 0.f;
    }
  };
  auto load_slab_cum = [&](int q0) {
    for (int s = threadIdx.x; s < kTile; s += kThreads)
      c_slab[s] = q0 + s < Q ? static_cast<float>(cumc[q0 + s] - cumc[t0]) : 0.f;
  };
  // a state (N, P) at `st` into U as [n][p] (ld ldP), or transposed [p][n] (ld ldN)
  auto load_state = [&](const float* st, bool transpose) {
    for (int idx = threadIdx.x; idx < L.kN * L.kP; idx += kThreads) {
      const int n = idx / L.kP, pp = idx % L.kP;
      const float v = n < N && pp < P ? st[n * P + pp] : 0.f;
      if (transpose) U[pp * L.ldN + n] = v; else U[n * L.ldP + pp] = v;
    }
  };

  load_f(xo, L.ldP, P, L.kP, xb, p.x_ss, t0);
  load_b(bo, bb, p.b_ss, t0);
  load_f(yo, L.ldP, P, L.kP, yb, y_ss, t0);
  const double cum_last = cumc[Q - 1];
  for (int s = threadIdx.x; s < kTile; s += kThreads) {
    const bool ok = t0 + s < Q;
    c_own[s] = ok ? static_cast<float>(cumc[t0 + s] - cumc[t0]) : 0.f;
    w_own[s] = ok ? expf(static_cast<float>(cum_last - cumc[t0 + s])) : 0.f;
    e_own[s] = ok ? expf(static_cast<float>(cumc[t0 + s])) : 0.f;
  }

  // ---- phase A: dx and dB of the block's rows s ---------------------------
  float accX[2][4][4], accB[2][4][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) { zero(accX[k]); zero(accB[k]); }
  // cross-chunk terms first, then scaled by w_s: w_s G_c^T B_s and w_s G_c x_s
  const float* Gc = p.dstates + (bh * p.nc + c) * NP;
  load_state(Gc, false);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (k < nP) mm_rk(accX[k], bo, L.ldN, U + k * kTile, L.ldP, L.kN);
  __syncthreads();
  load_state(Gc, true);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (k < nN) mm_rk(accB[k], xo, L.ldP, U + k * kTile, L.ldN, L.kP);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float wv = w_own[ty * 4 + i];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) { accX[k][i][j] *= wv; accB[k][i][j] *= wv; }
  }
  // within the chunk: the slabs t >= s
  for (int ts = r; ts < nT; ++ts) {
    const int q0 = ts * kTile;
    __syncthreads();                      // U and the last slab are consumed
    load_b(S1, cb, p.c_ss, q0);           // C rows t (ld ldN <= ldS)
    load_f(S2, L.ldS, P, L.kP, yb, y_ss, q0);
    load_slab_cum(q0);
    __syncthreads();
    float v[4][4];
    zero(v);
    mm_rr(v, S1, L.ldN, bo, L.ldN, L.kN);               // C_t . B_s
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 4 + i, s = tx + 16 * j;
        const bool ok = t0 + s <= q0 + t && q0 + t < Q;
        T1[t * kLdL + s] = ok ? v[i][j] * __expf(c_slab[t] - c_own[s]) : 0.f;
      }
    zero(v);
    mm_rr(v, S2, L.ldS, xo, L.ldP, L.kP);               // dy_t . x_s
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 4 + i, s = tx + 16 * j;
        const bool ok = t0 + s <= q0 + t && q0 + t < Q;
        T2[t * kLdL + s] = ok ? v[i][j] * __expf(c_slab[t] - c_own[s]) : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k < nP) mm_kk(accX[k], T1, kLdL, S2 + k * kTile, L.ldS, kTile);
      if (k < nN) mm_kk(accB[k], T2, kLdL, S1 + k * kTile, L.ldN, kTile);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = t0 + ty * 4 + i;
    if (s >= Q) continue;
    float* dxr = p.dx + ((static_cast<int64_t>(b) * p.S + r0 + s) * p.H + h) * P;
    float* dbr = p.dbh + ((static_cast<int64_t>(b) * p.S + r0 + s) * p.H + h) * N;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k * kTile + tx * 4 + j;
        if (k < nP && col < P) dxr[col] = accX[k][i][j];
        if (k < nN && col < N) dbr[col] = accB[k][i][j];
      }
  }

  // ---- phase B: dC of the block's rows t ----------------------------------
  float accC[2][4][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) zero(accC[k]);
  if (c > 0) {                            // e_t h_c dy_t; the state entering chunk 0 is 0
    __syncthreads();
    load_state(p.states + (bh * p.nc + c) * NP, true);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nN) mm_rk(accC[k], yo, L.ldP, U + k * kTile, L.ldN, L.kP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ev = e_own[ty * 4 + i];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) accC[k][i][j] *= ev;
    }
  }
  // within the chunk: the slabs s <= t
  for (int ss = 0; ss <= r; ++ss) {
    const int q0 = ss * kTile;
    __syncthreads();
    load_b(S1, bb, p.b_ss, q0);           // B rows s
    load_f(S2, L.ldS, P, L.kP, xb, p.x_ss, q0);
    load_slab_cum(q0);
    __syncthreads();
    float v[4][4];
    zero(v);
    mm_rr(v, yo, L.ldP, S2, L.ldS, L.kP);               // dy_t . x_s
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 4 + i, s = tx + 16 * j;
        const bool ok = q0 + s <= t0 + t && t0 + t < Q;
        T2[t * kLdL + s] = ok ? v[i][j] * __expf(c_own[t] - c_slab[s]) : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nN) mm_rk(accC[k], T2, kLdL, S1 + k * kTile, L.ldN, kTile);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Q) continue;
    float* dcr = p.dch + ((static_cast<int64_t>(b) * p.S + r0 + t) * p.H + h) * N;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k * kTile + tx * 4 + j;
        if (k < nN && col < N) dcr[col] = accC[k][i][j];
      }
  }
}

// ---------------------------------------------------------------------------
// 4. reduce_rows: dB, dC over each group's heads; d cum per head
// ---------------------------------------------------------------------------
template <typename TB>
__global__ void __launch_bounds__(kThreads) reduce_rows_kernel(const BwdParams p) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int N = p.N, H = p.H;
  const int64_t row = static_cast<int64_t>(b) * p.S + s;
  const float* dbr = p.dbh + row * H * N;
  const float* dcr = p.dch + row * H * N;
  const TB* bb = static_cast<const TB*>(p.b) + b * p.b_sb + s * p.b_ss;
  const TB* cb = static_cast<const TB*>(p.c) + b * p.c_sb + s * p.c_ss;
  TB* dbo = static_cast<TB*>(p.db) + row * p.G * N;
  TB* dco = static_cast<TB*>(p.dc) + row * p.G * N;
  for (int idx = threadIdx.x; idx < p.G * N; idx += kThreads) {
    const int g = idx / N, n = idx % N;
    float sb = 0.f, sc = 0.f;
    for (int h = g * p.rep; h < (g + 1) * p.rep; ++h) {
      sb += dbr[h * N + n];
      sc += dcr[h * N + n];
    }
    dbo[idx] = from_f<TB>(sb);
    dco[idx] = from_f<TB>(sc);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < H; h += kWarps) {
    const int g = h / p.rep;
    float acc = 0.f;
    for (int n = lane; n < N; n += 32)
      acc += to_f(cb[g * p.c_sg + n]) * dcr[h * N + n] - to_f(bb[g * p.b_sg + n]) * dbr[h * N + n];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) p.dcum[(static_cast<int64_t>(b) * H + h) * p.S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// 5. dA_scan: d dA_s = sum_{t >= s} d cum_t + <h_{c+1}, G_c>, in fp64
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) dA_scan_kernel(const BwdParams p) {
  extern __shared__ double suf[];         // Q
  __shared__ double warp_tot[kWarps];
  __shared__ float red[kWarps];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const int64_t NP = static_cast<int64_t>(p.N) * p.P;
  const float* Gc = p.dstates + (bh * p.nc + c) * NP;
  const float* hn = c + 1 < p.nc ? p.states + (bh * p.nc + c + 1) * NP
                                 : (p.dstate != nullptr ? p.state + bh * NP : nullptr);
  float part = 0.f;
  if (hn != nullptr)
    for (int64_t i = threadIdx.x; i < NP; i += kThreads) part = fmaf(hn[i], Gc[i], part);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  double term = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) term += red[w];
  // the suffix sums as a prefix scan of the chunk's rows read backwards
  chunk_cumsum(suf, warp_tot, p.dcum + bh * p.S + c * Q + Q - 1, -1, 0, Q);
  for (int r = threadIdx.x; r < Q; r += kThreads) {
    const int s = Q - 1 - r;
    p.ddA[(static_cast<int64_t>(b) * p.S + c * Q + s) * p.H + h] =
        static_cast<float>(suf[r] + term);
  }
}

template <typename TB>
cudaError_t launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  const int nN = (p.N + kTile - 1) / kTile, nP = (p.P + kTile - 1) / kTile;
  const int nT = (p.Q + kTile - 1) / kTile;
  chunk_dstate_kernel<TB><<<dim3(p.nc * nN * nP, p.H, B), kThreads,
                            p.Q * sizeof(float), stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dstate_pass_kernel<<<dim3((p.N * p.P + kThreads - 1) / kThreads, p.H, B),
                       kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const GradSmem L(p.N, p.P);
  static size_t allowed = 48 * 1024;      // per instantiation: the most allowed so far
  e = allow_smem(chunk_grads_kernel<TB>, L.total, allowed);
  if (e != cudaSuccess) return e;
  chunk_grads_kernel<TB><<<dim3(p.nc * nT, p.H, B), kThreads, L.total, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_rows_kernel<TB><<<dim3(p.S, B), kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dA_scan_kernel<<<dim3(p.nc, p.H, B), kThreads, p.Q * sizeof(double), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16. x, dA, y and state are float32.
// Strides are in elements. `state` may be null. `cum` ((B, H, S) doubles) and
// `states` ((B, H, S / Q, N, P) floats) are scratch the caller allocates.
// Makes three launches. Returns a cudaError_t as int.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dA, const void* b, const void* c, void* y,
    void* state, void* cum, void* states, int B, int S, int H, int G, int P,
    int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int bc_dtype, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || H < 1 || H > 65535 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
      S % Q != 0 || bc_dtype < 0 || bc_dtype > 1 || cum == nullptr ||
      states == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  Params p;
  p.x = static_cast<const float*>(x); p.dA = static_cast<const float*>(dA);
  p.b = b; p.c = c; p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.cum = static_cast<double*>(cum); p.states = static_cast<float*>(states);
  p.S = S; p.H = H; p.G = G; p.rep = H / G; p.P = P; p.N = N; p.Q = Q; p.nc = S / Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.a_sb = a_sb; p.a_ss = a_ss; p.a_sh = a_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  p.x_vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            x_sb % 4 == 0 && x_ss % 4 == 0 && x_sh % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch<float>(p, B, s);
  return launch<__nv_bfloat16>(p, B, s);
}

// The backward of ssd_scan_fwd. x, B, C and their strides as the forward
// took them; cum and states the forward's scratch after its launches; state
// the forward's final state (read only when dstate is not null); dy a
// contiguous fp32 (B, S, H, P); dstate a contiguous fp32 (B, H, N, P) or
// null for zero. Writes dx (B, S, H, P) and ddA (B, S, H), fp32, and dB, dC
// (B, S, G, N) in B's type, all contiguous. dstates ((B, H, S / Q, N, P)),
// dbh and dch ((B, S, H, N)) and dcum ((B, H, S)), fp32, are scratch the
// caller allocates. Makes five launches. Returns a cudaError_t as int.
extern "C" int ssd_scan_bwd(
    const void* x, const void* b, const void* c, const void* cum,
    const void* states, const void* state, const void* dy, const void* dstate,
    void* dx, void* ddA, void* db, void* dc, void* dstates, void* dbh, void* dch,
    void* dcum, int B, int S, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int bc_dtype, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || H < 1 || H > 65535 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
      S % Q != 0 || bc_dtype < 0 || bc_dtype > 1 || cum == nullptr ||
      states == nullptr || dy == nullptr || dstates == nullptr || dbh == nullptr ||
      dch == nullptr || dcum == nullptr || (dstate != nullptr && state == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  BwdParams p;
  p.x = static_cast<const float*>(x); p.b = b; p.c = c;
  p.cum = static_cast<const double*>(cum);
  p.states = static_cast<const float*>(states);
  p.state = static_cast<const float*>(state);
  p.dy = static_cast<const float*>(dy);
  p.dstate = static_cast<const float*>(dstate);
  p.dx = static_cast<float*>(dx); p.ddA = static_cast<float*>(ddA);
  p.db = db; p.dc = dc;
  p.dstates = static_cast<float*>(dstates);
  p.dbh = static_cast<float*>(dbh); p.dch = static_cast<float*>(dch);
  p.dcum = static_cast<float*>(dcum);
  p.S = S; p.H = H; p.G = G; p.rep = H / G; p.P = P; p.N = N; p.Q = Q; p.nc = S / Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch_bwd<float>(p, B, s);
  return launch_bwd<__nv_bfloat16>(p, B, s);
}
