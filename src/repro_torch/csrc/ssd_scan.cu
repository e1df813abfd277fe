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
// What bounds it: operations, on the tensor cores. Per row and head the
// chunked form runs dy x^T and (C B^T o L)^T dy (Q*P flops each over the
// causal half), (dy x^T o L)^T C and (dy x^T o L) B (Q*N each), four
// cross-chunk products (2*N*P each: D_c, G_c^T B, G_c x, h_c dy) and C B^T's
// Q*N per row once per group; counted with two split terms where B or C is
// a factor and three elsewhere, that is 0.10 ms at the mamba2 train shape at
// 989 TF/s, against its bytes' 0.08 ms (the reverse recurrence would need
// 14*N*P fp32 flops, 0.45 ms).
//
// Split products: every product runs on mma.sync m16n8k16 (bf16 operands,
// fp32 sums) from ldmatrix fragments. An fp32 operand is held as bf16
// pieces, hi = bf16(a) and each next piece bf16 of what the ones before
// leave; a product adds the pieces' products i.j with i + j below the larger
// piece count (Pieces below). With bf16 B and C (one exact piece): dy x^T
// and the four cross-chunk products in three pieces (six terms; three by B
// or C), because d cum = C.dC - B.dB cancels and d dA sums up to a chunk of
// it; T1^T dy, T2^T C and T2 B, which only reach dx, dB and dC, in two. With
// fp32 B and C every operand in three. ref.ssd_bwd_tiles emulates these
// products on the CPU: 4e-6 to 7e-6 of the gradients' norms and within the
// fp32 elementwise tolerances at slow decay, where two pieces throughout
// read above them and bf16 x and dy 2e-3.
//
// Design: five launches, each parallel over chunks (or rows), no atomics, so
// two runs give equal bits.
//  1. chunk_dstate, one block per (batch, chunk, 64 columns of P, head), a
//     warp per 16 rows of N: D_c = C^T (e o dy) into `dstates`, the next
//     64-row slab copied by cp.async while the current one is multiplied.
//  2. dstate_pass, one thread per (batch, head, n, p): walks the chunks in
//     reverse and overwrites D_c with G_c.
//  3. chunk_grads, one block per (batch, chunk, 64-row tile r, group, block
//     of 1, 2 or 4 heads of the group), 16 warps: dx and dB of rows r over
//     the column slabs t >= r (phase A), then dC of rows r over the slabs
//     s <= r (phase B), so every block runs nT + 1 slabs.
//     C B^T is formed once per slab for the block's heads; dy x^T in each
//     phase (a scratch of phase A's dC partials would move more bytes than
//     the products it saves). Each (slab, head) item's raw rows arrive by
//     cp.async while the item before is multiplied, and are split into
//     pieces once; T1 = (C B^T) o L and T2 = (dy x^T) o L go through shared
//     memory in pieces (fp32 with fp32 B/C, split as loaded). The (N, P)
//     states of the cross-chunk terms stream through the same region. dB and
//     dC are summed over the block's heads in registers; d cum per head
//     comes from row sums of M = (C B^T) o (dy x^T) o L and the cross-chunk
//     terms' dot products, one writer per slot. One block an SM (187 KB of
//     shared memory at the mamba2 shape, 221 KB at zamba2's). The caller
//     picks the heads a block and the ring among the built instances
//     (kernels/ssd_scan.py::plan_bwd): the most heads whose shared memory
//     fits 227 KB with the ring, fewer where the grid would leave SMs idle;
//     one head without the ring where even that does not fit.
//  4. reduce_rows, one block per (batch, row): the head blocks' dB and dC
//     summed in order, cast to B's type.
//  5. dA_scan, one block per (batch, chunk, head): <h_{c+1}, G_c> in a fixed
//     order, then the reverse running sum of d cum in fp64.
// cum stays fp64 from the forward and each tile's decays are differences
// to its first row; the exponent above the diagonal is never evaluated.

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

typedef __nv_bfloat16 bf16;

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
  float* dbp;              // (Bsz, S, G * nHB, N) scratch: dB summed over a block's heads
  float* dcp;              // (Bsz, S, G * nHB, N) scratch: the same for dC
  float* dcum;             // (Bsz, H, S) scratch: d cum per head
  int S, H, G, rep, P, N, Q, nc, nHB;   // nHB: chunk_grads blocks per group
  bool x_vec, y_vec, b_vec, c_vec;      // 16-byte cp.async rows of x, dy, B, C
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// ---------------------------------------------------------------------------
// Tensor-core products of split operands
// ---------------------------------------------------------------------------

// An fp32 operand runs on the tensor cores as bf16 pieces: hi = bf16(a),
// then each next piece bf16 of what the pieces before it leave. Two pieces
// carry 16 of a's 24 bits, three all of them. A product of an operand of kPA
// pieces by one of kPB adds the pieces' products i.j with i + j below the
// larger count: hi.hi, lo.hi, hi.lo for two pieces each (the dropped lo.lo
// is 2^-16 of the whole), six terms for three pieces each, fewer where one
// operand is a bf16 B or C (one piece).
constexpr int kMaxPieces = 3;

// A 64-row operand tile in shared memory, pre-split: bf16 rows of stride
// `ld` (the width plus 8, so that ldmatrix's eight rows fall in distinct
// banks), piece i at p[i].
struct Op {
  const bf16* p[kMaxPieces];
  int ld;
};

__device__ __forceinline__ Op make_op(const bf16* base, int piece_elems, int ld) {
  return Op{{base, base + piece_elems, base + 2 * piece_elems}, ld};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  // not volatile: a pure function of its registers, which the compiler may
  // interleave with the other accumulators' products
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k step of 16: acc[nt] += A . B(k step, columns n0 + 8*nt .. +7) for the
// A fragments `a` (kPA pieces) and B, stored at B[n][k], or at B[k][n] with
// kBT, loaded by ldmatrix (.trans for the second layout) from offset `bo`.
// Two pairs of n tiles at a time, the terms outermost: the four products in
// a row go to four accumulators, so that one's latency hides behind the
// next ones.
template <int NT, bool kBT, int kPA, int kPB>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const uint32_t (&a)[kPA][4],
                                         const Op& B, int bo) {
  constexpr int kTerms = kPA > kPB ? kPA : kPB;
  constexpr int kGroup = NT / 2 < 2 ? NT / 2 : 2;        // pairs of n tiles a round
  const int b_pair = kBT ? 16 : 16 * B.ld;               // the next pair of n tiles
#pragma unroll
  for (int g0 = 0; g0 < NT / 2; g0 += kGroup) {
    uint32_t b[kGroup][kPB][4];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
#pragma unroll
      for (int j = 0; j < kPB; ++j) ldsm4<kBT>(b[q][j], B.p[j] + bo + (g0 + q) * b_pair);
#pragma unroll
    for (int i = 0; i < kPA; ++i)
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        if (i + j >= kTerms) continue;
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          mma_bf16(acc[2 * (g0 + q)], a[i], b[q][j][0], b[q][j][1]);
          mma_bf16(acc[2 * (g0 + q) + 1], a[i], b[q][j][2], b[q][j][3]);
        }
      }
  }
}

// acc[nt] += A(rows m0 .. m0+15, k < K) . B(k < K, columns n0 + 8*nt .. +7) on
// mma.sync m16n8k16 (bf16 products, fp32 sums), A pre-split: A(m, k) at
// A[m][k], or at A[k][m] with kAT. Value r of tile nt sits at row m0 +
// lane/4 + 8*(r/2), column n0 + 8*nt + 2*(lane%4) + r%2.
template <int NT, int K, bool kAT, bool kBT, int kPA, int kPB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const Op& A, const Op& B,
                                          int m0, int n0) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "n tiles in pairs, k in steps of 16");
  const int lane = threadIdx.x & 31, j = lane >> 3, r8 = lane & 7;
  const int a_off = kAT ? ((j >> 1) * 8 + r8) * A.ld + m0 + (j & 1) * 8
                        : (m0 + (j & 1) * 8 + r8) * A.ld + (j >> 1) * 8;
  const int b_off = kBT ? ((j & 1) * 8 + r8) * B.ld + n0 + (j >> 1) * 8
                        : (n0 + (j >> 1) * 8 + r8) * B.ld + (j & 1) * 8;
  const int a_step = kAT ? 16 * A.ld : 16;      // one k step of 16
  const int b_step = kBT ? 16 * B.ld : 16;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a[kPA][4];
#pragma unroll
    for (int i = 0; i < kPA; ++i) ldsm4<kAT>(a[i], A.p[i] + a_off + ks * a_step);
    mma_step<NT, kBT, kPA, kPB>(acc, a, B, b_off + ks * b_step);
  }
}

// The same with A an fp32 tile (row stride lda, A(m, k) at A[m][k]), split
// into kPA pieces as its fragments are loaded.
template <int NT, int K, bool kBT, int kPA, int kPB>
__device__ __forceinline__ void warp_gemm_f32a(float (&acc)[NT][4], const float* A, int lda,
                                               const Op& B, int m0, int n0) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "n tiles in pairs, k in steps of 16");
  const int lane = threadIdx.x & 31, j = lane >> 3, r8 = lane & 7;
  const float* ar = A + (m0 + (lane >> 2)) * lda + 2 * (lane & 3);
  const int b_off = kBT ? ((j & 1) * 8 + r8) * B.ld + n0 + (j >> 1) * 8
                        : (n0 + (j >> 1) * 8 + r8) * B.ld + (j & 1) * 8;
  const int b_step = kBT ? 16 * B.ld : 16;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    // a0: (row, k), a1: (row + 8, k), a2: (row, k + 8), a3: (row + 8, k + 8)
    const float* base = ar + ks * 16;
    float2 v[4] = {*reinterpret_cast<const float2*>(base),
                   *reinterpret_cast<const float2*>(base + 8 * lda),
                   *reinterpret_cast<const float2*>(base + 8),
                   *reinterpret_cast<const float2*>(base + 8 * lda + 8)};
    uint32_t a[kPA][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < kPA; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[r].x, v[r].y);
        a[i][r] = *reinterpret_cast<const uint32_t*>(&h);
        const float2 f = __bfloat1622float2(h);
        v[r].x -= f.x;
        v[r].y -= f.y;
      }
    mma_step<NT, kBT, kPA, kPB>(acc, a, B, b_off + ks * b_step);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
}

// Two neighbouring values at idx as kP pieces, piece i at base + i*stride.
template <int kP>
__device__ __forceinline__ void split_store(bf16* base, int stride, int idx, float a, float b) {
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(base + i * stride + idx) = h;
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
  }
}

// A warp's 16 x 8*NT accumulator tile (at m0, n0) into kP pieces (stride
// `stride` elements) of an operand tile.
template <int NT, int kP>
__device__ __forceinline__ void store_pieces(const float (&v)[NT][4], bf16* base, int stride,
                                             int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * q4;
    split_store<kP>(base, stride, (m0 + g) * ld + col, v[nt][0], v[nt][1]);
    split_store<kP>(base, stride, (m0 + g + 8) * ld + col, v[nt][2], v[nt][3]);
  }
}

// A warp's 16 x 8*NT accumulator tile (at m0, n0) into an fp32 tile.
template <int NT>
__device__ __forceinline__ void store_f32(const float (&v)[NT][4], float* dst, int ld,
                                          int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * q4;
    *reinterpret_cast<float2*>(dst + (m0 + g) * ld + col) = make_float2(v[nt][0], v[nt][1]);
    *reinterpret_cast<float2*>(dst + (m0 + g + 8) * ld + col) = make_float2(v[nt][2], v[nt][3]);
  }
}

// kRows rows [q0, q0 + kRows) of a row-major matrix at src (row stride ss),
// zero from row Q and column `width` on, into a tile of width kW (stride
// kW + 8): kP bf16 pieces at dst (piece stride kRows * (kW + 8)), or, with
// kP = 0, fp32 at dst.
template <int kRows, int kW, int kP, typename T, typename D>
__device__ __forceinline__ void load_tile(D* dst, const T* src, int64_t ss, int q0, int Q,
                                          int width) {
  constexpr int ld = kW + 8;
  for (int idx = threadIdx.x; idx < kRows * kW / 2; idx += blockDim.x) {
    const int r = idx / (kW / 2), col = 2 * (idx % (kW / 2));
    float a = 0.f, b = 0.f;
    if (q0 + r < Q) {
      const T* s = src + (q0 + r) * ss;
      if (col < width) a = to_f(s[col]);
      if (col + 1 < width) b = to_f(s[col + 1]);
    }
    if constexpr (kP == 0) {
      *reinterpret_cast<float2*>(dst + r * ld + col) = make_float2(a, b);
    } else {
      split_store<kP>(dst, kRows * ld, r * ld + col, a, b);
    }
  }
}

// Bytes of a 64-row tile of width w: one bf16 piece, or fp32.
__host__ __device__ constexpr size_t op_bytes(int w) { return kTile * (w + 8) * 2; }
__host__ __device__ constexpr size_t f32_bytes(int w) { return kTile * (w + 8) * 4; }

// 8 bytes by cp.async, zero-filled where not valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 8 : 0));
}

// kRows rows of fp32 as load_tile, by 16-byte loads, four in flight a thread
// before they are split and stored; `vec`: 16-byte aligned rows (width and
// row stride multiples of 4), else load_tile's pairs.
template <int kRows, int kW, int kP>
__device__ __forceinline__ void load_tile_f32(bf16* dst, const float* src, int64_t ss, int q0,
                                              int Q, int width, bool vec) {
  if (!vec) {
    load_tile<kRows, kW, kP>(dst, src, ss, q0, Q, width);
    return;
  }
  constexpr int ld = kW + 8, kTotal = kRows * kW / 4;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < kTotal; base += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * step, r = idx / (kW / 4), col = 4 * (idx % (kW / 4));
      v[u] = idx < kTotal && q0 + r < Q && col < width ? ld4(src + (q0 + r) * ss + col)
                                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * step, r = idx / (kW / 4), col = 4 * (idx % (kW / 4));
      if (idx < kTotal) {
        split_store<kP>(dst, kRows * ld, r * ld + col, v[u].x, v[u].y);
        split_store<kP>(dst, kRows * ld, r * ld + col + 2, v[u].z, v[u].w);
      }
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 64 rows [q0, q0 + 64) of a row-major matrix (row stride ss) into a raw
// 64 x kW tile, zero from row Q and column `width` on: 16-byte cp.async
// with `vec` (width a multiple of 16 bytes), else plain loads.
template <typename T, int kW>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t ss, int q0, int Q,
                                           int width, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    for (int idx = threadIdx.x; idx < kTile * kW / kV; idx += blockDim.x) {
      const int r = idx / (kW / kV), col = kV * (idx % (kW / kV));
      const bool ok = q0 + r < Q && col < width;
      cp_async16(dst + r * kW + col, ok ? src + (q0 + r) * ss + col : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kW; idx += blockDim.x) {
      const int r = idx / kW, col = idx % kW;
      dst[r * kW + col] = q0 + r < Q && col < width ? src[(q0 + r) * ss + col] : T(0.f);
    }
  }
}

// A raw 64 x kW tile into kP pieces of stride 64 * (kW + 8): fp32 split,
// bf16 copied (one piece).
template <int kW, int kP, typename T>
__device__ __forceinline__ void convert_raw(const T* src, bf16* dst) {
  constexpr int ld = kW + 8;
  if constexpr (sizeof(T) == 2) {
    for (int idx = threadIdx.x; idx < kTile * kW / 8; idx += blockDim.x) {
      const int r = idx / (kW / 8), col = 8 * (idx % (kW / 8));
      *reinterpret_cast<uint4*>(dst + r * ld + col) =
          *reinterpret_cast<const uint4*>(src + r * kW + col);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kW / 4; idx += blockDim.x) {
      const int r = idx / (kW / 4), col = 4 * (idx % (kW / 4));
      const float4 v = ld4(src + r * kW + col);
      split_store<kP>(dst, kTile * ld, r * ld + col, v.x, v.y);
      split_store<kP>(dst, kTile * ld, r * ld + col + 2, v.z, v.w);
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pieces by route, that is by B/C's type (kernels/ssd_scan.py ROUTE_PIECES
// holds the same numbers, and a test reads them from here): kF of an fp32
// operand as stored, and as dy x^T and the cross-chunk products use it
// (three: d dA sums up to a chunk of d cum, C.dC - B.dB, whose terms
// cancel; two pieces there leave it above its fp32 tolerance at slow
// decay); kT of the decayed tiles T1, T2 and of dy and x in their products,
// which only reach dx, dB and dC; kBC of B and C (one piece of bf16, exact).
template <typename TB> struct Pieces;
template <> struct Pieces<__nv_bfloat16> {     // route "bf16_bc"
  static constexpr int kF = 3, kT = 2, kBC = 1;
};
template <> struct Pieces<float> {             // route "split_bc"
  static constexpr int kF = 3, kT = 3, kBC = 3;
};

// ---------------------------------------------------------------------------
// 1. chunk_dstate: D_c = C^T (e o dy), e = exp(cum)
// ---------------------------------------------------------------------------

// A block holds all N (kWN) rows of the state tile, a warp 16 rows and half
// of the 64 columns: 8 warps at N <= 64, 16 at N <= 128.
__host__ __device__ constexpr int dstate_warps(int wn) { return wn / 16 * 2; }

// Its shared memory: the raw slab (C rows, dy rows, cum) that cp.async
// fills while the last one is multiplied, then C and e o dy in pieces.
__host__ __device__ constexpr size_t dstate_smem(bool bf16bc, int wn) {
  return static_cast<size_t>(kTile) * wn * (bf16bc ? 2 : 4) + kTile * kTile * 4 + kTile * 8 +
         (bf16bc ? 1 : 3) * op_bytes(wn) + 3 * op_bytes(kTile);
}

// One block per (batch, chunk, 64 columns of P, head).
template <typename TB, int kWN>
__global__ void __launch_bounds__(32 * dstate_warps(kWN)) chunk_dstate_kernel(const BwdParams p) {
  constexpr int kPF = Pieces<TB>::kF, kPBC = Pieces<TB>::kBC;
  constexpr int ldn = kWN + 8, ldt = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TB* raw_c = reinterpret_cast<TB*>(smem);                                   // 64 x kWN
  float* raw_y = reinterpret_cast<float*>(smem + kTile * kWN * sizeof(TB));  // 64 x 64
  double* raw_cum = reinterpret_cast<double*>(raw_y + kTile * kTile);         // 64
  bf16* Cs = reinterpret_cast<bf16*>(raw_cum + kTile);    // C rows t, kPBC pieces
  bf16* Ys = Cs + kPBC * kTile * ldn;                     // e o dy rows t, kPF pieces
  const Op A = make_op(Cs, kTile * ldn, ldn), Bop = make_op(Ys, kTile * ldt, ldt);

  const int N = p.N, P = p.P, Q = p.Q;
  const int nP = (P + kTile - 1) / kTile;
  const int c = blockIdx.x / nP, p0 = (blockIdx.x % nP) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  const int r0 = c * Q;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const double* cumc = p.cum + bh * p.S + r0;
  const TB* cb = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg + r0 * p.c_ss;
  const float* yb = p.dy + ((static_cast<int64_t>(b) * p.S + r0) * p.H + h) * P + p0;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp >> 1), c0 = 32 * (warp & 1);

  auto stage = [&](int t0) {
    stage_rows<TB, kWN>(raw_c, cb, p.c_ss, t0, Q, N, p.c_vec);
    stage_rows<float, kTile>(raw_y, yb, y_ss, t0, Q, P - p0, p.y_vec);
    const int t = threadIdx.x;
    if (t < kTile) cp_async8(raw_cum + t, t0 + t < Q ? cumc + t0 + t : cumc, t0 + t < Q);
    cp_async_commit();
  };

  float acc[4][4];
  zero_acc(acc);
  stage(0);
  for (int t0 = 0; t0 < Q; t0 += kTile) {
    cp_async_wait_all();
    __syncthreads();                      // the slab landed; the last one's pieces are consumed
    convert_raw<kWN, kPBC>(raw_c, Cs);
    for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += blockDim.x) {
      const int t = idx / (kTile / 4), col = 4 * (idx % (kTile / 4));
      const float e = t0 + t < Q ? expf(static_cast<float>(raw_cum[t])) : 0.f;
      const float4 v = ld4(raw_y + t * kTile + col);
      split_store<kPF>(Ys, kTile * ldt, t * ldt + col, v.x * e, v.y * e);
      split_store<kPF>(Ys, kTile * ldt, t * ldt + col + 2, v.z * e, v.w * e);
    }
    __syncthreads();                      // the pieces are ready; the raw slab is free
    if (t0 + kTile < Q) stage(t0 + kTile);
    // D[n][p] += sum_t C[t][n] (e dy)[t][p]: both operands stored t-major
    warp_gemm<4, kTile, true, true, kPBC, kPF>(acc, A, Bop, m0, c0);
  }

  const int lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  float* st = p.dstates + (bh * p.nc + c) * N * P;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = m0 + gq + 8 * (r >> 1), pp = p0 + c0 + 8 * nt + 2 * q4 + (r & 1);
      if (n < N && pp < P) st[n * P + pp] = acc[nt][r];
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

constexpr size_t kMaxBlockSmem = 232448;   // 227 KB: the most one block may use

// Warps of a chunk_grads block: 16, four to a scheduler, so that one warp's
// waits on shared memory and barriers hide behind the others'; each owns 16
// rows of a 64-row product and a quarter of its columns.
constexpr int kGradWarps = 16;

// Shared memory of chunk_grads at widths kWP, kWN with kHB heads a block,
// in bytes from its start: each head's own rows of x (phase B: dy) in
// pieces; the own rows of B (C), bf16 or fp32; a slab of C (B) and of dy
// (x) in pieces; the decayed tiles T1 and T2 in fp32 (or as many bytes of
// bf16 pieces); with the ring, the raw slab that the copies land in; per
// head four row vectors and each column group's d cum sums.
// kernels/ssd_scan.py::grad_smem reckons the same bytes to plan with.
template <typename TB, int kWP, int kWN, int kHB, bool kRing>
struct GradLayout {
  static constexpr bool kBf16 = sizeof(TB) == 2;
  static constexpr size_t kOwnA = kHB * Pieces<TB>::kF * op_bytes(kWP);
  static constexpr size_t kOwn = kOwnA + (kBf16 ? op_bytes(kWN) : f32_bytes(kWN));
  static constexpr size_t kSlab = Pieces<TB>::kBC * op_bytes(kWN) + Pieces<TB>::kF * op_bytes(kWP);
  static constexpr size_t kTT = 2 * f32_bytes(kTile);
  static constexpr size_t kRawB = kRing ? static_cast<size_t>(kTile) * kWN * sizeof(TB) : 0;
  static constexpr size_t kRaw = kRing ? kRawB + static_cast<size_t>(kTile) * kWP * 4 : 0;
  static constexpr size_t kVec = static_cast<size_t>(kHB) * (4 + kGradWarps / 4) * kTile * 4;
  static constexpr size_t kBytes = kOwn + kSlab + kTT + kRaw + kVec;
};

// acc += (the own rows of B or C) . B: one bf16 piece, or fp32 split in three.
template <typename TB, int NT, int K, bool kBT, int kPB>
__device__ __forceinline__ void gemm_own_bc(float (&acc)[NT][4], const void* own, int ld,
                                            const Op& B, int m0, int n0) {
  if constexpr (sizeof(TB) == 2) {
    warp_gemm<NT, K, false, kBT, 1, kPB>(acc, make_op(static_cast<const bf16*>(own), 0, ld),
                                         B, m0, n0);
  } else {
    warp_gemm_f32a<NT, K, kBT, 3, kPB>(acc, static_cast<const float*>(own), ld, B, m0, n0);
  }
}

// One block per (batch, chunk, 64-row tile r, group, block of kHB heads).
// Phase A: dx and dB of the rows s of tile r, over the slabs t >= r; phase
// B: dC of the rows t of tile r, over the slabs s <= r; nT + 1 slabs for
// every block. A warp owns rows 16*(w%4) .. +15 of each 64-row product and
// a quarter of its columns. dB and dC are summed over the block's heads in
// registers; d cum per head is summed from the products' row sums.
template <typename TB, int kWP, int kWN, int kHB, bool kRing>
__global__ void __launch_bounds__(32 * kGradWarps, 1) chunk_grads_kernel(const BwdParams p) {
  using Layout = GradLayout<TB, kWP, kWN, kHB, kRing>;
  constexpr bool kBf16 = Layout::kBf16;
  constexpr int kPF = Pieces<TB>::kF, kPT = Pieces<TB>::kT, kPBC = Pieces<TB>::kBC;
  constexpr int ldp = kWP + 8, ldn = kWN + 8, ldt = kTile + 8;
  constexpr int kOpP = kTile * ldp, kOpN = kTile * ldn;     // elements of a piece
  constexpr int kCG = kGradWarps / 4;                         // column groups
  constexpr int kNTT = kTile / (8 * kCG);                     // n tiles of a 64-wide tile
  constexpr int kNTP = kWP / (8 * kCG), kNTN = kWN / (8 * kCG);
  // T1, T2 pre-split in bf16 pieces (bf16 route), or fp32 and split as loaded
  constexpr bool kTPre = kBf16;
  constexpr size_t kOwnA = Layout::kOwnA, kOwn = Layout::kOwn, kSlab = Layout::kSlab;
  constexpr size_t kTT = Layout::kTT, kRawB = Layout::kRawB, kRaw = Layout::kRaw;
  // a whole (N, P) state, in pieces, over the slab operands and T1, T2
  static_assert(static_cast<size_t>(kPF) * kWN * ldp * 2 <= kSlab + kTT, "state tile fits");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* own_a = reinterpret_cast<bf16*>(smem);                // kHB x kPF pieces
  void* own_b = smem + kOwnA;                                 // bf16, or fp32
  unsigned char* stream = smem + kOwn;
  bf16* slab_b = reinterpret_cast<bf16*>(stream);             // kPBC pieces
  bf16* slab_a = slab_b + kPBC * kOpN;                        // kPF pieces
  float* t1f = reinterpret_cast<float*>(stream + kSlab);      // 64 x ldt
  float* t2f = t1f + kTile * ldt;
  bf16* t1b = reinterpret_cast<bf16*>(stream + kSlab);        // kPT pieces, 64 x ldt
  bf16* t2b = t1b + kPT * kTile * ldt;
  static_assert(!kTPre || 2 * kPT * op_bytes(kTile) <= kTT, "T pieces fit");
  TB* raw_b = reinterpret_cast<TB*>(stream + kSlab + kTT);
  float* raw_a = reinterpret_cast<float*>(stream + kSlab + kTT + kRawB);
  float* vec = reinterpret_cast<float*>(stream + kSlab + kTT + kRaw);
  float* c_own = vec;                       // [kHB][64] cum less cum at row t0
  float* c_slab = c_own + kHB * kTile;      // [kHB][64] the same at a slab's rows
  float* w_own = c_slab + kHB * kTile;      // [kHB][64] exp(cum_Q - cum)
  float* e_own = w_own + kHB * kTile;       // [kHB][64] exp(cum)
  float* red = e_own + kHB * kTile;         // [kCG][kHB][64] d cum sums
  const Op slab_b_op = make_op(slab_b, kOpN, ldn);
  const Op slab_a_op = make_op(slab_a, kOpP, ldp);
  const Op state_op = make_op(slab_b, kWN * ldp, ldp);        // aliases the slab operands
  auto own_a_op = [&](int hh) { return make_op(own_a + hh * kPF * kOpP, kOpP, ldp); };

  const int N = p.N, P = p.P, Q = p.Q, S = p.S, H = p.H;
  const int nT = (Q + kTile - 1) / kTile;
  const int c = blockIdx.x / nT, r = blockIdx.x % nT, t0 = r * kTile;
  const int g = blockIdx.y / p.nHB, hb = blockIdx.y % p.nHB;
  const int h0 = g * p.rep + hb * kHB;
  const int nh = min(kHB, p.rep - hb * kHB);
  const int b = blockIdx.z;
  const int r0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const int m0 = 16 * (warp & 3);                  // the warp's 16 rows
  const int nt0 = (kTile / kCG) * (warp >> 2);     // its columns of a 64 x 64 tile
  const int np0 = (kWP / kCG) * (warp >> 2), nn0 = (kWN / kCG) * (warp >> 2);
  const TB* bbase = static_cast<const TB*>(p.b) + b * p.b_sb + g * p.b_sg + r0 * p.b_ss;
  const TB* cbase = static_cast<const TB*>(p.c) + b * p.c_sb + g * p.c_sg + r0 * p.c_ss;
  const int64_t y_ss = static_cast<int64_t>(H) * P;
  const int64_t NP = static_cast<int64_t>(N) * P;
  auto x_head = [&](int hh) { return p.x + b * p.x_sb + (h0 + hh) * p.x_sh + r0 * p.x_ss; };
  auto y_head = [&](int hh) {
    return p.dy + ((static_cast<int64_t>(b) * S + r0) * H + h0 + hh) * P;
  };
  auto cum_head = [&](int hh) {
    return p.cum + (static_cast<int64_t>(b) * H + h0 + hh) * S + r0;
  };
  auto bh_of = [&](int hh) { return static_cast<int64_t>(b) * H + h0 + hh; };
  // the own rows of B (phase A) or C (phase B)
  auto load_own_b = [&](const TB* src, int64_t ss) {
    if constexpr (kBf16) {
      load_tile<kTile, kWN, 1>(static_cast<bf16*>(own_b), src, ss, t0, Q, N);
    } else {
      load_tile<kTile, kWN, 0>(static_cast<float*>(own_b), src, ss, t0, Q, N);
    }
  };

  // the own rows' decays, per head; the d cum sums start at zero
  for (int idx = threadIdx.x; idx < kHB * kTile; idx += blockDim.x) {
    const int hh = idx / kTile, s = idx % kTile;
    const bool ok = hh < nh && t0 + s < Q;
    const double* cm = cum_head(ok ? hh : 0);
    c_own[idx] = ok ? static_cast<float>(cm[t0 + s] - cm[t0]) : 0.f;
    w_own[idx] = ok ? expf(static_cast<float>(cm[Q - 1] - cm[t0 + s])) : 0.f;
    e_own[idx] = ok ? expf(static_cast<float>(cm[t0 + s])) : 0.f;
  }
  for (int idx = threadIdx.x; idx < kCG * kHB * kTile; idx += blockDim.x) red[idx] = 0.f;
  // a slab's cum, less cum at row t0, for c_slab: thread h*64 + t holds row
  // t of head h, read ahead of its slab into a register
  const bool cum_thread = static_cast<int>(threadIdx.x) < nh * kTile;
  const int cum_t = threadIdx.x % kTile;
  const double* cum_mine = cum_head(cum_thread ? threadIdx.x / kTile : 0);
  const double cum_base = cum_mine[t0];
  auto cum_at = [&](int q0) {
    return cum_thread && q0 + cum_t < Q ? cum_mine[q0 + cum_t] : 0.0;
  };
  auto set_c_slab = [&](int q0, double v) {
    if (cum_thread) c_slab[threadIdx.x] = q0 + cum_t < Q ? static_cast<float>(v - cum_base) : 0.f;
  };

  // d cum of rows m0 + gq (v0) and m0 + gq + 8 (v1) of head hh: this warp's
  // sums over its columns, added by the first lane of each quad to its
  // column group's slot (one writer a slot)
  auto add_rows = [&](int hh, float v0, float v1) {
    v0 = quad_sum(v0);
    v1 = quad_sum(v1);
    if (q4 == 0) {
      red[((warp >> 2) * kHB + hh) * kTile + m0 + gq] += v0;
      red[((warp >> 2) * kHB + hh) * kTile + m0 + gq + 8] += v1;
    }
  };
  // sum_n own_b[row][n] * v[row][n] over this warp's values, rows m0+gq, +8
  auto dot_own_b = [&](const float (&v)[kNTN][4], float& d0, float& d1) {
    d0 = d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTN; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int idx = (m0 + gq + 8 * half) * ldn + nn0 + 8 * nt + 2 * q4;
        float2 bv;
        if constexpr (kBf16) {
          bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(own_b) + idx));
        } else {
          bv = *reinterpret_cast<const float2*>(static_cast<const float*>(own_b) + idx);
        }
        const float s = bv.x * v[nt][2 * half] + bv.y * v[nt][2 * half + 1];
        if (half == 0) d0 += s; else d1 += s;
      }
  };
  // a state (N, P) into the stream region, in pieces, rows n
  auto load_state = [&](const float* st) {
    load_tile_f32<kWN, kWP, kPF>(slab_b, st, P, 0, N, P, P % 4 == 0);
  };

  // ---- phase A: dx and dB of the block's rows s ---------------------------
  for (int hh = 0; hh < nh; ++hh)
    load_tile_f32<kTile, kWP, kPF>(own_a + hh * kPF * kOpP, x_head(hh), p.x_ss, t0, Q, P,
                                   p.x_vec);
  load_own_b(bbase, p.b_ss);

  float accX[kHB][kNTP][4], accB[kNTN][4];
#pragma unroll
  for (int k = 0; k < kHB; ++k) zero_acc(accX[k]);
  zero_acc(accB);
  // the first item's raw slab lands while the cross-chunk terms run
  auto stage_a = [&](int i) {
    const int j = r + i / nh, hh = i % nh, q0 = j * kTile;
    if (hh == 0) stage_rows<TB, kWN>(raw_b, cbase, p.c_ss, q0, Q, N, p.c_vec);
    stage_rows<float, kWP>(raw_a, y_head(hh), y_ss, q0, Q, P, p.y_vec);
    cp_async_commit();
  };
  if constexpr (kRing) stage_a(0);
  // cross-chunk terms: dx = w o (B G_c), dB = sum over heads of w o (x G_c^T)
  for (int hh = 0; hh < nh; ++hh) {
    __syncthreads();                      // the own rows are written; the last state is consumed
    load_state(p.dstates + (bh_of(hh) * p.nc + c) * NP);
    __syncthreads();
    float tmp[kNTN][4];
    zero_acc(tmp);
    warp_gemm<kNTN, kWP, false, false, kPF, kPF>(tmp, own_a_op(hh), state_op, m0, nn0);
    float d0, d1;
    dot_own_b(tmp, d0, d1);
    const float w0 = w_own[hh * kTile + m0 + gq], w1 = w_own[hh * kTile + m0 + gq + 8];
    add_rows(hh, -w0 * d0, -w1 * d1);
#pragma unroll
    for (int nt = 0; nt < kNTN; ++nt) {
      accB[nt][0] = fmaf(w0, tmp[nt][0], accB[nt][0]);
      accB[nt][1] = fmaf(w0, tmp[nt][1], accB[nt][1]);
      accB[nt][2] = fmaf(w1, tmp[nt][2], accB[nt][2]);
      accB[nt][3] = fmaf(w1, tmp[nt][3], accB[nt][3]);
    }
#pragma unroll
    for (int k = 0; k < kHB; ++k) {
      if (k != hh) continue;
      gemm_own_bc<TB, kNTP, kWN, true, kPF>(accX[k], own_b, ldn, state_op, m0, np0);
#pragma unroll
      for (int nt = 0; nt < kNTP; ++nt) {
        accX[k][nt][0] *= w0;
        accX[k][nt][1] *= w0;
        accX[k][nt][2] *= w1;
        accX[k][nt][3] *= w1;
      }
    }
  }

  // within the chunk: items (slab j >= r, head); with the ring, the next
  // item's raw slab is copied (cp.async) while this one is multiplied
  const int items_a = (nT - r) * nh;
  float cbt[kNTT][4];                     // C B^T of the slab, [s][t]
  double next_cum = cum_at(t0);
  for (int i = 0; i < items_a; ++i) {
    const int j = r + i / nh, hh = i % nh, q0 = j * kTile;
    if constexpr (kRing) {
      cp_async_wait_all();
      __syncthreads();                    // the raw slab landed; the last operands are consumed
      if (hh == 0) convert_raw<kWN, kPBC>(raw_b, slab_b);
      convert_raw<kWP, kPF>(raw_a, slab_a);
    } else {
      __syncthreads();                    // the last operands are consumed
      if (hh == 0) load_tile<kTile, kWN, kPBC>(slab_b, cbase, p.c_ss, q0, Q, N);
      load_tile<kTile, kWP, kPF>(slab_a, y_head(hh), y_ss, q0, Q, P);
    }
    if (hh == 0) set_c_slab(q0, next_cum);
    __syncthreads();                      // the operands are ready; the raw slab is free
    if (i + 1 < items_a) {
      if constexpr (kRing) stage_a(i + 1);
      if ((i + 1) % nh == 0) next_cum = cum_at(q0 + kTile);
    }
    if (hh == 0) {                        // once for the block's heads
      zero_acc(cbt);
      gemm_own_bc<TB, kNTT, kWN, false, kPBC>(cbt, own_b, ldn, slab_b_op, m0, nt0);
    }
    float dxt[kNTT][4], t1[kNTT][4];      // dy x^T, [s][t]
    zero_acc(dxt);
    warp_gemm<kNTT, kWP, false, false, kPF, kPF>(dxt, own_a_op(hh), slab_a_op, m0, nt0);
    float ms[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int s = m0 + gq + 8 * (v >> 1), t = nt0 + 8 * nt + 2 * q4 + (v & 1);
        float L = 0.f;                    // never evaluated above the diagonal
        if (t0 + s <= q0 + t && q0 + t < Q)
          L = __expf(c_slab[hh * kTile + t] - c_own[hh * kTile + s]);
        t1[nt][v] = cbt[nt][v] * L;
        ms[v >> 1] += t1[nt][v] * dxt[nt][v];
        dxt[nt][v] *= L;                  // T2
      }
    add_rows(hh, -ms[0], -ms[1]);
    if constexpr (kTPre) {
      store_pieces<kNTT, kPT>(t1, t1b, kTile * ldt, ldt, m0, nt0);
      store_pieces<kNTT, kPT>(dxt, t2b, kTile * ldt, ldt, m0, nt0);
    } else {
      store_f32(t1, t1f, ldt, m0, nt0);
      store_f32(dxt, t2f, ldt, m0, nt0);
    }
    __syncthreads();                      // T1 and T2 are ready
#pragma unroll
    for (int k = 0; k < kHB; ++k) {
      if (k != hh) continue;
      if constexpr (kTPre) {
        warp_gemm<kNTP, kTile, false, true, kPT, kPT>(accX[k], make_op(t1b, kTile * ldt, ldt),
                                                      slab_a_op, m0, np0);
      } else {
        warp_gemm_f32a<kNTP, kTile, true, kPT, kPT>(accX[k], t1f, ldt, slab_a_op, m0, np0);
      }
    }
    if constexpr (kTPre) {
      warp_gemm<kNTN, kTile, false, true, kPT, kPBC>(accB, make_op(t2b, kTile * ldt, ldt),
                                                     slab_b_op, m0, nn0);
    } else {
      warp_gemm_f32a<kNTN, kTile, true, kPT, kPBC>(accB, t2f, ldt, slab_b_op, m0, nn0);
    }
  }

  // dx per head; dB summed over the block's heads
#pragma unroll
  for (int k = 0; k < kHB; ++k) {
    if (k >= nh) continue;
#pragma unroll
    for (int nt = 0; nt < kNTP; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int s = t0 + m0 + gq + 8 * (v >> 1), col = np0 + 8 * nt + 2 * q4 + (v & 1);
        if (s < Q && col < P)
          p.dx[((static_cast<int64_t>(b) * S + r0 + s) * H + h0 + k) * P + col] = accX[k][nt][v];
      }
  }
  const int nblk = p.G * p.nHB;
  const int64_t blk = static_cast<int64_t>(g) * p.nHB + hb;
#pragma unroll
  for (int nt = 0; nt < kNTN; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int s = t0 + m0 + gq + 8 * (v >> 1), col = nn0 + 8 * nt + 2 * q4 + (v & 1);
      if (s < Q && col < N)
        p.dbp[((static_cast<int64_t>(b) * S + r0 + s) * nblk + blk) * N + col] = accB[nt][v];
    }

  // ---- phase B: dC of the block's rows t ----------------------------------
  __syncthreads();                        // phase A's operands are consumed
  for (int hh = 0; hh < nh; ++hh)
    load_tile_f32<kTile, kWP, kPF>(own_a + hh * kPF * kOpP, y_head(hh), y_ss, t0, Q, P,
                                   p.y_vec);
  load_own_b(cbase, p.c_ss);              // now C's own rows
  auto stage_b = [&](int i) {
    const int j = i / nh, hh = i % nh, q0 = j * kTile;
    if (hh == 0) stage_rows<TB, kWN>(raw_b, bbase, p.b_ss, q0, Q, N, p.b_vec);
    stage_rows<float, kWP>(raw_a, x_head(hh), p.x_ss, q0, Q, P, p.x_vec);
    cp_async_commit();
  };
  if constexpr (kRing) stage_b(0);        // the raw slab is free since phase A's last item
  float accC[kNTN][4];
  zero_acc(accC);
  // cross-chunk term: dC = sum over heads of e o (dy h_c^T); the state
  // entering chunk 0 is zero
  for (int hh = 0; c > 0 && hh < nh; ++hh) {
    __syncthreads();
    load_state(p.states + (bh_of(hh) * p.nc + c) * NP);
    __syncthreads();
    float tmp[kNTN][4];
    zero_acc(tmp);
    warp_gemm<kNTN, kWP, false, false, kPF, kPF>(tmp, own_a_op(hh), state_op, m0, nn0);
    float d0, d1;
    dot_own_b(tmp, d0, d1);               // C_t . (h_c dy_t)
    const float e0 = e_own[hh * kTile + m0 + gq], e1 = e_own[hh * kTile + m0 + gq + 8];
    add_rows(hh, e0 * d0, e1 * d1);
#pragma unroll
    for (int nt = 0; nt < kNTN; ++nt) {
      accC[nt][0] = fmaf(e0, tmp[nt][0], accC[nt][0]);
      accC[nt][1] = fmaf(e0, tmp[nt][1], accC[nt][1]);
      accC[nt][2] = fmaf(e1, tmp[nt][2], accC[nt][2]);
      accC[nt][3] = fmaf(e1, tmp[nt][3], accC[nt][3]);
    }
  }

  const int items_b = (r + 1) * nh;
  float cbm[kNTT][4];                     // C B^T of the slab, [t][s]
  next_cum = cum_at(0);
  for (int i = 0; i < items_b; ++i) {
    const int j = i / nh, hh = i % nh, q0 = j * kTile;
    if constexpr (kRing) {
      cp_async_wait_all();
      __syncthreads();
      if (hh == 0) convert_raw<kWN, kPBC>(raw_b, slab_b);
      convert_raw<kWP, kPF>(raw_a, slab_a);
    } else {
      __syncthreads();
      if (hh == 0) load_tile<kTile, kWN, kPBC>(slab_b, bbase, p.b_ss, q0, Q, N);
      load_tile<kTile, kWP, kPF>(slab_a, x_head(hh), p.x_ss, q0, Q, P);
    }
    if (hh == 0) set_c_slab(q0, next_cum);
    __syncthreads();
    if (i + 1 < items_b) {
      if constexpr (kRing) stage_b(i + 1);
      if ((i + 1) % nh == 0) next_cum = cum_at(q0 + kTile);
    }
    if (hh == 0) {
      zero_acc(cbm);
      gemm_own_bc<TB, kNTT, kWN, false, kPBC>(cbm, own_b, ldn, slab_b_op, m0, nt0);
    }
    float dxm[kNTT][4];                   // dy x^T, [t][s]
    zero_acc(dxm);
    warp_gemm<kNTT, kWP, false, false, kPF, kPF>(dxm, own_a_op(hh), slab_a_op, m0, nt0);
    float ms[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = m0 + gq + 8 * (v >> 1), s = nt0 + 8 * nt + 2 * q4 + (v & 1);
        float L = 0.f;
        if (q0 + s <= t0 + t && t0 + t < Q)
          L = __expf(c_own[hh * kTile + t] - c_slab[hh * kTile + s]);
        dxm[nt][v] *= L;                  // T2
        ms[v >> 1] += dxm[nt][v] * cbm[nt][v];
      }
    add_rows(hh, ms[0], ms[1]);
    if constexpr (kTPre) {
      store_pieces<kNTT, kPT>(dxm, t2b, kTile * ldt, ldt, m0, nt0);
    } else {
      store_f32(dxm, t2f, ldt, m0, nt0);
    }
    __syncthreads();
    if constexpr (kTPre) {
      warp_gemm<kNTN, kTile, false, true, kPT, kPBC>(accC, make_op(t2b, kTile * ldt, ldt),
                                                     slab_b_op, m0, nn0);
    } else {
      warp_gemm_f32a<kNTN, kTile, true, kPT, kPBC>(accC, t2f, ldt, slab_b_op, m0, nn0);
    }
  }

#pragma unroll
  for (int nt = 0; nt < kNTN; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = t0 + m0 + gq + 8 * (v >> 1), col = nn0 + 8 * nt + 2 * q4 + (v & 1);
      if (t < Q && col < N)
        p.dcp[((static_cast<int64_t>(b) * S + r0 + t) * nblk + blk) * N + col] = accC[nt][v];
    }
  __syncthreads();                        // every warp's d cum sums are in
  for (int idx = threadIdx.x; idx < nh * kTile; idx += blockDim.x) {
    const int hh = idx / kTile, t = idx % kTile;
    if (t0 + t >= Q) continue;
    float acc = 0.f;
#pragma unroll
    for (int cg = 0; cg < kCG; ++cg) acc += red[(cg * kHB + hh) * kTile + t];
    p.dcum[bh_of(hh) * S + r0 + t0 + t] = acc;
  }
}

// ---------------------------------------------------------------------------
// 4. reduce_rows: dB, dC summed over each group's head blocks, in order
// ---------------------------------------------------------------------------
template <typename TB>
__global__ void __launch_bounds__(kThreads) reduce_rows_kernel(const BwdParams p) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int N = p.N, nHB = p.nHB;
  const int64_t row = static_cast<int64_t>(b) * p.S + s;
  const float* dbr = p.dbp + row * p.G * nHB * N;
  const float* dcr = p.dcp + row * p.G * nHB * N;
  TB* dbo = static_cast<TB*>(p.db) + row * p.G * N;
  TB* dco = static_cast<TB*>(p.dc) + row * p.G * N;
  for (int idx = threadIdx.x; idx < p.G * N; idx += kThreads) {
    const int g = idx / N, n = idx % N;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nHB; ++k) {
      sb += dbr[(g * nHB + k) * N + n];
      sc += dcr[(g * nHB + k) * N + n];
    }
    dbo[idx] = from_f<TB>(sb);
    dco[idx] = from_f<TB>(sc);
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

template <typename TB, int kWP, int kWN, int kHB, bool kRing>
cudaError_t launch_grads(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = GradLayout<TB, kWP, kWN, kHB, kRing>::kBytes;
  static_assert(smem <= kMaxBlockSmem, "chunk_grads fits a block's shared memory");
  static size_t allowed = 48 * 1024;      // per instantiation: the most allowed so far
  cudaError_t e = allow_smem(chunk_grads_kernel<TB, kWP, kWN, kHB, kRing>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int nT = (p.Q + kTile - 1) / kTile;
  chunk_grads_kernel<TB, kWP, kWN, kHB, kRing>
      <<<dim3(p.nc * nT, p.G * p.nHB, B), 32 * kGradWarps, smem, stream>>>(p);
  return cudaGetLastError();
}

using GradsLaunch = cudaError_t (*)(const BwdParams&, int, cudaStream_t);

// The built chunk_grads at widths kWP, kWN: kHB heads a block with the ring
// where that fits a block, and one head without the ring where even one
// head with it does not. kernels/ssd_scan.py::plan_bwd picks among them;
// any other (heads, ring) has none (null).
template <typename TB, int kWP, int kWN, int kHB>
GradsLaunch grads_with_heads(bool ring) {
  if constexpr (GradLayout<TB, kWP, kWN, kHB, true>::kBytes <= kMaxBlockSmem) {
    if (ring) return launch_grads<TB, kWP, kWN, kHB, true>;
  } else if constexpr (kHB == 1) {
    if (!ring) return launch_grads<TB, kWP, kWN, 1, false>;
  }
  return nullptr;
}

template <typename TB, int kWP, int kWN>
GradsLaunch grads_at(int heads, bool ring) {
  switch (heads) {
    case 1: return grads_with_heads<TB, kWP, kWN, 1>(ring);
    case 2: return grads_with_heads<TB, kWP, kWN, 2>(ring);
    case 4: return grads_with_heads<TB, kWP, kWN, 4>(ring);
    default: return nullptr;
  }
}

// P and N padded to 64 or 128
template <typename TB>
GradsLaunch grads_instance(int P, int N, int heads, bool ring) {
  if (P <= 64) return N <= 64 ? grads_at<TB, 64, 64>(heads, ring) : grads_at<TB, 64, 128>(heads, ring);
  return N <= 64 ? grads_at<TB, 128, 64>(heads, ring) : grads_at<TB, 128, 128>(heads, ring);
}

template <typename TB, int kWN>
cudaError_t launch_dstate(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dstate_smem(sizeof(TB) == 2, kWN);
  static size_t allowed = 48 * 1024;      // per instantiation: the most allowed so far
  cudaError_t e = allow_smem(chunk_dstate_kernel<TB, kWN>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int nP = (p.P + kTile - 1) / kTile;
  chunk_dstate_kernel<TB, kWN><<<dim3(p.nc * nP, p.H, B), 32 * dstate_warps(kWN), smem,
                                 stream>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_bwd(const BwdParams& p, int heads, bool ring, int B, cudaStream_t stream) {
  const GradsLaunch grads = grads_instance<TB>(p.P, p.N, heads, ring);
  if (grads == nullptr) return cudaErrorInvalidValue;     // before any launch
  cudaError_t e = p.N <= 64 ? launch_dstate<TB, 64>(p, B, stream)
                            : launch_dstate<TB, 128>(p, B, stream);
  if (e != cudaSuccess) return e;
  dstate_pass_kernel<<<dim3((p.N * p.P + kThreads - 1) / kThreads, p.H, B),
                       kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = grads(p, B, stream);
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
// dbp and dcp ((B, S, G * ceil(H / G / heads_per_block), N)) and dcum
// ((B, H, S)), fp32, are scratch the caller allocates. heads_per_block (1,
// 2 or 4) and ring (0 or 1) pick the chunk_grads instance
// (kernels/ssd_scan.py::plan_bwd); one that is not built is refused. Makes
// five launches. Returns a cudaError_t as int.
extern "C" int ssd_scan_bwd(
    const void* x, const void* b, const void* c, const void* cum,
    const void* states, const void* state, const void* dy, const void* dstate,
    void* dx, void* ddA, void* db, void* dc, void* dstates, void* dbp, void* dcp,
    void* dcum, int B, int S, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int heads_per_block, int ring, int bc_dtype, void* stream) {
  if (B < 0 || B > 65535 || S < 1 || H < 1 || H > 65535 || G < 1 || H % G != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxChunk ||
      S % Q != 0 || bc_dtype < 0 || bc_dtype > 1 || cum == nullptr ||
      states == nullptr || dy == nullptr || dstates == nullptr || dbp == nullptr ||
      dcp == nullptr || dcum == nullptr || (dstate != nullptr && state == nullptr) ||
      heads_per_block < 1 || ring < 0 || ring > 1) {
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
  p.dbp = static_cast<float*>(dbp); p.dcp = static_cast<float*>(dcp);
  p.dcum = static_cast<float*>(dcum);
  p.S = S; p.H = H; p.G = G; p.rep = H / G; p.P = P; p.N = N; p.Q = Q; p.nc = S / Q;
  p.nHB = (p.rep + heads_per_block - 1) / heads_per_block;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  // 16-byte cp.async rows: aligned bases, strides and widths in 16 bytes
  const long long v = bc_dtype == 1 ? 8 : 4;     // B/C elements per 16 bytes
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.x_vec = P % 4 == 0 && aligned(x) && x_sb % 4 == 0 && x_ss % 4 == 0 && x_sh % 4 == 0;
  p.y_vec = P % 4 == 0 && aligned(dy);
  p.b_vec = N % v == 0 && aligned(b) && b_sb % v == 0 && b_ss % v == 0 && b_sg % v == 0;
  p.c_vec = N % v == 0 && aligned(c) && c_sb % v == 0 && c_ss % v == 0 && c_sg % v == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch_bwd<float>(p, heads_per_block, ring == 1, B, s);
  return launch_bwd<__nv_bfloat16>(p, heads_per_block, ring == 1, B, s);
}
