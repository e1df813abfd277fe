// Flash attention for Hopper (sm_90a): the forward on two routes, and the
// backward.
//
// Replaces: src/repro/kernels/flash_attention.py:81 flash_attention (body
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
// What bounds it: causal attention with D = Dv does 2 * S^2 * D flops per
// head (half of the S x S pairs, two products) and moves 4 * S * D elements,
// 2 bytes each in bf16: S / 4 flops per byte. That crosses the H100's 295
// bf16 flops per byte of HBM (989 TF/s over 3.35 TB/s) at S ~ 1180. Below
// it (every main-path shape: S 128 and 1024) the kernel is bound by bytes,
// above it by operations. Either way the byte bound is only reachable if the
// products keep pace with the reads, which CUDA-core fp32 FMAs (67 TF/s) do
// not: at S 1024 they need 17 GFLOP, 0.26 ms at that peak, 13x the 0.020 ms
// byte bound. So the bf16 route puts both products on the tensor cores.
//
// bf16 route (flash_fwd_bf16_kernel): two warpgroups (256 threads) per
// (128-row q tile, head, batch), each owning 64 rows, so every K/V tile
// brought from L2 serves 128 q rows. The q tile is staged once; 64-key K and
// V tiles go through a two-stage ring in shared memory, filled by 16-byte
// cp.async per row through the model's strides (zero-filled past the end
// and past D or Dv), so the copy of tile j+1 runs under the products of
// tile j. Tiles are stored in the 128-byte swizzle that wgmma descriptors
// read: column blocks of 64 bf16, each row's 16-byte chunk c at c ^ (row %
// 8). S = Q K^T is wgmma m64n64k16 with both operands in shared memory (K
// is K-major as stored). The online softmax runs on the fp32 accumulator
// fragment in registers (quad shuffles, log2 units); the mask applies only
// on the diagonal tile and the ragged last tile; tiles wholly above the
// diagonal are never loaded, or skipped by the warpgroup they mask. P is
// rounded to bf16 in registers and is the A operand of O += P V (the
// accumulator layout is the register-A layout); V is an MN-major B read
// with the transpose bit. D and Dv are padded to the instantiated tile
// widths (64/64, 128/128, 192/128, 256/256). The output is divided by l,
// rounded to bf16, staged in shared memory and written 16 bytes per thread.
// Causal q tiles run heaviest first.
//
// LSE: where the caller passes an `lse` pointer (training), both routes also
// write each row's logsumexp of the scaled, masked scores, fp32 (B, H, Sq),
// in NATURAL-log units, (m + log2(l)) * ln 2 from the log2-unit running max
// m and sum l, and -inf for a row with no valid key; the backward reads it
// in that unit (and PyTorch's plain version computes it so). On the serve
// path `lse` is null and nothing more is written.
//
// fp32 route (flash_fwd_f32_kernel): CUDA cores, exact fp32 products (TF32
// would break the fp32 tolerance). One block of 256 threads per (64-row q
// tile, head, batch); the q tile and each 64-row K/V tile are staged in
// shared memory (rows of Q and K padded by one float so that the 16 threads
// reading 16 K rows hit 16 banks). Each thread owns a 4x4 patch of the score
// tile (rows ty*4.., cols tx + 16*j) and a 4 x ceil(Dv/16) patch of the
// accumulator in registers. Row max and row sum reduce over the 16 threads
// of a row with warp shuffles. Under the causal mask, K tiles strictly
// above the diagonal are skipped.
//
// Backward (flash_attention_bwd_f32 / _bf16). The JAX package has no
// backward kernel: it differentiates the jnp blockwise attention. This is
// the port's own, FA2's recurrence with P recomputed from the forward's lse:
//     P = exp(S * scale - lse),  dV = P^T dO,  dP = dO V^T,
//     dS = P o (dP - D) with D = rowsum(dO o O),
//     dQ = dS K * scale,  dK = dS^T Q * scale.
// What bounds it: operations. Five products of 2 * Sq * Sk * D flops
// (half under the causal mask) against reading q, k, v, o, dO and writing
// dq, dk, dv once. Three launches, no atomics, so the gradients are the
// same run to run:
//  1. delta: D per (batch, head, row), a warp per row, into an fp32 scratch;
//  2. dkdv: a block per (64-key tile, KV head, batch), K and V staged once;
//     it loops over the H/KH query heads of its KV head and over their q
//     tiles (under the causal mask from its own rows on), so GQA sums in
//     registers. Per q tile it recomputes S^T and dP^T, then dV += P^T dO
//     and dK += dS^T Q;
//  3. dq: a block per (64-row q tile, head, batch), Q, dO, lse and D staged
//     once, looping over the key tiles it sees (S and dP again: seven
//     products in all), dQ += dS K.
// bf16 runs on the tensor cores (flash_bwd_*_mma_kernel): four warps a
// block, each owning 16 of its 64 keys (dkdv) or q rows (dq); every product
// is mma.sync m16n8k16 (bf16 in, fp32 sums) on tiles staged as bf16 in
// shared memory, rows padded by 16 bytes against bank conflicts, copied 16
// bytes at a time through the model's strides. P^T and dS^T stay in
// registers: their fp32 accumulator fragments, rounded to bf16, are the a
// operands of the next products (the C layout of two n-tiles is the a
// layout), and the b operands that are stored k-major come through
// ldmatrix with the transpose. D and Dv are padded with zero columns to 64
// or 128; dkdv takes 32 q rows a step at 128 to keep its four fp32
// accumulator sets in registers. fp32 runs on the CUDA cores in exact fp32
// (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): 256 threads, every tile in
// shared memory in fp32 (rows padded by one float), a thread holding a 4 x
// 4 patch of each 64 x 64 score tile and 4 rows x ceil(D/16) columns of its
// accumulators, P^T and dS^T passed through shared memory. dO arrives as a
// transposed view of the (B, S, H*hd) gradient and is not copied; dq, dk,
// dv are written through their own strides. D and Dv up to 128. A row with
// no valid key (lse = -inf) gets P = 0, so zero gradients. No cp.async,
// wgmma or TMA yet: a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;   // finite start for the running max
constexpr float kLn2 = 0.6931471805599453f;

// The natural-log logsumexp of a row from its log2-unit max m and sum l.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, H, Sq) natural-log logsumexp, or null
  int H, group, Sq, Sk, D, Dv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;   // D^-0.5 * log2(e): scores are kept in log2 units
  int causal;
};

bool bad_args(int B, int H, int KH, int Sq, int Sk, int D, int Dv) {
  return B < 0 || H < 1 || KH < 1 || H % KH != 0 || Sq < 0 || Sk < 1 ||
         D < 1 || D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim ||
         B > 65535 || H > 65535;
}

// A refused call leaves its error as the "last error"; clear it, so that the
// next launch's cudaGetLastError() reports that launch and not this one.
cudaError_t clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return e;
}

Params make_params(const void* q, const void* k, const void* v, void* o, void* lse,
                   int H, int KH, int Sq, int Sk, int D, int Dv,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   float scale, int causal) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H; p.group = H / KH; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return p;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Block = 64;      // q rows and keys per tile
constexpr int kF32Threads = 256;

// Loads rows [row0, row0 + 64) of a (rows, width) matrix with row stride
// `ld_src` into shared memory with row stride `ld_dst`; rows past `nrows`
// are zero-filled.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld_dst, const float* src,
                                              int64_t ld_src, int row0, int nrows,
                                              int width) {
  for (int idx = threadIdx.x; idx < kF32Block * width; idx += kF32Threads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int gr = row0 + r;
    dst[r * ld_dst + c] = gr < nrows ? src[gr * ld_src + c] : 0.f;
  }
}

// DVT: accumulator columns per thread, ceil(Dv / 16).
template <int DVT>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + 1;
  constexpr int ldp = kF32Block + 1;
  float* Qs = smem;                        // 64 x ldq
  float* Ks = Qs + kF32Block * ldq;        // 64 x ldq
  float* Vs = Ks + kF32Block * ldq;        // 64 x Dv
  float* Ps = Vs + kF32Block * Dv;         // 64 x ldp

  const int q0 = blockIdx.x * kF32Block;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.group;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  const int tx = threadIdx.x & 15;         // score cols tx + 16*j, acc cols tx + 16*jj
  const int ty = threadIdx.x >> 4;         // rows ty*4 .. ty*4+3

  load_tile_f32(Qs, ldq, qb, p.q_ss, q0, p.Sq, D);

  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DVT; ++jj) acc[i][jj] = 0.f;
  }

  // Keys a tile of q rows can see: all of them, or up to its last row.
  const int k_end = p.causal ? min(p.Sk, q0 + kF32Block) : p.Sk;
  const int n_tiles = (k_end + kF32Block - 1) / kF32Block;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Block;
    __syncthreads();                       // the last tile's Ks/Vs/Ps are consumed
    load_tile_f32(Ks, ldq, kb, p.k_ss, k0, p.Sk, D);
    load_tile_f32(Vs, Dv, vb, p.v_ss, k0, p.Sk, Dv);
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

    for (int kc = 0; kc < kF32Block; ++kc) {
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

  float* ob = static_cast<float*>(p.o) + (static_cast<int64_t>(b) * p.H + h) * p.Sq * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= p.Sq) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + qr] = row_lse(m[i], l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DVT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < Dv) ob[static_cast<int64_t>(qr) * Dv + c] = acc[i][jj] * inv;
    }
  }
}

template <int DVT>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(2 * kF32Block) * (p.D + 1) +
       static_cast<size_t>(kF32Block) * p.Dv +
       static_cast<size_t>(kF32Block) * (kF32Block + 1));
  static size_t smem_set = 48 * 1024;     // per instantiation: the most allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return clear_and_return(e);
    smem_set = smem;
  }
  const dim3 grid((p.Sq + kF32Block - 1) / kF32Block, p.H, B);
  flash_fwd_f32_kernel<DVT><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kWarpgroups = 2;     // consumers of each K/V tile
constexpr int kWgRows = 64;        // q rows per warpgroup
constexpr int kRows = kWgRows * kWarpgroups;   // q rows per block
constexpr int kKeys = 64;          // keys per K/V tile
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 2;
constexpr uint32_t kAtom = 1024;   // 8 rows x 128 B: one 128-byte swizzle atom
static_assert(kWgRows == 64 && kKeys == 64, "the wgmma calls below are m64n64k16");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Copies rows [row0, row0 + ROWS) x columns [0, WIDTH) of a bf16 matrix with
// row stride `ld` into shared memory at `dst` in the wgmma layout: WIDTH / 64
// column blocks of ROWS x 128 B, each row's 16-byte chunk c stored at chunk
// c ^ (row % 8). Rows at or past `nrows` and columns at or past `ncols` (a
// multiple of 8) are zero-filled. One cp.async of 16 bytes per chunk.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst, const __nv_bfloat16* src,
                                                int64_t ld, int row0, int nrows,
                                                int ncols) {
  constexpr int kChunks = WIDTH / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int cc = idx % kChunks;
    const int gr = row0 + r;
    const bool ok = gr < nrows && cc * 8 < ncols;
    const __nv_bfloat16* g = ok ? src + gr * ld + cc * 8 : src;
    const uint32_t s = dst + (cc / 8) * (ROWS * 128) + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tells the compiler the accumulator registers change here, so that no read
// or write of them moves across an asynchronous wgmma or its wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FA_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define FA_OUT32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x in one MUFU instruction (exp2f adds range handling); exp2(-inf) = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DT, int DVT>
constexpr size_t bf16_smem_bytes() {
  // alignment slack, the q tile, and kStages K/V tiles
  return kAtom + static_cast<size_t>(kRows) * DT * 2 +
         static_cast<size_t>(kStages) * kKeys * (DT + DVT) * 2;
}

// DT, DVT: D and Dv padded to a multiple of 64 (zero columns in shared memory).
template <int DT, int DVT>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(const Params p) {
  static_assert(DT % 64 == 0 && DVT % 64 == 0 && DT <= 256 && DVT <= 256, "tile widths");
  constexpr uint32_t kQBytes = kRows * DT * 2;
  constexpr uint32_t kKBytes = kKeys * DT * 2;
  constexpr uint32_t kStageBytes = kKBytes + kKeys * DVT * 2;
  constexpr int kNB = DVT / 64;            // 64-wide blocks of the output
  constexpr int ldo = DVT + 8;             // staged output row, padded against bank conflicts
  static_assert(kRows * ldo * 2 <= kStages * kStageBytes, "output stage fits the ring");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);   // swizzle atoms are 1024-aligned
  const uint32_t q_s = base;
  const uint32_t ring = base + kQBytes;    // stage st: K at ring + st * kStageBytes, then V

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.group;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  const int k_end = p.causal ? min(p.Sk, q0 + kRows) : p.Sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  load_tile_sw128<kRows, DT>(q_s, qb, p.q_ss, q0, p.Sq, p.D);
  load_tile_sw128<kKeys, DT>(ring, kb, p.k_ss, 0, p.Sk, p.D);
  load_tile_sw128<kKeys, DVT>(ring + kKBytes, vb, p.v_ss, 0, p.Sk, p.Dv);
  cp_async_commit();

  // Accumulator fragment of m64nN: warp w of a warpgroup, lane t holds rows
  // w*16 + t/4 and +8 of the warpgroup's 64; element i sits in column
  // 8*(i/4) + 2*(t%4) + (i%2) of row (i/2)%2 of those two.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * kWgRows + warp * 16 + lane / 4;   // row in the block
  const int c0 = 2 * (lane % 4);
  // Tiles this warpgroup computes: none past its last row, causal or not
  // past the end of the keys.
  const int q0w = q0 + wg * kWgRows;
  const int wg_tiles = q0w >= p.Sq ? 0
      : p.causal ? (min(p.Sk, q0w + kWgRows) + kKeys - 1) / kKeys : n_tiles;

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};                 // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t k_s = ring + (j % kStages) * kStageBytes;
    const uint32_t v_s = k_s + kKBytes;
    cp_async_wait<0>();                    // this thread's copies of tile j (and q)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();                       // everyone's; and tile j-1 is consumed
    if (j + 1 < n_tiles) {                 // into tile j-1's stage, under tile j's products
      const uint32_t nk = ring + ((j + 1) % kStages) * kStageBytes;
      load_tile_sw128<kKeys, DT>(nk, kb, p.k_ss, (j + 1) * kKeys, p.Sk, p.D);
      load_tile_sw128<kKeys, DVT>(nk + kKBytes, vb, p.v_ss, (j + 1) * kKeys, p.Sk, p.Dv);
      cp_async_commit();
    }
    if (j >= wg_tiles) continue;           // wholly masked for this warpgroup

    // S = Q K^T over D in steps of 16: +32 bytes inside a 64-column block
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t q_off = (kk / 4) * (kRows * 128) + wg * (kWgRows * 128) + (kk % 4) * 32;
      const uint32_t k_off = (kk / 4) * (kKeys * 128) + (kk % 4) * 32;
      wgmma_ss(s, desc_sw128(q_s + q_off, 16, kAtom), desc_sw128(k_s + k_off, 16, kAtom));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment, in log2 units
    const int k0 = j * kKeys;
    const bool edge = k0 + kKeys > p.Sk || (p.causal && k0 + kKeys - 1 > q0w);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * p.scale_log2;
      if (edge) {
        const int row = q0 + r0 + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + c0 + (i % 2);
        if (col >= p.Sk || (p.causal && col > row)) x = -INFINITY;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = fast_exp2(s[i] - mx[(i / 2) % 2]);   // masked: exp2(-inf) = 0
      l[(i / 2) % 2] += s[i];
    }
    // P in bf16 as the A operand: k-step kk covers accumulator columns 16kk..16kk+15
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i / 2) % 2];
      fence_regs(o[nb]);
    }

    // O += P V: V is [key][Dv] with Dv contiguous, an MN-major B. Each
    // 64-wide block of Dv is one swizzle atom across, so the descriptor's
    // only stride is the 1024 bytes between groups of eight keys.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const uint32_t addr = v_s + nb * (kKeys * 128) + kk * (16 * 128);
        wgmma_rs(o[nb], pa[kk], desc_sw128(addr, kAtom, kAtom));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(o[nb]);
  }

  // epilogue: o / l in bf16, staged in the ring, written 16 bytes per thread
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    const int row = q0 + r0 + 8 * r;
    if (p.lse != nullptr && lane % 4 == 0 && row < p.Sq)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] = row_lse(m[r], l[r]);
  }
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw + (ring - raw));
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const int row = r0 + 8 * r;
      const int col = nb * 64 + 8 * (i / 4) + c0;
      *reinterpret_cast<__nv_bfloat162*>(stage + row * ldo + col) =
          __floats2bfloat162_rn(o[nb][i] * inv[r], o[nb][i + 1] * inv[r]);
    }
  __syncthreads();
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                      (static_cast<int64_t>(b) * p.H + h) * p.Sq * p.Dv;
  constexpr int kChunks = DVT / 8;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int cc = idx % kChunks;
    if (q0 + r < p.Sq && cc * 8 < p.Dv)
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(q0 + r) * p.Dv + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ldo + cc * 8);
  }
}

template <int DT, int DVT>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<DT, DVT>();
  static bool smem_set = false;            // per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<DT, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return clear_and_return(e);
    smem_set = true;
  }
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.H, B);
  flash_fwd_bf16_kernel<DT, DVT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: the parameters and the delta pre-pass of both routes, and the
// fp32 route on the CUDA cores
// ---------------------------------------------------------------------------

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kNumT };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }


struct Strides {
  int64_t b, h, s;     // batch, head, row; 0 for a dim of size 1
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq), natural-log units
  float* delta;        // (B, H, Sq) scratch: rowsum(dO o O)
  void* dq;
  void* dk;
  void* dv;
  int H, group, Sq, Sk, D, Dv;
  Strides st[kNumT];
  float scale;         // D^-0.5
  float scale_log2;    // D^-0.5 * log2(e)
  int causal;
};

constexpr int kBT = 64;            // rows of every tile: keys and q rows
constexpr int kBwdThreads = 256;   // a thread holds a 4 x 4 patch of a 64 x 64 tile
constexpr int kBwdMaxDim = 128;

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, const Strides& st, int b,
                                            int h, int row) {
  return static_cast<const T*>(base) + b * st.b + h * st.h + static_cast<int64_t>(row) * st.s;
}

// Rows [row0, row0 + 64) x columns [0, width) of a T matrix with row stride
// `ld` into fp32 shared memory with row stride `ld_dst`; rows past `nrows`
// are zero-filled.
__device__ __forceinline__ void load_tile_bwd(float* dst, int ld_dst, const float* src, int64_t ld,
                                              int row0, int nrows, int width) {
  for (int idx = threadIdx.x; idx < kBT * width; idx += kBwdThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int gr = row0 + r;
    dst[r * ld_dst + c] = gr < nrows ? src[static_cast<int64_t>(gr) * ld + c] : 0.f;
  }
}

// The lse (log2 units; +inf for a row past Sq or with no valid key, so that
// its P is exp2(-inf) = 0) and delta of q rows [q0, q0 + ROWS), by blocks
// of THREADS threads.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s, const float* lse,
                                               const float* delta, int q0, int Sq) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int qi = q0 + r;
    const float l = qi < Sq ? lse[qi] : -INFINITY;
    lse_s[r] = l == -INFINITY ? INFINITY : l * kLog2e;
    dl_s[r] = qi < Sq ? delta[qi] : 0.f;
  }
}

size_t bwd_smem_bytes(int D, int Dv) {
  // two tiles of D columns, two of Dv (rows padded by one float), P/dS, lse, delta
  return sizeof(float) * (static_cast<size_t>(2 * kBT) * (D + 1) +
                          static_cast<size_t>(2 * kBT) * (Dv + 1) +
                          static_cast<size_t>(kBT) * (kBT + 1) + 2 * kBT);
}

// Pre-pass: delta = rowsum(dO o O), one warp per (batch, head, row).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_delta_kernel(const BwdParams p,
                                                                      int64_t rows) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  if (w >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(w % p.Sq);
  const int h = static_cast<int>((w / p.Sq) % p.H);
  const int b = static_cast<int>(w / (static_cast<int64_t>(p.Sq) * p.H));
  const T* orow = row_ptr<T>(p.o, p.st[kO], b, h, i);
  const T* dorow = row_ptr<T>(p.dout, p.st[kDO], b, h, i);
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc = fmaf(to_f(orow[c]), to_f(dorow[c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) p.delta[w] = acc;
}

// dK and dV of one 64-key tile of one KV head: loops over the H / KH query
// heads that share it and over their q tiles (causal: from the key tile's
// own rows on), so GQA sums in registers, without atomics. Thread (ty, tx)
// holds keys ty*4 + i and q rows tx + 16j of each 64 x 64 tile, and columns
// tx + 16jj of dK and dV. NT: accumulator columns per thread, ceil(max(D,
// Dv) / 16).
template <int NT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldk = D + 1, ldv = Dv + 1;
  constexpr int ldp = kBT + 1;
  float* Ks = smem;                        // 64 x ldk
  float* Vs = Ks + kBT * ldk;              // 64 x ldv
  float* Qs = Vs + kBT * ldv;              // 64 x ldk
  float* dOs = Qs + kBT * ldk;             // 64 x ldv
  float* Ps = dOs + kBT * ldv;             // 64 x ldp: P^T, then dS^T
  float* lse_s = Ps + kBT * ldp;
  float* dl_s = lse_s + kBT;

  const int k0 = blockIdx.x * kBT;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile_bwd(Ks, ldk, row_ptr<float>(p.k, p.st[kK], b, kh, 0), p.st[kK].s, k0, p.Sk, D);
  load_tile_bwd(Vs, ldv, row_ptr<float>(p.v, p.st[kV], b, kh, 0), p.st[kV].s, k0, p.Sk, Dv);

  float dk[4][NT], dv[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // causal: q rows before k0 see none of these keys
  const int q_first = p.causal ? k0 : 0;
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kh * p.group + hh;
    const float* qb = row_ptr<float>(p.q, p.st[kQ], b, h, 0);
    const float* dob = row_ptr<float>(p.dout, p.st[kDO], b, h, 0);
    const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int q0 = q_first; q0 < p.Sq; q0 += kBT) {
      __syncthreads();                     // the last tile's Qs, dOs, Ps are consumed
      load_tile_bwd(Qs, ldk, qb, p.st[kQ].s, q0, p.Sq, D);
      load_tile_bwd(dOs, ldv, dob, p.st[kDO].s, q0, p.Sq, Dv);
      load_row_stats<kBT, kBwdThreads>(lse_s, dl_s, p.lse + stat, p.delta + stat, q0, p.Sq);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this thread's 4 x 4 patch
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ks[(ty * 4 + i) * ldk + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = Qs[(tx + 16 * j) * ldk + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
      for (int e = 0; e < Dv; ++e) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Vs[(ty * 4 + i) * ldv + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = dOs[(tx + 16 * j) * ldv + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
      }
      // P^T = exp2(S^T * scale_log2 - lse) where the pair is valid; dS^T = P^T o (dP^T - delta)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qr = q0 + qc;
          const bool valid = key < p.Sk && qr < p.Sq && (!p.causal || key <= qr);
          const float pij = valid ? exp2f(s[i][j] * p.scale_log2 - lse_s[qc]) : 0.f;
          Ps[(ty * 4 + i) * ldp + qc] = pij;
          s[i][j] = pij * (dp[i][j] - dl_s[qc]);
        }
      }
      __syncthreads();
      for (int qc = 0; qc < kBT; ++qc) {   // dV += P^T dO
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ps[(ty * 4 + i) * ldp + qc];
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          const int c = tx + 16 * jj;
          const float o = c < Dv ? dOs[qc * ldv + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i][jj] = fmaf(a[i], o, dv[i][jj]);
        }
      }
      __syncthreads();                     // P^T is consumed
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * ldp + tx + 16 * j] = s[i][j];
      __syncthreads();
      for (int qc = 0; qc < kBT; ++qc) {   // dK += dS^T Q
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ps[(ty * 4 + i) * ldp + qc];
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          const int c = tx + 16 * jj;
          const float qv = c < D ? Qs[qc * ldk + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][jj] = fmaf(a[i], qv, dk[i][jj]);
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk) + b * p.st[kDK].b + kh * p.st[kDK].h;
  float* dvb = static_cast<float*>(p.dv) + b * p.st[kDV].b + kh * p.st[kDV].h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dkb[static_cast<int64_t>(key) * p.st[kDK].s + c] = dk[i][jj] * p.scale;
      if (c < Dv) dvb[static_cast<int64_t>(key) * p.st[kDV].s + c] = dv[i][jj];
    }
  }
}

// dQ of one 64-row q tile of one head: loops over the key tiles it sees.
// Thread (ty, tx) holds q rows ty*4 + i and keys tx + 16j of each tile, and
// columns tx + 16jj of dQ. The causal q tiles run heaviest first.
template <int NT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldk = D + 1, ldv = Dv + 1;
  constexpr int ldp = kBT + 1;
  float* Qs = smem;                        // 64 x ldk
  float* dOs = Qs + kBT * ldk;             // 64 x ldv
  float* Ks = dOs + kBT * ldv;             // 64 x ldk
  float* Vs = Ks + kBT * ldk;              // 64 x ldv
  float* Ps = Vs + kBT * ldv;              // 64 x ldp: dS
  float* lse_s = Ps + kBT * ldp;
  float* dl_s = lse_s + kBT;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.group;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kb = row_ptr<float>(p.k, p.st[kK], b, kh, 0);
  const float* vb = row_ptr<float>(p.v, p.st[kV], b, kh, 0);
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  load_tile_bwd(Qs, ldk, row_ptr<float>(p.q, p.st[kQ], b, h, 0), p.st[kQ].s, q0, p.Sq, D);
  load_tile_bwd(dOs, ldv, row_ptr<float>(p.dout, p.st[kDO], b, h, 0), p.st[kDO].s, q0, p.Sq, Dv);
  load_row_stats<kBT, kBwdThreads>(lse_s, dl_s, p.lse + stat, p.delta + stat, q0, p.Sq);

  float dq[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) dq[i][jj] = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + kBT) : p.Sk;
  const int n_tiles = (k_end + kBT - 1) / kBT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();                       // the last tile's Ks, Vs, Ps are consumed
    load_tile_bwd(Ks, ldk, kb, p.st[kK].s, k0, p.Sk, D);
    load_tile_bwd(Vs, ldv, vb, p.st[kV].s, k0, p.Sk, Dv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    for (int e = 0; e < Dv; ++e) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dOs[(ty * 4 + i) * ldv + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Vs[(tx + 16 * j) * ldv + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
      const int qr = q0 + qi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool valid = key < p.Sk && qr < p.Sq && (!p.causal || key <= qr);
        const float pij = valid ? exp2f(s[i][j] * p.scale_log2 - lse_s[qi]) : 0.f;
        Ps[qi * ldp + tx + 16 * j] = pij * (dp[i][j] - dl_s[qi]);
      }
    }
    __syncthreads();
    for (int kc = 0; kc < kBT; ++kc) {     // dQ += dS K
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty * 4 + i) * ldp + kc];
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        const int c = tx + 16 * jj;
        const float kv = c < D ? Ks[kc * ldk + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][jj] = fmaf(a[i], kv, dq[i][jj]);
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq) + b * p.st[kDQ].b + h * p.st[kDQ].h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= p.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) dqb[static_cast<int64_t>(qr) * p.st[kDQ].s + c] = dq[i][jj] * p.scale;
    }
  }
}

template <int NT>
cudaError_t launch_bwd_tiles(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p.D, p.Dv);
  static size_t smem_set = 48 * 1024;     // per instantiation: the most allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return clear_and_return(e);
    smem_set = smem;
  }
  const dim3 grid_kv((p.Sk + kBT - 1) / kBT, p.H / p.group, B);
  flash_bwd_dkdv_kernel<NT><<<grid_kv, kBwdThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.Sq == 0) return e;
  const dim3 grid_q((p.Sq + kBT - 1) / kBT, p.H, B);
  flash_bwd_dq_kernel<NT><<<grid_q, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward, bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;   // a block's keys (dK/dV) or q rows (dQ)

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16). Fragments of
// m16n8k16, lane = 4g + q4: a holds rows g, g+8 at columns 2q4, 2q4+1 and
// 2q4+8, 2q4+9; b columns (n) g at rows (k) 2q4, 2q4+1 and +8; c rows g,
// g+8 at columns 2q4, 2q4+1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// The a fragment of rows r0.. and columns k0.. of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* ptr = t + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld_u32(ptr);
  a[1] = ld_u32(ptr + 8 * ld);
  a[2] = ld_u32(ptr + 8);
  a[3] = ld_u32(ptr + 8 * ld + 8);
}

// The b fragment of a tile stored [n][k] (k contiguous): n from n0, k from k0.
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* t,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* ptr = t + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld_u32(ptr);
  b1 = ld_u32(ptr + 8);
}

// The b fragments of n-tiles n0 and n0 + 8 of a tile stored [k][n] (n
// contiguous), k from k0: ldmatrix with the transpose, lanes 8j..8j+7
// naming the rows of 8 x 8 matrix j.
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4], const __nv_bfloat16* t, int ld,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* ptr = t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(ptr))
               : "memory");
}

// The a fragments of k-step kk of a 16-row fp32 C tile set (n-tiles 2kk and
// 2kk + 1), rounded to bf16: the C layout of two n-tiles is the a layout.
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [row0, row0 + ROWS) and columns [0, W) of a bf16 matrix with row
// stride `ld` into shared memory with row stride `ldt`, 16 bytes a copy;
// zero past `nrows` and past `ncols` (a multiple of 8).
template <int ROWS, int W>
__device__ __forceinline__ void load_tile_mma(__nv_bfloat16* dst, int ldt,
                                              const __nv_bfloat16* src, int64_t ld,
                                              int row0, int nrows, int ncols) {
  constexpr int kChunks = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int gr = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && c < ncols) v = *reinterpret_cast<const uint4*>(src + gr * ld + c);
    *reinterpret_cast<uint4*>(dst + r * ldt + c) = v;
  }
}

template <int DT, int ROWS_A, int ROWS_B>
constexpr size_t mma_smem_bytes() {
  // two tiles of ROWS_A rows, two of ROWS_B (rows padded by 8 bf16 against
  // bank conflicts), lse and delta of up to 64 rows
  return sizeof(__nv_bfloat16) * (2 * ROWS_A + 2 * ROWS_B) * (DT + 8) + 2 * 64 * sizeof(float);
}

// dK and dV of 64 keys of one KV head. Warp w owns keys 16w..16w+15 and,
// per q tile of BQ rows, computes S^T = K Q^T and dP^T = V dO^T into fp32
// fragments, P^T and dS^T in place, then dV += P^T dO and dK += dS^T Q with
// P^T and dS^T rounded to bf16 as a operands (no trip through shared
// memory). DT: D and Dv padded to 64 or 128 with zero columns.
template <int DT, int BQ>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  constexpr int ld = DT + 8;
  constexpr int NQ = BQ / 8;               // n-tiles of q columns
  constexpr int ND = DT / 8;               // n-tiles of head columns
  using bf = __nv_bfloat16;
  bf* Ks = reinterpret_cast<bf*>(smem_mma);   // 64 x ld
  bf* Vs = Ks + kMmaRows * ld;                // 64 x ld
  bf* Qs = Vs + kMmaRows * ld;                // BQ x ld
  bf* dOs = Qs + BQ * ld;                     // BQ x ld
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * ld);
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * kMmaRows;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int kw = (threadIdx.x >> 5) * 16;     // this warp's first key in the tile

  load_tile_mma<kMmaRows, DT>(Ks, ld, row_ptr<bf>(p.k, p.st[kK], b, kh, 0), p.st[kK].s,
                              k0, p.Sk, p.D);
  load_tile_mma<kMmaRows, DT>(Vs, ld, row_ptr<bf>(p.v, p.st[kV], b, kh, 0), p.st[kV].s,
                              k0, p.Sk, p.Dv);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[n][r] = dv[n][r] = 0.f;

  const int q_first = p.causal ? k0 : 0;   // k0 is a multiple of BQ
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kh * p.group + hh;
    const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int q0 = q_first; q0 < p.Sq; q0 += BQ) {
      __syncthreads();                     // the last tile's Qs, dOs are consumed
      load_tile_mma<BQ, DT>(Qs, ld, row_ptr<bf>(p.q, p.st[kQ], b, h, 0), p.st[kQ].s,
                            q0, p.Sq, p.D);
      load_tile_mma<BQ, DT>(dOs, ld, row_ptr<bf>(p.dout, p.st[kDO], b, h, 0), p.st[kDO].s,
                            q0, p.Sq, p.Dv);
      load_row_stats<BQ, kMmaThreads>(lse_s, dl_s, p.lse + stat, p.delta + stat, q0, p.Sq);
      __syncthreads();
      if (p.causal && q0 + BQ - 1 < k0 + kw) continue;   // every pair masked for this warp

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, Ks, ld, kw, kk * 16);
        frag_a(av, Vs, ld, kw, kk * 16);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          frag_b(b0, b1, Qs, ld, n * 8, kk * 16);
          mma_bf16(s[n], ak, b0, b1);
          frag_b(b0, b1, dOs, ld, n * 8, kk * 16);
          mma_bf16(dp[n], av, b0, b1);
        }
      }
      // P^T = exp2(S^T * scale_log2 - lse) on valid pairs; dS^T = P^T o (dP^T - delta)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + kw + g + 8 * (r >> 1);
          const int qc = n * 8 + 2 * q4 + (r & 1);
          const int qr = q0 + qc;
          const bool valid = key < p.Sk && qr < p.Sq && (!p.causal || key <= qr);
          const float pv = valid ? exp2f(s[n][r] * p.scale_log2 - lse_s[qc]) : 0.f;
          s[n][r] = pv;
          dp[n][r] = pv * (dp[n][r] - dl_s[qc]);
        }
      // dV += P^T dO and dK += dS^T Q, over the q columns in steps of 16
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t pa[4], da[4];
        c_to_a<NQ>(pa, s, kq);
        c_to_a<NQ>(da, dp, kq);
#pragma unroll
        for (int n0 = 0; n0 < DT; n0 += 16) {
          uint32_t bt[4];
          frag_b_trans(bt, dOs, ld, kq * 16, n0);
          mma_bf16(dv[n0 / 8], pa, bt[0], bt[1]);
          mma_bf16(dv[n0 / 8 + 1], pa, bt[2], bt[3]);
          frag_b_trans(bt, Qs, ld, kq * 16, n0);
          mma_bf16(dk[n0 / 8], da, bt[0], bt[1]);
          mma_bf16(dk[n0 / 8 + 1], da, bt[2], bt[3]);
        }
      }
    }
  }

  bf* dkb = static_cast<bf*>(p.dk) + b * p.st[kDK].b + kh * p.st[kDK].h;
  bf* dvb = static_cast<bf*>(p.dv) + b * p.st[kDV].b + kh * p.st[kDV].h;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int key = k0 + kw + g + 8 * (r >> 1);
      const int col = n * 8 + 2 * q4;
      if (key >= p.Sk) continue;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(dkb + static_cast<int64_t>(key) * p.st[kDK].s + col) =
            __floats2bfloat162_rn(dk[n][r] * p.scale, dk[n][r + 1] * p.scale);
      if (col < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dvb + static_cast<int64_t>(key) * p.st[kDV].s + col) =
            __floats2bfloat162_rn(dv[n][r], dv[n][r + 1]);
    }
}

// dQ of 64 q rows of one head. Warp w owns rows 16w..16w+15 and, per key
// tile of BK keys, computes S = Q K^T and dP = dO V^T into fp32 fragments,
// dS in place, then dQ += dS K with dS rounded to bf16. Causal q tiles run
// heaviest first.
template <int DT, int BK>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  constexpr int ld = DT + 8;
  constexpr int NK = BK / 8;
  constexpr int ND = DT / 8;
  using bf = __nv_bfloat16;
  bf* Qs = reinterpret_cast<bf*>(smem_mma);   // 64 x ld
  bf* dOs = Qs + kMmaRows * ld;               // 64 x ld
  bf* Ks = dOs + kMmaRows * ld;               // BK x ld
  bf* Vs = Ks + BK * ld;                      // BK x ld
  float* lse_s = reinterpret_cast<float*>(Vs + BK * ld);
  float* dl_s = lse_s + kMmaRows;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.group;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int qw = (threadIdx.x >> 5) * 16;     // this warp's first q row in the tile
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const bf* kb = row_ptr<bf>(p.k, p.st[kK], b, kh, 0);
  const bf* vb = row_ptr<bf>(p.v, p.st[kV], b, kh, 0);

  load_tile_mma<kMmaRows, DT>(Qs, ld, row_ptr<bf>(p.q, p.st[kQ], b, h, 0), p.st[kQ].s,
                              q0, p.Sq, p.D);
  load_tile_mma<kMmaRows, DT>(dOs, ld, row_ptr<bf>(p.dout, p.st[kDO], b, h, 0), p.st[kDO].s,
                              q0, p.Sq, p.Dv);
  load_row_stats<kMmaRows, kMmaThreads>(lse_s, dl_s, p.lse + stat, p.delta + stat, q0,
                                        p.Sq);
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[n][r] = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + kMmaRows) : p.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kb0 = kt * BK;
    __syncthreads();                       // the last tile's Ks, Vs are consumed
    load_tile_mma<BK, DT>(Ks, ld, kb, p.st[kK].s, kb0, p.Sk, p.D);
    load_tile_mma<BK, DT>(Vs, ld, vb, p.st[kV].s, kb0, p.Sk, p.Dv);
    __syncthreads();
    if (p.causal && kb0 > q0 + qw + 15) continue;   // every pair masked for this warp

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, Qs, ld, qw, kk * 16);
      frag_a(ao, dOs, ld, qw, kk * 16);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Ks, ld, n * 8, kk * 16);
        mma_bf16(s[n], aq, b0, b1);
        frag_b(b0, b1, Vs, ld, n * 8, kk * 16);
        mma_bf16(dp[n], ao, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = qw + g + 8 * (r >> 1);
        const int qr = q0 + row;
        const int key = kb0 + n * 8 + 2 * q4 + (r & 1);
        const bool valid = key < p.Sk && qr < p.Sq && (!p.causal || key <= qr);
        const float pv = valid ? exp2f(s[n][r] * p.scale_log2 - lse_s[row]) : 0.f;
        dp[n][r] = pv * (dp[n][r] - dl_s[row]);
      }
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {  // dQ += dS K, K stored [key][d]
      uint32_t da[4];
      c_to_a<NK>(da, dp, kq);
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += 16) {
        uint32_t bt[4];
        frag_b_trans(bt, Ks, ld, kq * 16, n0);
        mma_bf16(dq[n0 / 8], da, bt[0], bt[1]);
        mma_bf16(dq[n0 / 8 + 1], da, bt[2], bt[3]);
      }
    }
  }

  bf* dqb = static_cast<bf*>(p.dq) + b * p.st[kDQ].b + h * p.st[kDQ].h;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int qr = q0 + qw + g + 8 * (r >> 1);
      const int col = n * 8 + 2 * q4;
      if (qr < p.Sq && col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(dqb + static_cast<int64_t>(qr) * p.st[kDQ].s + col) =
            __floats2bfloat162_rn(dq[n][r] * p.scale, dq[n][r + 1] * p.scale);
    }
}

// BQ, BK: q rows per dK/dV step and keys per dQ step; 32 q rows at DT 128
// keep dK/dV's accumulators and fragments in registers.
template <int DT, int BQ, int BK>
cudaError_t launch_bwd_mma(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem_kv = mma_smem_bytes<DT, kMmaRows, BQ>();
  constexpr size_t smem_q = mma_smem_bytes<DT, kMmaRows, BK>();
  static bool smem_set = false;            // per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<DT, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_kv));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DT, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
    if (e != cudaSuccess) return clear_and_return(e);
    smem_set = true;
  }
  const dim3 grid_kv((p.Sk + kMmaRows - 1) / kMmaRows, p.H / p.group, B);
  flash_bwd_dkdv_mma_kernel<DT, BQ><<<grid_kv, kMmaThreads, smem_kv, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.Sq == 0) return e;
  const dim3 grid_q((p.Sq + kMmaRows - 1) / kMmaRows, p.H, B);
  flash_bwd_dq_mma_kernel<DT, BK><<<grid_q, kMmaThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, void* dk, void* dv,
              int B, int H, int KH, int Sq, int Sk, int D, int Dv,
              const long long* strides, float scale, int causal, void* stream) {
  if (bad_args(B, H, KH, Sq, Sk, D, Dv) || D > kBwdMaxDim || Dv > kBwdMaxDim)
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    // 16-byte copies of q, k, v, do rows; 4-byte stores of dq, dk, dv pairs
    long long st16 = 0, st2 = 0;
    for (int i = 0; i < 3; ++i) {
      st16 |= strides[3 * kQ + i] | strides[3 * kK + i] | strides[3 * kV + i] |
              strides[3 * kDO + i];
      st2 |= strides[3 * kDQ + i] | strides[3 * kDK + i] | strides[3 * kDV + i];
    }
    const uintptr_t p16 = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
    const uintptr_t p4 = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
    if (D % 16 != 0 || Dv % 16 != 0 || (st16 & 7) != 0 || (st2 & 1) != 0 ||
        (p16 & 15) != 0 || (p4 & 3) != 0)
      return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.group = H / KH; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  for (int t = 0; t < kNumT; ++t)
    p.st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  if (rows > 0) {
    const int64_t blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(p, rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if constexpr (sizeof(T) == 2) {         // bf16: mma.sync
    if (D <= 64 && Dv <= 64) return launch_bwd_mma<64, 64, 64>(p, B, s);
    return launch_bwd_mma<128, 32, 64>(p, B, s);
  } else {                                 // fp32: CUDA cores
    if (D <= 64 && Dv <= 64) return launch_bwd_tiles<4>(p, B, s);
    return launch_bwd_tiles<8>(p, B, s);
  }
}

}  // namespace

// fp32 on CUDA cores. Strides are in elements; lse may be null. Returns a
// cudaError_t as int.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, void* stream) {
  if (bad_args(B, H, KH, Sq, Sk, D, Dv)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p = make_params(q, k, v, o, lse, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dv <= 64) return launch_f32<4>(p, B, s);
  if (Dv <= 128) return launch_f32<8>(p, B, s);
  return launch_f32<16>(p, B, s);
}

// bf16 on tensor cores. D and Dv multiples of 16, padded to the tile widths
// (d_tile, dv_tile), one of 64/64, 128/128, 192/128, 256/256. Pointers
// 16-byte aligned and strides multiples of 8 elements (16-byte row copies).
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int d_tile, int dv_tile, void* stream) {
  const long long strides = q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh | v_ss;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bad_args(B, H, KH, Sq, Sk, D, Dv) || D % 16 != 0 || Dv % 16 != 0 ||
      D > d_tile || Dv > dv_tile || (strides & 7) != 0 || (ptrs & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p = make_params(q, k, v, o, lse, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_tile == 64 && dv_tile == 64) return launch_bf16<64, 64>(p, B, s);
  if (d_tile == 128 && dv_tile == 128) return launch_bf16<128, 128>(p, B, s);
  if (d_tile == 192 && dv_tile == 128) return launch_bf16<192, 128>(p, B, s);
  if (d_tile == 256 && dv_tile == 256) return launch_bf16<256, 256>(p, B, s);
  return cudaErrorInvalidValue;
}

// Backward, two routes by dtype: bf16 on mma.sync (bf16 products of Q, K, V,
// dO and of P^T/dS^T rounded to bf16, fp32 sums), fp32 on the CUDA cores in
// exact fp32. q, k, v, o, do are read through their strides (unit last
// stride; do may be a transposed view), dq, dk, dv written through theirs,
// all in the inputs' type; lse is the forward's, fp32 (B, H, Sq), natural
// log; delta an fp32 (B, H, Sq) scratch. `strides` order: q, k, v, o, do,
// dq, dk, dv, each (batch, head, row). D and Dv up to 128. Three launches;
// returns a cudaError_t as int.
#define FA_BWD_ARGS                                                            \
    const void* q, const void* k, const void* v, const void* o, const void* dout, \
    const void* lse, void* delta, void* dq, void* dk, void* dv,               \
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,                      \
    long long q_sb, long long q_sh, long long q_ss,                           \
    long long k_sb, long long k_sh, long long k_ss,                           \
    long long v_sb, long long v_sh, long long v_ss,                           \
    long long o_sb, long long o_sh, long long o_ss,                           \
    long long do_sb, long long do_sh, long long do_ss,                        \
    long long dq_sb, long long dq_sh, long long dq_ss,                        \
    long long dk_sb, long long dk_sh, long long dk_ss,                        \
    long long dv_sb, long long dv_sh, long long dv_ss,                        \
    float scale, int causal, void* stream
#define FA_BWD_CALL(T)                                                         \
  const long long strides[3 * kNumT] = {                                      \
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, \
      do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,          \
      dv_sb, dv_sh, dv_ss};                                                   \
  return flash_bwd<T>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, \
                      D, Dv, strides, scale, causal, stream)

extern "C" int flash_attention_bwd_f32(FA_BWD_ARGS) { FA_BWD_CALL(float); }

extern "C" int flash_attention_bwd_bf16(FA_BWD_ARGS) { FA_BWD_CALL(__nv_bfloat16); }

// Message for a code returned by the entry points of this library.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
