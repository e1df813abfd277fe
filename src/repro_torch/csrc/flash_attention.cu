// Flash attention for Hopper (sm_90a): the forward on two routes, and the
// backward.
//
// Replaces: src/repro/kernels/flash_attention.py:81 flash_attention (body
// _flash_kernel, pallas_call at flash_attention.py:102). Computes
//     o = softmax(q k^T * D^-0.5 [+ mask]) v
// with the mask of repro/models/attention.py:44-53 (_block_attn): under the
// causal flag key j is valid for row i iff j <= i or j < prefix_len (the
// prefix-LM mask of the vlm family: the image patches see each other both
// ways, the text after them is causal); prefix_len 0 is the plain causal
// mask, and without the flag every key is valid (an encoder, or cross-
// attention with Sq != Sk).
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
// diagonal and past the prefix are never loaded, or skipped by the
// warpgroup they mask. P is
// rounded to bf16 in registers and is the A operand of O += P V (the
// accumulator layout is the register-A layout); V is an MN-major B read
// with the transpose bit. D and Dv are padded to the instantiated tile
// widths (64/64, 128/128, 192/128, 256/256). The output is divided by l,
// rounded to bf16, staged in shared memory and written 16 bytes per thread.
// Causal q tiles run heaviest first: a tile of q rows from q0 sees
// max(q0 + rows, prefix_len) keys, which never shrinks as q0 grows, so the
// order stays right under a prefix.
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
// above the diagonal and past the prefix are skipped.
//
// Backward (flash_attention_bwd_f32 / _bf16). The JAX package has no
// backward kernel: it differentiates the jnp blockwise attention. This is
// the port's own, FA2's recurrence with P recomputed from the forward's lse:
//     P = exp(S * scale - lse),  dV = P^T dO,  dP = dO V^T,
//     dS = P o (dP - D) with D = rowsum(dO o O),
//     dQ = dS K * scale,  dK = dS^T Q * scale.
// What bounds it: operations. Five products of 2 * Sq * Sk * D flops (half
// under the causal mask) against reading q, k, v, o, dO and writing dq, dk,
// dv once: at (2, 32, 4096, 64) causal, 344 GFLOP (0.35 ms at 989 TF/s)
// against 270 MB (0.08 ms). At D 64 the exponentials come close behind:
// one per pair and pass, some 537M, about 0.15 ms of the SFUs a pass. Three
// launches, no atomics, so the gradients are the same run to run:
//  1. delta: D per (batch, head, row) into an fp32 scratch (bf16: 16-byte
//     chunks, Dv / 8 lanes a row; fp32: a warp a row), and beside it the
//     lse in log2 units (+inf where it is -inf, so that such a row's P is
//     0) for the bf16 kernels;
//  2. dkdv: a block per (key tile, KV head, batch), K and V staged once; it
//     loops over the H/KH query heads of its KV head and over their q tiles
//     (under the causal mask from its own first key on, or from row 0 for a
//     block that starts inside the prefix), so GQA sums in
//     registers. Per q tile it recomputes S^T and dP^T, then dV += P^T dO
//     and dK += dS^T Q;
//  3. dq: a block per (q tile, head, batch) over the key tiles it sees (S
//     and dP again: seven products in all), dQ += dS K, the key tiles
//     summed in order.
// bf16 runs on wgmma (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel)
// with the forward's pieces: two consumer warpgroups a block, tiles copied
// by 16-byte cp.async through the model's strides into the 128-byte
// swizzle, the next tile's copy in flight under the current tile's
// products, and P^T and dS^T (dS) rounded to bf16 in registers as the A
// operand of the next product, whose B (dO, Q, K) is read MN-major with the
// transpose bit. A dK/dV block owns 128 keys, 64 a warpgroup, so every
// Q/dO tile it fetches serves 128 keys; a dQ block is shaped like the
// forward's, 128 q rows over 64-key tiles. At width 64 the operands a
// warpgroup keeps (K and V; Q and dO) are register-A fragments, loaded once
// by ldmatrix: a product of m64n64k16 with both operands in shared memory
// reads 4 KB in the 32 cycles it takes, all of the SM's 128 bytes a cycle,
// and with A in registers half that. Each warpgroup issues S^T and dP^T as
// two groups and computes P^T's exponentials while dP^T still runs, and
// dS^T while dV's product runs; a tile's dK (dQ) product is waited for
// only once the next tile's S^T (S) is in, so the rings have three stages.
// On both routes the key (q) block is the slowest grid dimension, so that
// under the causal mask the heaviest blocks of every head start first and
// the last wave is short. D and Dv are padded with zero columns to 64, 128
// or 256; at 128 the dK/dV block steps 32 q rows (wgmma N 32) to keep its
// 2 x 64 fp32 accumulators in registers. At 256 (paligemma's heads) a
// warpgroup's dK and dV of 64 keys would take 256 registers a thread, past
// the 255 a thread may hold, so the two warpgroups of a dK/dV block take
// the same 64 keys and each owns half of the width of dK and dV (128
// registers, as at width 128): both compute the whole S^T and dP^T, which
// contract over all 256 columns, so the block does 1.5x the products of one
// that owns its keys alone, and fetches each Q/dO tile for 64 keys instead
// of 128. The dQ block keeps 128 rows (a warpgroup's dQ is 128 registers)
// over K/V tiles of 32 keys, so that three stages fit beside Q and dO
// (225 KB). MLA's 192/128 (deepseek-v3) runs on the same tile: the
// loads zero-fill Q and K past D and V and dO past Dv, whose products add
// exact zeros, and the stores stop at D and Dv. dq, dk, dv are staged in shared memory and
// written 16 bytes a store. fp32 runs on the CUDA cores in exact fp32
// (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): 256 threads, every tile in
// shared memory in fp32 (rows padded by one float), a thread holding a 4 x
// 4 patch of each 64 x 64 score tile and 4 rows x ceil(D/16) columns of its
// accumulators, P^T and dS^T passed through shared memory. dO arrives as a
// transposed view of the (B, S, H*hd) gradient and is not copied; dq, dk,
// dv are written through their own strides. D and Dv up to 256; above 128
// four fp32 tiles do not fit, so Q and dO (dK/dV) or K and V (dQ) take one
// buffer in turns, the first of the two read again for the last product. A
// row with no valid key (lse = -inf) gets P = 0, so zero gradients.

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
  int prefix_len;     // causal only: keys below it are valid for every row
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
                   float scale, int causal, int prefix_len) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H; p.group = H / KH; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.prefix_len = prefix_len;
  return p;
}

// Keys [0, end) hold every valid key of rows [row0, row0 + rows): all of
// them, or under the causal mask up to the last row or the prefix.
__device__ __forceinline__ int keys_seen(int causal, int prefix_len, int Sk, int row0,
                                         int rows) {
  return causal ? min(Sk, max(row0 + rows, prefix_len)) : Sk;
}

// Whether key `col` is masked for row `row` (keys past Sk aside).
__device__ __forceinline__ bool masked(int causal, int prefix_len, int row, int col) {
  return causal && col > row && col >= prefix_len;
}

// The same test folded into one compare, for the tensor-core kernels' inner
// loops: under the causal mask key `col` is masked for row `row` iff col >
// mask_limit(row), the row or, where it is longer, the prefix less one.
__device__ __forceinline__ int mask_limit(int prefix_len, int row) {
  return max(row, prefix_len - 1);
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

  const int k_end = keys_seen(p.causal, p.prefix_len, p.Sk, q0, kF32Block);
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
        const bool valid = kc < p.Sk && !masked(p.causal, p.prefix_len, qr, kc);
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
// Waits until at most N of this warpgroup's committed groups are pending;
// groups complete in the order they were committed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Tells the compiler the accumulator registers change here, so that no read
// or write of them moves across an asynchronous wgmma or its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

// d (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The register-A fragment of rows row0..row0+15 (one warp's) and k-step kk
// of a tile stored in the 128-byte swizzle with ROWS rows: ldmatrix.x4,
// lane l naming row row0 + l % 8 + 8 (l / 8 % 2) of 16-byte chunk 2kk + l / 16.
template <int ROWS>
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], uint32_t tile, int row0, int kk) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + lane % 8 + 8 * ((lane / 8) % 2);
  const int c = 2 * kk + lane / 16;
  const uint32_t addr = tile + (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr) : "memory");
}

#define FA_D16                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_OUT16(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 32, fp32) += A (64 x 16) B (16 x 32), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_OUT16(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
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

  const int k_end = keys_seen(p.causal, p.prefix_len, p.Sk, q0, kRows);
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
  // Tiles this warpgroup computes: none past its last row and the prefix,
  // causal or not past the end of the keys.
  const int q0w = q0 + wg * kWgRows;
  const int wg_tiles = q0w >= p.Sq ? 0
      : (keys_seen(p.causal, p.prefix_len, p.Sk, q0w, kWgRows) + kKeys - 1) / kKeys;
  // under the causal mask a key past these is masked: for the warpgroup's
  // first row (an edge tile holds one), and for each of this thread's rows
  const int wg_limit = mask_limit(p.prefix_len, q0w);
  const int row_limit[2] = {mask_limit(p.prefix_len, q0 + r0),
                            mask_limit(p.prefix_len, q0 + r0 + 8)};

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
    // an edge tile holds a key past Sk, or one past both a row and the prefix
    const bool edge = k0 + kKeys > p.Sk || (p.causal && k0 + kKeys - 1 > wg_limit);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * p.scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + c0 + (i % 2);
        if (col >= p.Sk || (p.causal && col > row_limit[(i / 2) % 2])) x = -INFINITY;
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
  float* lse2;         // (B, H, Sq) scratch after delta: lse in log2 units, +inf for -inf
  void* dq;
  void* dk;
  void* dv;
  int H, group, Sq, Sk, D, Dv;
  Strides st[kNumT];
  float scale;         // D^-0.5
  float scale_log2;    // D^-0.5 * log2(e)
  int causal;
  int prefix_len;      // as the forward's
};

constexpr int kBT = 64;            // rows of every tile: keys and q rows
constexpr int kBwdThreads = 256;   // a thread holds a 4 x 4 patch of a 64 x 64 tile
constexpr int kBwdMaxDim = 256;

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

// Whether the fp32 kernels share one tile buffer between Q and dO (dK/dV)
// or K and V (dQ): above width 128, four fp32 tiles of 64 rows take more
// than an SM's 227 KB, so the shared one is filled again between products.
template <int NT>
__host__ __device__ constexpr bool bwd_f32_shares() {
  return NT > 8;
}

size_t bwd_smem_bytes(int D, int Dv, bool share) {
  // two tiles of D columns and two of Dv (rows padded by one float), or
  // with `share` one of each and a third of the wider; P/dS, lse, delta
  const size_t tiles = share ? static_cast<size_t>(kBT) * (D + Dv + 2 + (D > Dv ? D : Dv) + 1)
                             : static_cast<size_t>(2 * kBT) * (D + Dv + 2);
  return sizeof(float) * (tiles + static_cast<size_t>(kBT) * (kBT + 1) + 2 * kBT);
}

// Pre-pass on fp32 rows: delta = rowsum(dO o O), and the lse in log2 units
// (which the bf16 kernels read), one warp per (batch, head, row).
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_delta_kernel(const BwdParams p,
                                                                      int64_t rows) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  if (w >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(w % p.Sq);
  const int h = static_cast<int>((w / p.Sq) % p.H);
  const int b = static_cast<int>(w / (static_cast<int64_t>(p.Sq) * p.H));
  const float* orow = row_ptr<float>(p.o, p.st[kO], b, h, i);
  const float* dorow = row_ptr<float>(p.dout, p.st[kDO], b, h, i);
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc = fmaf(orow[c], dorow[c], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    p.delta[w] = acc;
    const float l = p.lse[w];
    p.lse2[w] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

// The same pre-pass on bf16 rows in 16-byte chunks: CH lanes a row (Dv / 8
// rounded up to a power of two), 32 / CH rows a warp; lse2 is the bf16
// kernels' lse, and a row with no valid key gets P = exp2(-inf) = 0.
template <int CH>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_delta_vec_kernel(const BwdParams p,
                                                                          int64_t rows) {
  using bf = __nv_bfloat16;
  const int lane = threadIdx.x % 32;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32) *
                        (32 / CH) + lane / CH;
  const int c = lane % CH;
  float acc = 0.f;
  if (w < rows && c * 8 < p.Dv) {
    const int i = static_cast<int>(w % p.Sq);
    const int h = static_cast<int>((w / p.Sq) % p.H);
    const int b = static_cast<int>(w / (static_cast<int64_t>(p.Sq) * p.H));
    const uint4 ov = *reinterpret_cast<const uint4*>(row_ptr<bf>(p.o, p.st[kO], b, h, i) + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(row_ptr<bf>(p.dout, p.st[kDO], b, h, i) + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(o2[j]);
      const float2 d = __bfloat1622float2(g2[j]);
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
  }
#pragma unroll
  for (int o = CH / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (w < rows && c == 0) {
    p.delta[w] = acc;
    const float l = p.lse[w];
    p.lse2[w] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

// dK and dV of one 64-key tile of one KV head: loops over the H / KH query
// heads that share it and over their q tiles (causal: from the key tile's
// own rows on), so GQA sums in registers, without atomics. Thread (ty, tx)
// holds keys ty*4 + i and q rows tx + 16j of each 64 x 64 tile, and columns
// tx + 16jj of dK and dV. NT: accumulator columns per thread, ceil(max(D,
// Dv) / 16). Where the kernel shares a buffer (``bwd_f32_shares``), Q and
// dO take it in turns: Q for S^T, dO for dP^T and dV, Q again for dK.
template <int NT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr bool kShare = bwd_f32_shares<NT>();
  const int D = p.D, Dv = p.Dv;
  const int ldk = D + 1, ldv = Dv + 1;
  constexpr int ldp = kBT + 1;
  float* Ks = smem;                        // 64 x ldk
  float* Vs = Ks + kBT * ldk;              // 64 x ldv
  float* Qs = Vs + kBT * ldv;              // 64 x ldk (shared: 64 x max(ldk, ldv))
  float* dOs = kShare ? Qs : Qs + kBT * ldk;   // 64 x ldv
  float* Ps = Qs + kBT * (kShare ? max(ldk, ldv) : ldk + ldv);   // 64 x ldp: P^T, then dS^T
  float* lse_s = Ps + kBT * ldp;
  float* dl_s = lse_s + kBT;

  const int k0 = blockIdx.z * kBT;         // the slowest grid dimension: causal, heaviest first
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile_bwd(Ks, ldk, row_ptr<float>(p.k, p.st[kK], b, kh, 0), p.st[kK].s, k0, p.Sk, D);
  load_tile_bwd(Vs, ldv, row_ptr<float>(p.v, p.st[kV], b, kh, 0), p.st[kV].s, k0, p.Sk, Dv);

  float dk[4][NT], dv[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // causal: q rows before k0 see none of these keys, unless the block
  // starts inside the prefix
  const int q_first = p.causal && k0 >= p.prefix_len ? k0 : 0;
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kh * p.group + hh;
    const float* qb = row_ptr<float>(p.q, p.st[kQ], b, h, 0);
    const float* dob = row_ptr<float>(p.dout, p.st[kDO], b, h, 0);
    const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int q0 = q_first; q0 < p.Sq; q0 += kBT) {
      __syncthreads();                     // the last tile's Qs, dOs, Ps are consumed
      load_tile_bwd(Qs, ldk, qb, p.st[kQ].s, q0, p.Sq, D);
      if (!kShare) load_tile_bwd(dOs, ldv, dob, p.st[kDO].s, q0, p.Sq, Dv);
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
      if (kShare) {                        // Q is consumed: dO in its place
        __syncthreads();
        load_tile_bwd(dOs, ldv, dob, p.st[kDO].s, q0, p.Sq, Dv);
        __syncthreads();
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
          const bool valid = key < p.Sk && qr < p.Sq && !masked(p.causal, p.prefix_len, qr, key);
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
      __syncthreads();                     // P^T (and, shared, dO) is consumed
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * ldp + tx + 16 * j] = s[i][j];
      if (kShare) load_tile_bwd(Qs, ldk, qb, p.st[kQ].s, q0, p.Sq, D);
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
// columns tx + 16jj of dQ. The causal q tiles run heaviest first. Where
// the kernel shares a buffer, K and V take it in turns: K for S, V for dP,
// K again for dQ.
template <int NT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr bool kShare = bwd_f32_shares<NT>();
  const int D = p.D, Dv = p.Dv;
  const int ldk = D + 1, ldv = Dv + 1;
  constexpr int ldp = kBT + 1;
  float* Qs = smem;                        // 64 x ldk
  float* dOs = Qs + kBT * ldk;             // 64 x ldv
  float* Ks = dOs + kBT * ldv;             // 64 x ldk (shared: 64 x max(ldk, ldv))
  float* Vs = kShare ? Ks : Ks + kBT * ldk;    // 64 x ldv
  float* Ps = Ks + kBT * (kShare ? max(ldk, ldv) : ldk + ldv);   // 64 x ldp: dS
  float* lse_s = Ps + kBT * ldp;
  float* dl_s = lse_s + kBT;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBT;   // causal: heaviest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
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

  const int k_end = keys_seen(p.causal, p.prefix_len, p.Sk, q0, kBT);
  const int n_tiles = (k_end + kBT - 1) / kBT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();                       // the last tile's Ks, Vs, Ps are consumed
    load_tile_bwd(Ks, ldk, kb, p.st[kK].s, k0, p.Sk, D);
    if (!kShare) load_tile_bwd(Vs, ldv, vb, p.st[kV].s, k0, p.Sk, Dv);
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
    if (kShare) {                          // K is consumed: V in its place
      __syncthreads();
      load_tile_bwd(Vs, ldv, vb, p.st[kV].s, k0, p.Sk, Dv);
      __syncthreads();
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
        const bool valid = key < p.Sk && qr < p.Sq && !masked(p.causal, p.prefix_len, qr, key);
        const float pij = valid ? exp2f(s[i][j] * p.scale_log2 - lse_s[qi]) : 0.f;
        Ps[qi * ldp + tx + 16 * j] = pij * (dp[i][j] - dl_s[qi]);
      }
    }
    if (kShare) {                          // V is consumed: K again
      __syncthreads();
      load_tile_bwd(Ks, ldk, kb, p.st[kK].s, k0, p.Sk, D);
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
  const size_t smem = bwd_smem_bytes(p.D, p.Dv, bwd_f32_shares<NT>());
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
  const dim3 grid_kv(p.H / p.group, B, (p.Sk + kBT - 1) / kBT);   // as launch_bwd_wgmma's
  flash_bwd_dkdv_kernel<NT><<<grid_kv, kBwdThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.Sq == 0) return e;
  const dim3 grid_q(p.H, B, (p.Sq + kBT - 1) / kBT);
  flash_bwd_dq_kernel<NT><<<grid_q, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward, bf16: wgmma fed by cp.async rings
// ---------------------------------------------------------------------------

// Keys of a dK/dV block: 64 a warpgroup (SPLIT 1); at SPLIT 2 (width 256)
// both warpgroups take the same 64 keys, each owning half the width of dK
// and dV, so that each keeps 2 x 2 x 32 fp32 accumulators as at width 128.
template <int SPLIT>
__host__ __device__ constexpr int dkdv_keys() {
  return kWgRows * kWarpgroups / SPLIT;
}
// Ring stages of the backward: a tile's last product (dK, or dQ) is waited
// for only after the next tile's first two are issued, so the stage the next
// copy overwrites must be two tiles back.
constexpr int kBwdStages = 3;

// q rows per dK/dV step by tile width: 64 at DT 64; 32 at DT 128 and 256,
// where a warpgroup's dK and dV accumulators take 128 fp32 registers a
// thread.
template <int DT>
constexpr int bwd_q_step() {
  return DT == 64 ? 64 : 32;
}

// Warpgroups sharing a dK/dV block's keys: 2 at width 256, else 1.
template <int DT>
constexpr int bwd_split() {
  return DT > 128 ? 2 : 1;
}

// Keys of a dQ block's K/V tiles: 32 at width 256, where 64-key tiles
// would not fit three stages beside Q and dO in 227 KB, else 64.
template <int DT>
constexpr int bwd_key_tile() {
  return DT > 128 ? 32 : 64;
}

template <int DT, int BQ, int SPLIT>
constexpr size_t dkdv_smem_bytes() {
  // alignment slack, K and V of the block's keys, kBwdStages Q/dO tiles,
  // and kBwdStages rows of lse2 and delta
  return kAtom + 2ull * dkdv_keys<SPLIT>() * DT * 2 +
         kBwdStages * (2ull * BQ * DT * 2 + 2ull * BQ * 4);
}

template <int DT, int KT>
constexpr size_t dq_smem_bytes() {
  // alignment slack, Q and dO of the block's rows, kBwdStages K/V tiles
  return kAtom + 2ull * kRows * DT * 2 + kBwdStages * 2ull * KT * DT * 2;
}
static_assert(dq_smem_bytes<256, 32>() <= 227 * 1024, "the width-256 dQ block fits an SM");

// Copies floats [row0, row0 + N) of `src` to shared memory at `dst`, one
// 4-byte cp.async each; zero past `nrows`.
template <int N>
__device__ __forceinline__ void load_stats(uint32_t dst, const float* src, int row0, int nrows) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool ok = row0 + i < nrows;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst + 4 * i), "l"(ok ? src + row0 + i : src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// Stages a warpgroup's accumulator blocks (64 rows x 64 columns each, fp32)
// times `mul` in bf16 at rows r0, r0 + 8 of a stage with row stride `ld`.
template <int NB>
__device__ __forceinline__ void stage_acc(__nv_bfloat16* stage, int ld, const float (&acc)[NB][32],
                                          float mul, int r0, int c0) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i / 2) % 2);
      const int col = nb * 64 + 8 * (i / 4) + c0;
      *reinterpret_cast<__nv_bfloat162*>(stage + row * ld + col) =
          __floats2bfloat162_rn(acc[nb][i] * mul, acc[nb][i + 1] * mul);
    }
}

// Writes ROWS staged rows (stride DT + 8) to rows [row0, row0 + ROWS) and
// columns [0, ncols) of `dst` with row stride `ld`, 16 bytes a store; rows
// at or past `nrows` are not written.
template <int ROWS, int DT>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, int64_t ld,
                                           const __nv_bfloat16* stage, int row0, int nrows,
                                           int ncols) {
  constexpr int kChunks = DT / 8;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int cc = idx % kChunks;
    if (row0 + r < nrows && cc * 8 < ncols)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + r * (DT + 8) + cc * 8);
  }
}

// The bf16 A operand of k-step kk from an fp32 accumulator fragment: the
// accumulator layout of columns 16kk..16kk+15 is the register-A layout.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[R], int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// dK and dV of 128 keys of one KV head: warpgroup wg owns keys wg*64.. of
// the block, whose K and V stay in shared memory (and, at a q step of 64,
// in the warpgroup's registers as A operands). At SPLIT 2 (width 256) the
// block holds 64 keys and both warpgroups take all of them, warpgroup wg
// owning columns wg*128.. of dK and dV: each computes the whole S^T and
// dP^T (they contract over the full width), and its half of dV and dK. The block walks the q
// tiles of BQ rows of each query head of the group (under the causal mask
// from its first key on, or from row 0 for a block that starts inside the
// prefix), their Q, dO, lse2 and delta through a three-stage
// cp.async ring, so GQA sums in registers. Per tile a warpgroup computes
// S^T = K Q^T and dP^T = V dO^T (wgmma, Q and dO K-major B operands),
// P^T = exp2(S^T * scale_log2 - lse2) while dP^T is still running, issues
// dV += P^T dO (P^T rounded to bf16 as register A, dO an MN-major B), then
// dS^T = P^T o (dP^T - delta) and dK += dS^T Q, which it waits for only
// once the next tile's S^T is in. A warpgroup skips a tile whose every pair
// is masked. Rows past Sq read zero Q, dO, lse2 and delta, which add
// nothing.
template <int DT, int BQ, int SPLIT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_wgmma_kernel(const BwdParams p) {
  using bf = __nv_bfloat16;
  constexpr int kKB = dkdv_keys<SPLIT>();  // keys of the block
  constexpr int kNB = DT / 64 / SPLIT;     // 64-wide blocks of dK and dV a warpgroup owns
  constexpr int kNQ = BQ / 2;              // a thread's share of an m64 x BQ fragment
  constexpr uint32_t kKVBytes = kKB * DT * 2;
  constexpr uint32_t kTileBytes = BQ * DT * 2;
  constexpr uint32_t kStageBytes = 2 * kTileBytes;
  constexpr int ldst = DT + 8;             // staged output row, padded against bank conflicts
  static_assert(2 * kKB * ldst * 2 <= 2 * kKVBytes + kBwdStages * kStageBytes,
                "dK and dV stage in K, V and the ring");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);   // swizzle atoms are 1024-aligned
  const uint32_t k_s = base;
  const uint32_t v_s = base + kKVBytes;
  const uint32_t ring = base + 2 * kKVBytes;      // stage st: Q at ring + st * kStageBytes, then dO
  const uint32_t stats = ring + kBwdStages * kStageBytes;   // stage st: lse2 (BQ floats), then delta
  const float* stats_f = reinterpret_cast<const float*>(smem_raw + (stats - raw));

  const int k0 = blockIdx.z * kKB;         // the slowest grid dimension: causal, heaviest first
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wkey = SPLIT == 1 ? wg * kWgRows : 0;   // this warpgroup's first key in the block
  const int nb0 = SPLIT == 1 ? 0 : wg * kNB;        // and its first 64-wide column block
  const int kw0 = k0 + wkey;               // this warpgroup's first key
  const int rk = warp * 16 + lane / 4;     // its keys kw0 + rk and + 8
  const int c0 = 2 * (lane % 4);

  // causal: earlier rows see none of these keys, unless the block starts
  // inside the prefix
  const int q_first = p.causal && k0 >= p.prefix_len ? k0 : 0;
  const int per_head = p.Sq > q_first ? (p.Sq - q_first + BQ - 1) / BQ : 0;
  // under the causal mask: a tile can be wholly masked, or partly, only if
  // this warpgroup's keys reach past the prefix; a key of the prefix is
  // never masked (-1: below every row)
  const bool past_prefix = p.causal && kw0 >= p.prefix_len;
  const bool may_mask = p.causal && kw0 + kWgRows > p.prefix_len;
  const int key_cmp[2] = {kw0 + rk >= p.prefix_len ? kw0 + rk : -1,
                          kw0 + rk + 8 >= p.prefix_len ? kw0 + rk + 8 : -1};
  const int n_tiles = per_head * p.group;

  auto load = [&](int t) {
    const int h = kh * p.group + t / per_head;
    const int q0 = q_first + (t % per_head) * BQ;
    const int st = t % kBwdStages;
    const uint32_t q_s = ring + st * kStageBytes;
    load_tile_sw128<BQ, DT>(q_s, row_ptr<bf>(p.q, p.st[kQ], b, h, 0), p.st[kQ].s, q0, p.Sq, p.D);
    load_tile_sw128<BQ, DT>(q_s + kTileBytes, row_ptr<bf>(p.dout, p.st[kDO], b, h, 0),
                            p.st[kDO].s, q0, p.Sq, p.Dv);
    const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    const uint32_t st_s = stats + st * (2 * BQ * 4);
    load_stats<BQ>(st_s, p.lse2 + stat, q0, p.Sq);
    load_stats<BQ>(st_s + BQ * 4, p.delta + stat, q0, p.Sq);
  };

  load_tile_sw128<kKB, DT>(k_s, row_ptr<bf>(p.k, p.st[kK], b, kh, 0), p.st[kK].s, k0,
                           p.Sk, p.D);
  load_tile_sw128<kKB, DT>(v_s, row_ptr<bf>(p.v, p.st[kV], b, kh, 0), p.st[kV].s, k0,
                           p.Sk, p.Dv);
  if (n_tiles > 0) load(0);
  cp_async_commit();

  float dk[kNB][32], dv[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;

  // At a q step of 64 the warpgroup's K and V are register-A operands,
  // loaded once: S^T and dP^T then read only Q and dO from shared memory.
  constexpr bool kRegKV = BQ == 64;
  uint32_t ka[kRegKV ? DT / 16 : 1][4], va[kRegKV ? DT / 16 : 1][4];
  if constexpr (kRegKV) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      ldmatrix_a<kKB>(ka[kk], k_s, wkey + warp * 16, kk);
      ldmatrix_a<kKB>(va[kk], v_s, wkey + warp * 16, kk);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                    // this thread's copies of tile t (and K, V)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();                       // everyone's; and tile t-2 is consumed
    if (t + 1 < n_tiles) {                 // into tile t-2's stage, under tile t's products
      load(t + 1);
      cp_async_commit();
    }
    const int q0 = q_first + (t % per_head) * BQ;
    if (kw0 >= p.Sk || (past_prefix && q0 + BQ - 1 < kw0)) {   // every pair masked
      wgmma_wait<0>();                     // an earlier tile's dK, before its stage is reused
      continue;
    }
    const int st = t % kBwdStages;
    const uint32_t q_s = ring + st * kStageBytes;
    const uint32_t do_s = q_s + kTileBytes;
    const float* lse2_s = stats_f + st * (2 * BQ);
    const float* dl_s = lse2_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T, two groups, over D in steps of 16
    float s[kNQ], dp[kNQ];
#pragma unroll
    for (int i = 0; i < kNQ; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * (kKB * 128) + wkey * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
      if constexpr (kRegKV)
        wgmma_rs_kmajor(s, ka[kk], desc_sw128(q_s + b_off, 16, kAtom));
      else
        wgmma_ss(s, desc_sw128(k_s + a_off, 16, kAtom), desc_sw128(q_s + b_off, 16, kAtom));
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * (kKB * 128) + wkey * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
      if constexpr (kRegKV)
        wgmma_rs_kmajor(dp, va[kk], desc_sw128(do_s + b_off, 16, kAtom));
      else
        wgmma_ss(dp, desc_sw128(v_s + a_off, 16, kAtom), desc_sw128(do_s + b_off, 16, kAtom));
    }
    wgmma_commit();
    wgmma_wait<1>();                       // tile t-1's dK and S^T are in; dP^T may still run
    fence_regs(s);

    // P^T on the fragment: element 4g + e is key rk + 8(e/2), q column 8g + c0 + e%2
    // some pair may be masked: a key past a row and past the prefix
    const bool diag = may_mask && q0 < kw0 + kWgRows;
#pragma unroll
    for (int g = 0; g < BQ / 8; ++g) {
      const float2 l = *reinterpret_cast<const float2*>(lse2_s + 8 * g + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fast_exp2(fmaf(s[4 * g + e], p.scale_log2, -(e % 2 ? l.y : l.x)));
        if (diag && key_cmp[e / 2] > q0 + 8 * g + c0 + e % 2) x = 0.f;
        s[4 * g + e] = x;
      }
    }
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(pa[kk], s, kk);
    // dV += P^T dO: dO is [q][Dv] with Dv contiguous, an MN-major B
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(dv[nb], pa[kk],
                 desc_sw128(do_s + (nb0 + nb) * (BQ * 128) + kk * (16 * 128), kAtom, kAtom));
    wgmma_commit();
    wgmma_wait<1>();                       // dP^T is in; dV may still run
    fence_regs(dp);

#pragma unroll
    for (int g = 0; g < BQ / 8; ++g) {
      const float2 d = *reinterpret_cast<const float2*>(dl_s + 8 * g + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * g + e] = s[4 * g + e] * (dp[4 * g + e] - (e % 2 ? d.y : d.x));
    }
    uint32_t da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(da[kk], dp, kk);
    // dK += dS^T Q: Q is [q][D], an MN-major B
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(dk[nb], da[kk],
                 desc_sw128(q_s + (nb0 + nb) * (BQ * 128) + kk * (16 * 128), kAtom, kAtom));
    wgmma_commit();                        // waited for in the next tile
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    fence_regs(dk[nb]);
    fence_regs(dv[nb]);
  }

  // epilogue: dK * scale and dV in bf16, staged over K, V and the ring
  cp_async_wait<0>();
  __syncthreads();                         // every warpgroup is done with shared memory
  bf* stage_k = reinterpret_cast<bf*>(smem_raw + (base - raw));
  bf* stage_v = stage_k + kKB * ldst;
  stage_acc(stage_k, ldst, dk, p.scale, wkey + rk, c0 + nb0 * 64);
  stage_acc(stage_v, ldst, dv, 1.f, wkey + rk, c0 + nb0 * 64);
  __syncthreads();
  store_tile<kKB, DT>(static_cast<bf*>(p.dk) + b * p.st[kDK].b + kh * p.st[kDK].h,
                      p.st[kDK].s, stage_k, k0, p.Sk, p.D);
  store_tile<kKB, DT>(static_cast<bf*>(p.dv) + b * p.st[kDV].b + kh * p.st[kDV].h,
                      p.st[kDV].s, stage_v, k0, p.Sk, p.Dv);
}

// dQ of 128 q rows of one head, shaped like the forward: warpgroup wg owns
// rows wg*64.., Q and dO stay in shared memory (and, at width 64, in the
// warpgroup's registers as A operands), 64-key K and V tiles go
// through a three-stage cp.async ring. Per tile: S = Q K^T and dP = dO V^T,
// P = exp2(S * scale_log2 - lse2) while dP runs, dS = P o (dP - delta), then
// dQ += dS K (dS register A, K an MN-major B), waited for once the next
// tile's S is in. The key tiles are summed in order, so dQ is the same run
// to run. Causal q tiles run heaviest first. KT: keys of a K/V tile (32 at
// width 256, so S and dP are m64n32 fragments).
template <int DT, int KT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wgmma_kernel(const BwdParams p) {
  using bf = __nv_bfloat16;
  constexpr int kNB = DT / 64;
  constexpr int kNS = KT / 2;              // a thread's share of an m64 x KT fragment
  constexpr uint32_t kQBytes = kRows * DT * 2;
  constexpr uint32_t kKBytes = KT * DT * 2;
  constexpr uint32_t kStageBytes = 2 * kKBytes;
  constexpr int ldst = DT + 8;
  static_assert(kRows * ldst * 2 <= 2 * kQBytes, "dQ stages over Q and dO");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);
  const uint32_t q_s = base;
  const uint32_t do_s = base + kQBytes;
  const uint32_t ring = base + 2 * kQBytes;   // stage st: K at ring + st * kStageBytes, then V

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // causal: heaviest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / p.group;
  const bf* kb = row_ptr<bf>(p.k, p.st[kK], b, kh, 0);
  const bf* vb = row_ptr<bf>(p.v, p.st[kV], b, kh, 0);
  const int k_end = keys_seen(p.causal, p.prefix_len, p.Sk, q0, kRows);
  const int n_tiles = (k_end + KT - 1) / KT;

  load_tile_sw128<kRows, DT>(q_s, row_ptr<bf>(p.q, p.st[kQ], b, h, 0), p.st[kQ].s, q0, p.Sq, p.D);
  load_tile_sw128<kRows, DT>(do_s, row_ptr<bf>(p.dout, p.st[kDO], b, h, 0), p.st[kDO].s, q0,
                             p.Sq, p.Dv);
  load_tile_sw128<KT, DT>(ring, kb, p.st[kK].s, 0, p.Sk, p.D);
  load_tile_sw128<KT, DT>(ring + kKBytes, vb, p.st[kV].s, 0, p.Sk, p.Dv);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * kWgRows + warp * 16 + lane / 4;   // row in the block; and r0 + 8
  const int c0 = 2 * (lane % 4);
  const int q0w = q0 + wg * kWgRows;
  const int wg_tiles = q0w >= p.Sq ? 0
      : (keys_seen(p.causal, p.prefix_len, p.Sk, q0w, kWgRows) + KT - 1) / KT;
  // as the forward's: the warpgroup's and this thread's rows' mask limits
  const int wg_limit = mask_limit(p.prefix_len, q0w);
  const int row_limit[2] = {mask_limit(p.prefix_len, q0 + r0),
                            mask_limit(p.prefix_len, q0 + r0 + 8)};
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  float lse2[2], dl[2];                    // a row past Sq: P = exp2(-inf) = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lse2[r] = row < p.Sq ? p.lse2[stat + row] : INFINITY;
    dl[r] = row < p.Sq ? p.delta[stat + row] : 0.f;
  }

  float dq[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;

  // At width 64 the warpgroup's Q and dO are register-A operands, loaded
  // once: S and dP then read only K and V from shared memory.
  constexpr bool kRegQO = DT == 64;
  uint32_t qa[kRegQO ? DT / 16 : 1][4], oa[kRegQO ? DT / 16 : 1][4];
  if constexpr (kRegQO) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      ldmatrix_a<kRows>(qa[kk], q_s, wg * kWgRows + warp * 16, kk);
      ldmatrix_a<kRows>(oa[kk], do_s, wg * kWgRows + warp * 16, kk);
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t k_s = ring + (j % kBwdStages) * kStageBytes;
    const uint32_t v_s = k_s + kKBytes;
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j + 1 < n_tiles) {                 // into tile j-2's stage
      const uint32_t nk = ring + ((j + 1) % kBwdStages) * kStageBytes;
      load_tile_sw128<KT, DT>(nk, kb, p.st[kK].s, (j + 1) * KT, p.Sk, p.D);
      load_tile_sw128<KT, DT>(nk + kKBytes, vb, p.st[kV].s, (j + 1) * KT, p.Sk, p.Dv);
      cp_async_commit();
    }
    if (j >= wg_tiles) {                   // wholly masked for this warpgroup
      wgmma_wait<0>();                     // the last tile's dQ, before its stage is reused
      continue;
    }

    float s[kNS], dp[kNS];
#pragma unroll
    for (int i = 0; i < kNS; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * (kRows * 128) + wg * (kWgRows * 128) + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * (KT * 128) + (kk % 4) * 32;
      if constexpr (kRegQO)
        wgmma_rs_kmajor(s, qa[kk], desc_sw128(k_s + b_off, 16, kAtom));
      else
        wgmma_ss(s, desc_sw128(q_s + a_off, 16, kAtom), desc_sw128(k_s + b_off, 16, kAtom));
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * (kRows * 128) + wg * (kWgRows * 128) + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * (KT * 128) + (kk % 4) * 32;
      if constexpr (kRegQO)
        wgmma_rs_kmajor(dp, oa[kk], desc_sw128(v_s + b_off, 16, kAtom));
      else
        wgmma_ss(dp, desc_sw128(do_s + a_off, 16, kAtom), desc_sw128(v_s + b_off, 16, kAtom));
    }
    wgmma_commit();
    wgmma_wait<1>();                       // tile j-1's dQ and S are in; dP may still run
    fence_regs(s);

    const int k0 = j * KT;
    const bool edge = k0 + KT > p.Sk || (p.causal && k0 + KT - 1 > wg_limit);
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      float x = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[(i / 2) % 2]));
      if (edge) {
        const int col = k0 + 8 * (i / 4) + c0 + (i % 2);
        if (col >= p.Sk || (p.causal && col > row_limit[(i / 2) % 2])) x = 0.f;
      }
      s[i] = x;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[KT / 16][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) acc_to_a(da[kk], dp, kk);
    // dQ += dS K: K is [key][D] with D contiguous, an MN-major B
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(dq[nb], da[kk],
                 desc_sw128(k_s + nb * (KT * 128) + kk * (16 * 128), kAtom, kAtom));
    wgmma_commit();                        // waited for in the next tile
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) fence_regs(dq[nb]);

  // epilogue: dQ * scale in bf16, staged over Q and dO
  cp_async_wait<0>();
  __syncthreads();
  bf* stage = reinterpret_cast<bf*>(smem_raw + (base - raw));
  stage_acc(stage, ldst, dq, p.scale, r0, c0);
  __syncthreads();
  store_tile<kRows, DT>(static_cast<bf*>(p.dq) + b * p.st[kDQ].b + h * p.st[kDQ].h,
                        p.st[kDQ].s, stage, q0, p.Sq, p.D);
}

template <int DT>
cudaError_t launch_bwd_wgmma(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int BQ = bwd_q_step<DT>();
  constexpr int SPLIT = bwd_split<DT>();
  constexpr int KB = dkdv_keys<SPLIT>();
  constexpr int KT = bwd_key_tile<DT>();
  constexpr size_t smem_kv = dkdv_smem_bytes<DT, BQ, SPLIT>();
  constexpr size_t smem_q = dq_smem_bytes<DT, KT>();
  static bool smem_set = false;            // per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DT, BQ, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_kv));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DT, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
    if (e != cudaSuccess) return clear_and_return(e);
    smem_set = true;
  }
  // The key (q) blocks vary slowest, so that under the causal mask every
  // head's heaviest blocks start first and the last wave holds light ones.
  const dim3 grid_kv(p.H / p.group, B, (p.Sk + KB - 1) / KB);
  flash_bwd_dkdv_wgmma_kernel<DT, BQ, SPLIT><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.Sq == 0) return e;
  const dim3 grid_q(p.H, B, (p.Sq + kRows - 1) / kRows);
  flash_bwd_dq_wgmma_kernel<DT, KT><<<grid_q, kThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, void* dk, void* dv,
              int B, int H, int KH, int Sq, int Sk, int D, int Dv,
              const long long* strides, float scale, int causal, int prefix_len,
              void* stream) {
  if (bad_args(B, H, KH, Sq, Sk, D, Dv) || prefix_len < 0 || D > kBwdMaxDim || Dv > kBwdMaxDim ||
      (Sk + kBT - 1) / kBT > 65535 || (Sq + kBT - 1) / kBT > 65535)   // grid z
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    // 16-byte copies of q, k, v, o, do rows and 16-byte stores of dq, dk, dv rows
    const int rows16[] = {kQ, kK, kV, kO, kDO, kDQ, kDK, kDV};
    const void* ptrs16[] = {q, k, v, o, dout, dq, dk, dv};
    long long st16 = 0;
    uintptr_t p16 = 0;
    for (int i = 0; i < 8; ++i) {
      const int t = rows16[i];
      st16 |= strides[3 * t] | strides[3 * t + 1] | strides[3 * t + 2];
      p16 |= reinterpret_cast<uintptr_t>(ptrs16[i]);
    }
    if (D % 16 != 0 || Dv % 16 != 0 || (st16 & 7) != 0 || (p16 & 15) != 0)
      return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.lse2 = p.delta + static_cast<int64_t>(B) * H * Sq;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.group = H / KH; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  for (int t = 0; t < kNumT; ++t)
    p.st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.prefix_len = prefix_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  if (rows > 0) {
    if constexpr (sizeof(T) == 2) {       // 16-byte rows of o and do
      const int ch = Dv <= 64 ? 8 : Dv <= 128 ? 16 : 32;
      const int64_t per_block = (kBwdThreads / 32) * (32 / ch);
      const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
      if (ch == 8) flash_bwd_delta_vec_kernel<8><<<blocks, kBwdThreads, 0, s>>>(p, rows);
      else if (ch == 16) flash_bwd_delta_vec_kernel<16><<<blocks, kBwdThreads, 0, s>>>(p, rows);
      else flash_bwd_delta_vec_kernel<32><<<blocks, kBwdThreads, 0, s>>>(p, rows);
    } else {
      const int64_t blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
      flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(p, rows);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if constexpr (sizeof(T) == 2) {         // bf16: wgmma
    if (D <= 64 && Dv <= 64) return launch_bwd_wgmma<64>(p, B, s);
    if (D <= 128 && Dv <= 128) return launch_bwd_wgmma<128>(p, B, s);
    return launch_bwd_wgmma<256>(p, B, s);
  } else {                                 // fp32: CUDA cores
    if (D <= 64 && Dv <= 64) return launch_bwd_tiles<4>(p, B, s);
    if (D <= 128 && Dv <= 128) return launch_bwd_tiles<8>(p, B, s);
    return launch_bwd_tiles<16>(p, B, s);
  }
}

}  // namespace

// fp32 on CUDA cores. Strides are in elements; lse may be null. Under
// `causal`, keys below `prefix_len` (>= 0) are valid for every row; without
// it prefix_len is not read. Returns a cudaError_t as int.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int prefix_len, void* stream) {
  if (bad_args(B, H, KH, Sq, Sk, D, Dv) || prefix_len < 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p = make_params(q, k, v, o, lse, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
                               prefix_len);
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
    float scale, int causal, int prefix_len, int d_tile, int dv_tile, void* stream) {
  const long long strides = q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh | v_ss;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bad_args(B, H, KH, Sq, Sk, D, Dv) || prefix_len < 0 || D % 16 != 0 || Dv % 16 != 0 ||
      D > d_tile || Dv > dv_tile || (strides & 7) != 0 || (ptrs & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p = make_params(q, k, v, o, lse, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
                               prefix_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_tile == 64 && dv_tile == 64) return launch_bf16<64, 64>(p, B, s);
  if (d_tile == 128 && dv_tile == 128) return launch_bf16<128, 128>(p, B, s);
  if (d_tile == 192 && dv_tile == 128) return launch_bf16<192, 128>(p, B, s);
  if (d_tile == 256 && dv_tile == 256) return launch_bf16<256, 256>(p, B, s);
  return cudaErrorInvalidValue;
}

// Backward, two routes by dtype: bf16 on wgmma (bf16 products of Q, K, V,
// dO and of P^T/dS^T rounded to bf16, fp32 sums), fp32 on the CUDA cores in
// exact fp32. q, k, v, o, do are read through their strides (unit last
// stride; do may be a transposed view), dq, dk, dv written through theirs,
// all in the inputs' type; bf16 needs q, k, v, o, do, dq, dk, dv 16-byte
// aligned with strides in multiples of 8. lse is the forward's, fp32 (B, H,
// Sq), natural log; delta an fp32 scratch of 2 x B x H x Sq (delta, then
// the lse in log2 units). `strides` order: q, k, v, o, do, dq, dk, dv,
// each (batch, head, row). causal and prefix_len as the forward's. D and
// Dv up to 256. Three launches; returns a
// cudaError_t as int.
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
    float scale, int causal, int prefix_len, void* stream
#define FA_BWD_CALL(T)                                                         \
  const long long strides[3 * kNumT] = {                                      \
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, \
      do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,          \
      dv_sb, dv_sh, dv_ss};                                                   \
  return flash_bwd<T>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, \
                      D, Dv, strides, scale, causal, prefix_len, stream)

extern "C" int flash_attention_bwd_f32(FA_BWD_ARGS) { FA_BWD_CALL(float); }

extern "C" int flash_attention_bwd_bf16(FA_BWD_ARGS) { FA_BWD_CALL(__nv_bfloat16); }

// Message for a code returned by the entry points of this library.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
