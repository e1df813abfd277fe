// Flash-attention forward for Hopper (sm_90a), two routes.
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
// fp32 route (flash_fwd_f32_kernel): CUDA cores, exact fp32 products (TF32
// would break the fp32 tolerance). One block of 256 threads per (64-row q
// tile, head, batch); the q tile and each 64-row K/V tile are staged in
// shared memory (rows of Q and K padded by one float so that the 16 threads
// reading 16 K rows hit 16 banks). Each thread owns a 4x4 patch of the score
// tile (rows ty*4.., cols tx + 16*j) and a 4 x ceil(Dv/16) patch of the
// accumulator in registers. Row max and row sum reduce over the 16 threads
// of a row with warp shuffles. Under the causal mask, K tiles strictly
// above the diagonal are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;   // finite start for the running max

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

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int H, int KH, int Sq, int Sk, int D, int Dv,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   float scale, int causal) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
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

}  // namespace

// fp32 on CUDA cores. Strides are in elements. Returns a cudaError_t as int.
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, void* stream) {
  if (bad_args(B, H, KH, Sq, Sk, D, Dv)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p = make_params(q, k, v, o, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
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
    const void* q, const void* k, const void* v, void* o,
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
  const Params p = make_params(q, k, v, o, H, KH, Sq, Sk, D, Dv, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_tile == 64 && dv_tile == 64) return launch_bf16<64, 64>(p, B, s);
  if (d_tile == 128 && dv_tile == 128) return launch_bf16<128, 128>(p, B, s);
  if (d_tile == 192 && dv_tile == 128) return launch_bf16<192, 128>(p, B, s);
  if (d_tile == 256 && dv_tile == 256) return launch_bf16<256, 256>(p, B, s);
  return cudaErrorInvalidValue;
}

// Message for a code returned by the entry points of this library.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
