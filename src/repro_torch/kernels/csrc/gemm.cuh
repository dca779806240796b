// Building blocks shared by the fused routed-block kernels
// (routed_attention.cu, routed_mlp.cu) and the SwiGLU MLP (swiglu.cu): two
// GEMMs with fused epilogues, an RMSNorm over rows (optionally gathered by
// index), and the rounding and activation helpers that put the
// working-type roundings where the JAX mirrors put them.
//
// GEMM on CUDA cores (gemm): C[M, N] = A[M, K] @ B[K, N], A and B row-major
// in the working type T (f32 or bf16), the sum in f32. A block of 256
// threads owns a 64 x 64 tile of C and walks K in steps of 16, staging both
// tiles in shared memory as f32 (A transposed, padded by one float against
// bank conflicts); each thread accumulates a 4 x 4 sub-tile. With two B
// matrices (a GLU, or routed attention's k and v) the block keeps two
// accumulators and reads A once. Every edge is masked, so M, N and K need
// not divide the tile. It is bound by shared-memory traffic and the FMA
// rate; f32 products and bf16 ones whose shapes the tensor-core GEMM does
// not take run on it.
//
// GEMM on Hopper's tensor cores (gemm_wgmma, bf16): see its note below.
// Products are computed here, never by a library.
#pragma once

#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled (kernels/build.py links -lcuda)
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

// the GEMM a wrapper chose for a call (kernels/swiglu.py::GEMM_PATHS)
#define REPRO_GEMM_CUDA_CORES 0
#define REPRO_GEMM_WGMMA 1

namespace fused {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);  // 256

// round an f32 value to T and back (a no-op for f32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// activations in f32, the formulas of PyTorch's silu and tanh-gelu
// (jax.nn.gelu's default), which the plain versions call
__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == 0) return __fdiv_rn(x, 1.0f + expf(-x));
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

template <typename T, int NB, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B0, const T* __restrict__ B1,
            int M, int N, int K, Epi epi) {
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[NB][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: consecutive threads read consecutive k of one row
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(A[(long long)gm * K + gk]) : 0.f;
    }
    // B tile(s): consecutive threads read consecutive n of one row
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const long long off = (long long)gk * N + gn;
      Bs[0][r][c] = ok ? to_f32(B0[off]) : 0.f;
      if (NB == 2) Bs[NB - 1][r][c] = ok ? to_f32(B1[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[b][kk][tx * TN]);
        const float bb[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[b][i][j] = fmaf(a[i], bb[j], acc[b][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < N) epi(r, c, acc[0][i][j], acc[NB - 1][i][j]);
    }
  }
}

template <typename T, int NB, class Epi>
cudaError_t gemm(const T* A, const T* B0, const T* B1, int M, int N, int K, Epi epi,
                 cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, NB, Epi><<<grid, GEMM_THREADS, 0, st>>>(A, B0, B1, M, N, K, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The same GEMM for bf16 on Hopper's tensor cores (wgmma + TMA), used by
// swiglu.cu, routed_mlp.cu and routed_attention.cu: C = A @ B (and A @ B1,
// reading A once) with A (M, K) and B (K, N) row-major bf16, the sums in
// f32, the epilogues below called per element with those sums. N and K must be multiples of 8
// (TMA's 16-byte global strides) and every base 16-byte aligned; M is any
// count from 1 up. The wrapper chooses this path or the CUDA-core GEMM
// above from the dtype and the shape before launch (kernels/swiglu.py::
// gemm_path); gemm_wgmma refuses operands that do not fit it.
//
// Design (sm_90a), and why:
// - Tiles of 128 x 128 outputs, K in steps of 64 (128 bytes of bf16: one
//   row of the 128-byte swizzle that wgmma reads without bank conflicts).
//   Two consumer warpgroups of 64 rows keep one 64 x 128 f32 accumulator
//   per B matrix, 64 registers a thread (128 with the GLU's two), which
//   fits their register budget with no spill; a 256-wide tile would not
//   with two B matrices.
// - 3 warpgroups. Warpgroup 0 is the producer: `setmaxnreg` drops it to 40
//   registers and gives the consumers 232, and one of its threads keeps TMA
//   loads in flight into a ring of as many stages as 192 KB of shared
//   memory holds (4 of 48 KB with two B matrices, 6 of 32 KB with one),
//   each with a "full" mbarrier (TMA's transaction bytes) and an "empty"
//   one (one arrival per consumer warpgroup). A is loaded as a 64 x 128 box
//   (K-major, 128-byte swizzle); B is MN-major (row-major (K, N)) and is
//   loaded as two 64 x 64 boxes per stage, which wgmma reads with its
//   transpose bit: no copy of B. Rows and columns outside M, N and K load
//   as zeros (TMA's bounds) and are not stored.
// - The consumers issue wgmma.mma_async m64n128k16 with both operands in
//   shared memory and keep one group in flight: a stage is released once
//   the next stage's products are issued and the group before them is done.
// - Persistent blocks: min(tiles, SMs) blocks walk the tiles in a fixed
//   grouped order (8 row tiles by every column tile), so the blocks that run
//   together share A row panels and B column panels in L2, and a block's
//   producer loads its next tile while the consumers run the epilogue.
// - K is summed in one fixed order (no split-K), so two calls give the same
//   bits and a CUDA-graph replay equals an eager call. The tensor maps are
//   encoded on the host per call (cuTensorMapEncodeTiled) and passed as
//   __grid_constant__ parameters, so a captured launch keeps its own.
// - Wave quantization: at mod-paper-1b's M = 1024 the down product has
//   8 x 14 = 112 tiles for 132 SMs and the gate/up product 448 (3.4 per
//   SM), so about 15% of the SMs idle in the last round; at M = 8192 the
//   rounds are 97% full. Smaller tiles do not help (224 half tiles take
//   two rounds), and a split of K would need a second pass and another sum
//   order, so the design accepts it; a 112-wide tile (1792 = 16 x 112) is
//   the candidate fix.
// Bound on the H100: operations (989 TFLOP/s bf16 dense) for every product
// of the MoD path: 2·M·N·K FLOP against (M·K + K·N + M·N)·2 bytes.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64;
constexpr int WG_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int WG_GROUP_M = 8;    // row tiles per group of the tile order
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // one A stage: 128 rows of 128 bytes
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;  // one B stage: two 64-column boxes
constexpr int WG_B_BOX = WG_B_BYTES / 2;       // of 64 K rows of 128 bytes

// the ring of stages with NB B matrices
template <int NB>
struct WgRing {
  static constexpr int STAGES = NB == 2 ? 4 : 6;
  static constexpr int STAGE = WG_A_BYTES + NB * WG_B_BYTES;  // bytes of one stage
  // the stages, their barriers, and 1 KB to align the ring
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 2 * (int)sizeof(uint64_t));
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// TMA: the box at (c0 innermost, c1) of the tensor map into shared memory,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// ... of a rank-4 tensor map (coordinates innermost first)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products that own them
template <int NJ>
__device__ __forceinline__ void fence_acc(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// the same for A fragments in registers: a product reads them
// asynchronously, so they must stay where they are until it is waited on
template <int NK>
__device__ __forceinline__ void fence_frag(unsigned (&a)[NK][4]) {
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// m64nNk16 products with the accumulator as [N/8][4] (per 8 columns j,
// registers [j][0..1] are row lane/4 of the warp's 16, columns
// 2(lane%4)+{0,1}; [j][2..3] the same 8 rows below: the m16n8 fragment of
// mma.sync). ss: A and B from shared memory, A K-major; scale_d = 0 starts
// the sum. rs: A from registers (each warp's m16n8k16 A fragment of its
// 16 rows). TB = 1: B is MN-major (the descriptor's transpose), 0: K-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]),
        "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]),
        "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),
        "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]),
        "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const unsigned (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]),
        "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]),
        "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),
        "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]),
        "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 128, "m64n128k16 (the only width a caller takes from shared memory)");
  wgmma_ss_n128<TB>(d, da, db, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const unsigned (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  else wgmma_rs_n128<TB>(d, a, db, scale_d);
}

// tile t of the fixed order: groups of WG_GROUP_M row tiles, row tile
// fastest within a group
__device__ __forceinline__ void wg_tile(int t, int num_m, int num_n, int& m_blk, int& n_blk) {
  const int span = WG_GROUP_M * num_n;
  const int first = t / span * WG_GROUP_M;
  const int rows = min(num_m - first, WG_GROUP_M);
  const int rem = t % span;
  m_blk = first + rem % rows;
  n_blk = rem / rows;
}

template <int NB, class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tmA, __grid_constant__ const CUtensorMap tmB0,
                  __grid_constant__ const CUtensorMap tmB1, int M, int N, int K, Epi epi) {
  constexpr int STAGES = WgRing<NB>::STAGES, STAGE = WgRing<NB>::STAGE;
  extern __shared__ unsigned char wg_smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte-aligned shared addresses
  unsigned char* ring = wg_smem_raw + ((1024 - smem_addr(wg_smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int num_m = (M + WG_BM - 1) / WG_BM, num_n = (N + WG_BN - 1) / WG_BN;
  const int tiles = num_m * num_n, ktiles = (K + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_THREADS / 128 - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m_blk, n_blk;
        wg_tile(t, num_m, num_n, m_blk, n_blk);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          unsigned char* st = ring + stage * STAGE;
          mbar_expect_tx(&full[stage], STAGE);  // out-of-range boxes count in full
          tma_load_2d(st, &tmA, &full[stage], kt * WG_BK, m_blk * WG_BM);
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              tma_load_2d(st + WG_A_BYTES + b * WG_B_BYTES + j * WG_B_BOX, b == 0 ? &tmB0 : &tmB1,
                          &full[stage], n_blk * WG_BN + j * 64, kt * WG_BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: rows (wg - 1) * 64 .. + 64 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = (wg - 1) * 64;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[NB][WG_BN / 8][4];
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m_blk, n_blk;
      wg_tile(t, num_m, num_n, m_blk, n_blk);
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          // A: rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart; a
          // k16 step is 32 bytes along the row
          const uint64_t da = wg_desc(st + row0 * 128 + kk * 32, 16, 1024);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            // B: 16 K rows of 128 bytes per k16 step; the two 64-column
            // boxes WG_B_BOX apart (leading), 8-row atoms 1024 apart (stride)
            const uint64_t db = wg_desc(st + WG_A_BYTES + b * WG_B_BYTES + kk * 2048, WG_B_BOX,
                                        1024);
            wgmma_ss<WG_BN, 1>(acc[b], da, db, kt > 0 || kk > 0);
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();  // the stage before this one has been read
          if (tid == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_acc(acc[b]);
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);

      // accumulator layout of m64nNk16: warp w holds rows 16w..16w+15; per
      // 8 columns j, registers [j][0..1] are row lane/4, columns
      // 2(lane%4)+{0,1}, and [j][2..3] the same 8 rows below
      const int r0 = m_blk * WG_BM + row0 + warp * 16 + lane / 4;
      const int c0 = n_blk * WG_BN + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8, c = c0 + j * 8 + (e & 1);
          if (r < M && c < N) epi(r, c, acc[0][j][e], acc[NB - 1][j][e]);
        }
    }
  }
}

// a tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1.. ), loaded in boxes of `box` elements; zeros outside
inline cudaError_t encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major bf16 (rows, cols) matrix, loaded in boxes of box_rows x 64
// columns (128 bytes) with the 128-byte swizzle; zeros outside
inline cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rows, int cols,
                               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// whether gemm_wgmma takes these operands (kernels/swiglu.py::gemm_path
// decides the same from the shapes before launch)
inline bool wgmma_ok(const void* A, const void* B0, const void* B1, int M, int N, int K) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B0) |
                      reinterpret_cast<uintptr_t>(B1);
  return M >= 1 && N >= 8 && K >= 8 && N % 8 == 0 && K % 8 == 0 && a % 16 == 0;
}

template <int NB, class Epi>
cudaError_t gemm_wgmma(const __nv_bfloat16* A, const __nv_bfloat16* B0, const __nv_bfloat16* B1,
                       int M, int N, int K, Epi epi, cudaStream_t st) {
  if (NB == 1) B1 = B0;
  if (!wgmma_ok(A, B0, B1, M, N, K)) return cudaErrorInvalidValue;
  CUtensorMap ta, tb0, tb1;
  cudaError_t err = encode_bf16(&ta, A, M, K, WG_BM);
  if (err == cudaSuccess) err = encode_bf16(&tb0, B0, K, N, WG_BK);
  if (err == cudaSuccess) err = encode_bf16(&tb1, B1, K, N, WG_BK);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma_kernel<NB, Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgRing<NB>::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_wgmma_kernel<NB, Epi><<<grid, WG_THREADS, WgRing<NB>::SMEM, st>>>(ta, tb0, tb1, M, N, K,
                                                                         epi);
  return cudaGetLastError();
}

// the product on the path the wrapper chose: REPRO_GEMM_WGMMA (bf16 only)
// or REPRO_GEMM_CUDA_CORES
template <typename T, int NB, class Epi>
cudaError_t gemm_on(int path, const T* A, const T* B0, const T* B1, int M, int N, int K, Epi epi,
                    cudaStream_t st) {
  if (path == REPRO_GEMM_CUDA_CORES) return gemm<T, NB>(A, B0, B1, M, N, K, epi, st);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (path == REPRO_GEMM_WGMMA) return gemm_wgmma<NB>(A, B0, B1, M, N, K, epi, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Epilogues: called once per output element with the f32 sum(s)
// ---------------------------------------------------------------------------

// C = T(acc), then with a bias C = T(C + bias) (the mirror's `x @ w`, then
// `+ b`, each rounded to the working type)
template <typename T>
struct EpiStore {
  T* C;
  const T* bias;
  int ldc;
  __device__ __forceinline__ void operator()(int r, int c, float v, float) const {
    float y = rnd<T>(v);
    if (bias != nullptr) y = __fadd_rn(y, to_f32(bias[c]));
    C[(long long)r * ldc + c] = from_f32<T>(y);
  }
};

// C = T(acc) and H = T(R + C): the out-projection and the residual h = x + a
template <typename T>
struct EpiResid {
  T* C;
  T* H;
  const T* R;
  int ldc;
  __device__ __forceinline__ void operator()(int r, int c, float v, float) const {
    const long long o = (long long)r * ldc + c;
    const float a = rnd<T>(v);
    C[o] = from_f32<T>(a);
    H[o] = from_f32<T>(__fadd_rn(to_f32(R[o]), a));
  }
};

// GLU hidden: g = T(h @ w_gate), u = T(h @ w_up), C = T(T(act(g)) * u)
template <typename T>
struct EpiGlu {
  T* C;
  int ldc;
  int act;
  __device__ __forceinline__ void operator()(int r, int c, float vg, float vu) const {
    const float g = rnd<T>(vg), u = rnd<T>(vu);
    const float a = rnd<T>(act_fn(g, act));
    C[(long long)r * ldc + c] = from_f32<T>(__fmul_rn(a, u));
  }
};

// SwiGLU hidden of the unrouted MLP kernel (swiglu.cu): C = T(silu(g) * u)
// from the f32 sums g = x @ w_gate, u = x @ w_up, rounded once (the Pallas
// _swiglu_kernel's h, unlike the routed mirror's EpiGlu)
template <typename T>
struct EpiSwiglu {
  T* C;
  int ldc;
  __device__ __forceinline__ void operator()(int r, int c, float vg, float vu) const {
    C[(long long)r * ldc + c] = from_f32<T>(__fmul_rn(act_fn(vg, 0), vu));
  }
};

// plain MLP hidden: C = T(act(T(h @ w_up)))
template <typename T>
struct EpiAct {
  T* C;
  int ldc;
  int act;
  __device__ __forceinline__ void operator()(int r, int c, float v, float) const {
    C[(long long)r * ldc + c] = from_f32<T>(act_fn(rnd<T>(v), act));
  }
};

// The Eq. 1 combine as the down-projection's epilogue. Row r = b*k + i of
// the routed rows lands on sequence row s = idx[r] of batch row b:
//   m = T(acc); delta = T(a + m); upd = T(gate * f32(delta));
//   out[b, s] = T(x[b, s] + upd)
// (out already holds a copy of x; idx is unique per batch row, so no two
// threads write one element). __fmul_rn / __fadd_rn keep the product and
// the sum separately rounded, as the plain version computes them.
template <typename T>
struct EpiScatter {
  const T* a;
  const long long* idx;
  const float* gate;
  const T* x;
  T* out;
  int k, S, D;
  __device__ __forceinline__ void operator()(int r, int c, float v, float) const {
    const long long s = idx[r];
    if (s < 0 || s >= S) return;
    const int b = r / k;
    const float m = rnd<T>(v);
    const float delta = rnd<T>(__fadd_rn(to_f32(a[(long long)r * D + c]), m));
    const float upd = rnd<T>(__fmul_rn(gate[r], delta));
    const long long o = ((long long)b * S + s) * D + c;
    out[o] = from_f32<T>(__fadd_rn(to_f32(x[o]), upd));
  }
};

// ---------------------------------------------------------------------------
// RMSNorm over rows: one block of 256 threads per row, f32 statistics.
// With idx, row r = b*k + i reads x[b, idx[r]] (an index outside [0, S)
// reads a zero row, as the one-hot gather does) and also writes the
// gathered row to xs; without, row r reads x[r].
//   var = sum(x^2) / D;  y = x * rsqrt(var + eps);  hn = T(y * f32(scale))
// ---------------------------------------------------------------------------

constexpr int NORM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const long long* __restrict__ idx,
                    const T* __restrict__ scale, T* __restrict__ xs, T* __restrict__ hn, int k,
                    int S, int D, float eps) {
  __shared__ float partial[NORM_THREADS / 32];
  const int r = blockIdx.x;
  const T* src = nullptr;
  if (idx != nullptr) {
    const long long s = idx[r];
    if (s >= 0 && s < S) src = x + ((long long)(r / k) * S + s) * D;
  } else {
    src = x + (long long)r * D;
  }
  float ss = 0.f;
  if (src != nullptr)
    for (int d = threadIdx.x; d < D; d += NORM_THREADS) {
      const float v = to_f32(src[d]);
      ss = fmaf(v, v, ss);
    }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) tot += partial[w];
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)D), eps));
  T* hrow = hn + (long long)r * D;
  T* xrow = xs == nullptr ? nullptr : xs + (long long)r * D;
  for (int d = threadIdx.x; d < D; d += NORM_THREADS) {
    const T raw = src == nullptr ? from_f32<T>(0.f) : src[d];
    if (xrow != nullptr) xrow[d] = raw;
    hrow[d] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(raw), inv), to_f32(scale[d])));
  }
}

template <typename T>
cudaError_t rmsnorm_rows(const T* x, const long long* idx, const T* scale, T* xs, T* hn,
                         int rows, int k, int S, int D, float eps, cudaStream_t st) {
  rmsnorm_rows_kernel<T><<<rows, NORM_THREADS, 0, st>>>(x, idx, scale, xs, hn, k, S, D, eps);
  return cudaGetLastError();
}

}  // namespace fused

#define FUSED_TRY(expr)                          \
  do {                                           \
    const cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)
