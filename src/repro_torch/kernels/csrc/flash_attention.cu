// Position-masked GQA attention with an online softmax, forward. When
// the caller passes an lse buffer, the kernel also writes each query row's
// f32 log-sum-exp (B, nq, Sq), from which the backward (torch ops in
// kernels/flash_attention.py) recomputes p.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). Same function: q (B,Sq,nq,hd) against
// k/v (B,Skv,nkv,hd); masks come from q_pos/kv_pos (-1 = padding),
// causality is kv_pos <= q_pos on original positions, an optional sliding
// window; query head h reads kv head h*nkv/nq; scores and the softmax are
// f32 (a masked score is -1e30), the row sum l is taken over the unrounded
// f32 p, p is cast to V's type before p@V, and a query row with no valid
// key comes out as 0 with lse log(1e-30). The layout is the JAX package's
// (no transposes): the kernels compute their own offsets. Unlike the
// Pallas kernel, Sq and Skv need not divide the tile sizes: ragged edges
// are masked here.
//
// Four paths; kernels/flash_attention.py::flash_plan picks one from the
// dtype, Sq, nq/nkv and the head dim alone (never from Skv or B, so a
// row's bits do not depend on them), and this file refuses a plan that is
// not its own:
//
// 1. bf16 on wgmma + TMA (prefill, chunked prefill, training, routed
//    sub-sequences; head dims 64 and 128). One block per (64 query rows,
//    head, batch row): a producer warpgroup whose first warp keeps TMA
//    loads of K/V tiles of 128 keys (128-byte swizzle; its lanes store
//    the tile's int32 key positions beside them) in flight into a ring of
//    stages with full/empty mbarriers, and two consumer warpgroups that both hold the
//    block's 64 rows and split its key tiles by the tile index's parity
//    (even tiles to the first, odd to the second). Each runs S = Q K^T
//    (wgmma m64n128k16, Q and K from shared memory), the mask and online
//    softmax on the accumulator fragments, and O += P V with P in
//    registers as the A operand and V read MN-major through the
//    descriptor's transpose bit. At the end the two (m, l, O) merge through
//    shared memory as w0*x0 + w1*x1 (each product rounded, so the sum is
//    the same whichever warpgroup forms it), each warpgroup finishing half
//    the columns. The split halves the serial chain of key tiles a block
//    walks (the critical path at B=1, where the grid is about one wave),
//    and blocks run the query tiles with the most keys first. gemm.cuh's
//    helpers (tensor maps, mbarriers, descriptors, setmaxnreg) are shared.
// 2. bf16 on mma.sync tiles (head dims 32, 80 and 256: a 64- or 160-byte
//    row is not whole 128-byte swizzle atoms, and 256 columns of O do not
//    fit a consumer's registers beside S): one block of 4 warps per (64 query
//    rows, head, batch row), 16 rows per warp. K/V tiles of 64 keys (32 at
//    head_dim 256) stay bf16 in shared memory, double-buffered through
//    cp.async (rows padded by 16 bytes so ldmatrix hits distinct banks; at
//    head dim 80 a row is 88 elements, 11 sixteen-byte chunks, and 8 rows'
//    chunks still land in 8 distinct groups of 4 banks).
//    S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 sums) with Q's fragments
//    in registers at head dim 32; the mask and the online softmax work on
//    the accumulator fragments (quad shuffles for the row max and sum;
//    scores carry log2(e), so p = 2^(s - m); a tile in which every pair of
//    a warp's rows is valid skips the mask); p goes to bf16 in registers
//    and is the A operand of P V, with V through ldmatrix.trans.
// 3. bf16 decode (Sq * nq/nkv <= 16): the 16 rows of one mma tile are the
//    (query position, query head of the group) pairs of one kv head, so
//    K/V are read once per kv head. Keys are split into chunks of
//    decode_chunk(hd) key indices (fixed), and one block of 4 warps per
//    (chunk, kv head, batch row) gives each warp a fixed quarter of the
//    chunk, so 4 warps' loads are in flight per chunk. The warps' partial
//    (m, l, O) merge in warp order through shared memory; a row whose keys
//    fit one chunk is written there (one launch), otherwise the chunk's
//    partial goes to f32 scratch the wrapper allocates and a second small
//    kernel merges the chunks in order. A quarter or chunk with no valid
//    key adds exact zeros (l = 0, acc = 0, weight 0), so the bits equal
//    whatever the number of chunks.
// 4. f32: the CUDA-core kernel below (no TF32: f32 results stay within 2e-5
//    of the plain version, which the CPU-vs-card parity phases rely on).
//
// Tiles are skipped by position, never by index (ring caches wrap, routed
// sub-sequences have gaps): a block walks only the key tiles between the
// first and the last key that some (query, key) pair of the block can
// use, and a warp (warpgroup on path 1) skips the compute of a tile in
// which none of its rows has a valid key. Skipping a tile with no valid
// pair is exact: it would rescale by 2^0 = 1 and add zeros.
//
// Bound on the H100: bytes for decode (each kv head's valid keys are read
// once), operations for long prefill (4*Sq*Skv*hd per head, half of it
// masked by causality). No kernel allocates or synchronises with the host
// (tensor maps are encoded per call and passed by value), so every path is
// capturable in a CUDA graph.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"  // TMA, mbarriers, wgmma descriptors and products (sm_90a)

REPRO_ERROR_STRING

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's masked score

// path codes passed by kernels/flash_attention.py (_PATHS)
constexpr int PATH_F32 = 0, PATH_MMA = 1, PATH_DECODE = 2, PATH_WGMMA = 3;

// ===========================================================================
// f32: CUDA cores. One block of 4 warps per (q-tile of 16 rows, head, batch
// row); the 16 query rows sit in shared memory in f32, and a loop walks K/V
// in tiles of 32 keys staged in shared memory (K rows padded by one float so
// 32 lanes reading 32 keys hit 32 banks). Each warp owns 4 query rows; for a
// row, lane j scores key j of the tile, the warp reduces the tile's max and
// sum, and lane j accumulates output columns j, j + 32, ... below head_dim
// (ceil(head_dim/32) of them; at 80 the third covers 16 lanes). A tile in
// which no (query, key) pair of the block can be valid is skipped before
// its K/V are loaded.
// ===========================================================================

constexpr int BQ = 16;             // query rows per block
constexpr int BKV = 32;            // keys per tile (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int nq, int nkv, float scale, int causal, int window) {
  constexpr int DPL = (HD + 31) / 32;  // output columns per lane, the last maybe partial
  // whether column lane + 32*i exists (always, when 32 divides the head dim)
  auto has_col = [](int i, int lane_) { return HD % 32 == 0 || lane_ + 32 * i < HD; };
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x HD
  float* sK = sQ + BQ * HD;         // BKV x (HD + 1)
  float* sV = sK + BKV * (HD + 1);  // BKV x HD
  __shared__ int sQp[BQ];
  __shared__ int sKp[BKV];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = (int)((long long)h * nkv / nq);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BQ;

  for (int e = tid; e < BQ * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sQ[e] = s < Sq ? q[(((long long)b * Sq + s) * nq + h) * HD + d] : 0.f;
  }
  if (tid < BQ) {
    const int s = q0 + tid;
    sQp[tid] = s < Sq ? qpos[(long long)b * Sq + s] : -1;
  }
  __syncthreads();
  int qmax = -1, qmin = INT_MAX;
  for (int r = 0; r < BQ; ++r) {
    const int p = sQp[r];
    if (p >= 0) {
      qmax = max(qmax, p);
      qmin = min(qmin, p);
    }
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  if (qmax >= 0) {  // block-uniform: some query row of the tile is valid
    for (int j0 = 0; j0 < Skv; j0 += BKV) {
      if (tid < BKV) {
        const int j = j0 + tid;
        sKp[tid] = j < Skv ? kpos[(long long)b * Skv + j] : -1;
      }
      __syncthreads();
      int cand = 0;
      if (tid < BKV) {
        const int kp = sKp[tid];
        cand = kp >= 0 && (!causal || kp <= qmax) && (window <= 0 || kp > qmin - window);
      }
      if (!__syncthreads_or(cand)) continue;  // no valid pair in this tile

      for (int e = tid; e < BKV * HD; e += blockDim.x) {
        const int r = e / HD, d = e % HD, j = j0 + r;
        float kv = 0.f, vv = 0.f;
        if (j < Skv) {
          const long long off = (((long long)b * Skv + j) * nkv + hk) * HD + d;
          kv = k[off];
          vv = v[off];
        }
        sK[r * (HD + 1) + d] = kv;
        sV[r * HD + d] = vv;
      }
      __syncthreads();

      const int kp = sKp[lane];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp + rr * NWARPS;
        const int qp = sQp[r];
        if (qp < 0) continue;  // warp-uniform: a padded query row stays 0
        const bool valid =
            kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        const float* qr = sQ + r * HD;
        const float* kr = sK + lane * (HD + 1);
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
        s = valid ? s * scale : NEG_INF;
        const float m_prev = m[rr];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float m_safe = m_new > NEG_INF / 2 ? m_new : 0.f;
        const float p = valid ? expf(s - m_safe) : 0.f;
        const float corr = m_prev > NEG_INF / 2 ? expf(m_prev - m_safe) : 0.f;
        l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);  // V is f32: p unrounded
          const float* vr = sV + j * HD + lane;
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            if (has_col(i, lane)) acc[rr][i] = fmaf(pj, vr[32 * i], acc[rr][i]);
        }
        m[rr] = m_new;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = q0 + warp + rr * NWARPS;
    if (s >= Sq) continue;
    const float lf = fmaxf(l[rr], 1e-30f);
    float* orow = out + (((long long)b * Sq + s) * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (has_col(i, lane)) orow[lane + 32 * i] = acc[rr][i] / lf;
    if (lse != nullptr && lane == 0)  // a row with no valid key: m is -inf or NEG_INF
      lse[((long long)b * nq + h) * Sq + s] = (m[rr] > NEG_INF / 2 ? m[rr] : 0.f) + logf(lf);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
               void* out, float* lse, int B, int Sq, int Skv, int nq, int nkv, float scale,
               int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(BQ * HD + BKV * (HD + 1) + BKV * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> attr_set{0};
    const cudaError_t err = smem_limit_once(attr_set, flash_fwd_kernel<HD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((Sq + BQ - 1) / BQ, nq, B);
  flash_fwd_kernel<HD><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, static_cast<float*>(out), lse, Sq, Skv, nq, nkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bf16: tensor cores (f32 accumulators)
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int TILE_WARPS = 4;    // mma.sync tile path: 4 warps per block
constexpr int DECODE_ROWS = 16;  // decode path: one mma tile of (position, head) rows
constexpr int DECODE_WARPS = 4;  // decode path: warps of a chunk, a quarter each
constexpr float LOG2E = 1.4426950408889634f;  // scores carry log2(e): p = 2^(s - m)
constexpr float LN2 = 0.6931471805599453f;

// keys per K/V tile of the mma.sync tile path, per decode chunk (a fixed
// multiple of the tile) and per warp of a decode chunk
__host__ __device__ constexpr int key_tile(int hd) { return hd == 256 ? 32 : 64; }
__host__ __device__ constexpr int decode_chunk(int hd) { return 2 * key_tile(hd); }
__host__ __device__ constexpr int decode_warp_keys(int hd) {
  return decode_chunk(hd) / DECODE_WARPS;
}
// the mma.sync tile path keeps Q's fragments in registers at head dim 32
// (<= 128), staging Q in the second K stage (read into registers before
// that stage is first filled), which leaves room for 3 blocks per SM; at
// 256 it re-reads them from shared memory
__host__ __device__ constexpr bool q_in_registers(int hd) { return hd <= 128; }

// One m16 row tile against one key tile: mask and scale the scores in the
// accumulator fragments (e = 0, 1: row lane/4; e = 2, 3: row lane/4 + 8),
// update the running max m and sum l of the two rows, rescale O and turn
// the scores into p. `full`: every pair of the tile is valid (no mask).
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&sc)[NS][4], const int (&qp)[2],
                                               const int* kp, int nvalid, bool full, float sl,
                                               int causal, int window, float (&m)[2],
                                               float (&l)[2], float (&o)[NO][4]) {
  const int lane = threadIdx.x & 31;
  // one validity bit per score of the tile (64 at 128 keys)
  using Mask = typename std::conditional<(NS * 4 > 32), unsigned long long, unsigned>::type;
  Mask valid = 0;
  float mx[2] = {NEG_INF, NEG_INF};
  if (full) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] *= sl;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        const int kpv = kp[c], q = qp[e >> 1];
        const bool ok = c < nvalid && q >= 0 && kpv >= 0 && (!causal || kpv <= q) &&
                        (window <= 0 || q - kpv < window);
        sc[nt][e] = ok ? sc[nt][e] * sl : NEG_INF;
        valid |= (Mask)ok << (nt * 4 + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
  }
  float ms[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float mn = fmaxf(m[hf], quad_max(mx[hf]));
    ms[hf] = mn > NEG_INF / 2 ? mn : 0.f;
    corr[hf] = m[hf] > NEG_INF / 2 ? exp2f(m[hf] - ms[hf]) : 0.f;
    m[hf] = mn;
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          full || ((valid >> (nt * 4 + e)) & 1) ? exp2f(sc[nt][e] - ms[e >> 1]) : 0.f;
      sc[nt][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * corr[hf] + quad_sum(sum[hf]);
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
}

// dynamic shared memory of an mma.sync tile-path block: Q (unless it is
// staged in the second K stage), two stages of K/V tiles and their
// positions, the rows' positions
template <int HD>
constexpr size_t tc_smem_bytes() {
  constexpr int BN = key_tile(HD), LD = HD + 8, QR = 16 * TILE_WARPS;
  constexpr int q_elems = q_in_registers(HD) ? 0 : QR * LD;
  return (size_t)(q_elems + 4 * BN * LD) * sizeof(bf16) + (size_t)(2 * BN + QR + 4) * sizeof(int);
}

// ---------------------------------------------------------------------------
// Path 1: wgmma + TMA (head dims 64 and 128)
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;      // query rows of a block: one m64 tile
constexpr int WG_KEYS = 128;     // keys per K/V tile (kernels/flash_attention.py: WGMMA_KEY_TILE)
constexpr int WG_SPLIT = 2;      // consumer warpgroups, one per key-tile parity
constexpr int WG_THREADS = 128 * (1 + WG_SPLIT);  // producer warpgroup + consumers

// shared memory of a block: Q (64 rows in 128-byte column chunks), then a
// ring of stages (K, V, the tile's int32 key positions), then the
// barriers and the block's reductions. Every TMA box starts 1024-aligned
// (the 128-byte swizzle's atom).
template <int HD>
struct WgFlash {
  static constexpr int CH = HD / 64;                      // 128-byte column chunks of a row
  static constexpr int Q_BYTES = WG_ROWS * HD * 2;
  static constexpr int KV_BYTES = WG_KEYS * HD * 2;       // K or V of one tile
  static constexpr int POS_OFF = 2 * KV_BYTES;            // the tile's key positions
  static constexpr int TX = 2 * KV_BYTES;                 // bytes TMA brings into a stage
  static constexpr int STAGE = 2 * KV_BYTES + 1024;
  static constexpr int STAGES = HD == 128 ? 3 : 5;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + 1024;
  static_assert(HD == 64 || HD == 128, "the wgmma path takes head dims 64 and 128");
  // the merge's exchange (half of each warpgroup's O, and its m and l)
  // reuses the first stage once both warpgroups are done with the ring
  static_assert((2 * (HD / 16) * 4 * 128 + 2 * 4 * 128) * 4 <= STAGE, "exchange fits a stage");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// whether `v` holds for some thread of the warpgroup that calls it (a
// named barrier of 128 threads)
__device__ __forceinline__ bool wg_any(bool v, int id) {
  unsigned r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((unsigned)v), "r"(id)
      : "memory");
  return r != 0;
}

// The merge's exchange: warpgroup `cw` hands the other one the column half
// it does not finish (its accumulators in fragment order: the other
// warpgroup's thread of the same index holds the same rows and columns).
template <int NO, int HALF>
__device__ __forceinline__ void wg_send(float (&o)[NO][4], float* xo, int ct) {
#pragma unroll
  for (int jj = 0; jj < NO / 2; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xo[((HALF * (NO / 2) + jj) * 4 + e) * 128 + ct] = o[HALF * (NO / 2) + jj][e];
}

// ... and finishes its own half: x = w0*x0 + w1*x1 with x0 the first
// warpgroup's value, each product rounded, then out = x / max(l, 1e-30)
template <int HD, int HALF>
__device__ __forceinline__ void wg_finish(float (&o)[HD / 8][4], const float* xo, int ct,
                                          const float (&w0)[2], const float (&w1)[2],
                                          const float (&lf)[2], bf16* orow0, bf16* orow1,
                                          int col) {
  constexpr int NO = HD / 8;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    bf16* orow = hf ? orow1 : orow0;
    if (orow == nullptr) continue;
#pragma unroll
    for (int jj = 0; jj < NO / 2; ++jj) {
      constexpr int J0 = HALF * (NO / 2);
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float mine = o[J0 + jj][2 * hf + c];
        const float other = xo[((J0 + jj) * 4 + 2 * hf + c) * 128 + ct];
        const float x0 = HALF == 0 ? mine : other, x1 = HALF == 0 ? other : mine;
        x[c] = __fadd_rn(__fmul_rn(w0[hf], x0), __fmul_rn(w1[hf], x1)) / lf[hf];
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + (J0 + jj) * 8 + col) =
          __floats2bfloat162_rn(x[0], x[1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV, const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    bf16* __restrict__ out, float* __restrict__ lse, int B, int Sq, int Skv,
                    int nq, int nkv, int n_qt, float scale, int causal, int window) {
  using W = WgFlash<HD>;
  constexpr int NS = WG_KEYS / 8;   // n8 column groups of S
  constexpr int NO = HD / 8;        // n8 column groups of O
  constexpr int KQ = HD / 16;       // k16 steps of Q K^T
  constexpr int KP = WG_KEYS / 16;  // k16 steps of P V
  constexpr int NT = WG_THREADS;
  constexpr int PRE = 4;            // key positions a thread loads before the query range is known
  extern __shared__ unsigned char wgf_smem_raw[];
  unsigned char* sQ = wgf_smem_raw + ((1024 - smem_addr(wgf_smem_raw) % 1024) % 1024);
  unsigned char* ring = sQ + W::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + W::STAGES * W::STAGE);
  uint64_t* empty = full + W::STAGES;
  uint64_t* qbar = empty + W::STAGES;
  int* sRed = reinterpret_cast<int*>(qbar + 1);  // qmax, qmin, first key, last key
  int* sQp = sRed + 4;                           // the block's WG_ROWS query positions

  // the query tiles with the most keys (the last, under causality) first
  const int bh = blockIdx.x % (B * nq);
  const int qt = n_qt - 1 - blockIdx.x / (B * nq);
  const int b = bh / nq, h = bh % nq;
  const int hk = (int)((long long)h * nkv / nq);
  const int q0 = qt * WG_ROWS;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      fused::mbar_init(&full[s], 1 + 32);  // the TMA transaction; each producer lane's positions
      fused::mbar_init(&empty[s], 128);  // every thread of the consuming warpgroup
    }
    fused::mbar_init(qbar, 1);
    sRed[0] = -1;
    sRed[1] = INT_MAX;
    sRed[2] = INT_MAX;
    sRed[3] = -1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's query positions, and the first key positions of the scan
  // below (loaded together: one round trip)
  int kp_pre[PRE];
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int j = tid + i * NT;
    kp_pre[i] = j < Skv ? kpos[(long long)b * Skv + j] : -1;
  }
  int qpv = -1;
  if (tid < WG_ROWS) {
    const int s = q0 + tid;
    qpv = s < Sq ? qpos[(long long)b * Sq + s] : -1;
    sQp[tid] = qpv;
  }
  __syncthreads();
  if (tid == 0) {
    fused::mbar_expect_tx(qbar, W::Q_BYTES);
#pragma unroll
    for (int c = 0; c < W::CH; ++c)
      fused::tma_load_4d(sQ + c * WG_ROWS * 128, &tmQ, qbar, c * 64, h, q0, b);
  }
  {  // the block's query-position range
    const int qmax = __reduce_max_sync(0xffffffffu, qpv);
    const int qmin = __reduce_min_sync(0xffffffffu, qpv >= 0 ? qpv : INT_MAX);
    if (lane == 0 && qmax >= 0) {
      atomicMax(&sRed[0], qmax);
      atomicMin(&sRed[1], qmin);
    }
  }
  __syncthreads();
  {  // the first and last key that some pair of the block can use
    const int qmax = sRed[0], qmin = sRed[1];
    int jlo = INT_MAX, jhi = -1;
    if (qmax >= 0) {
#pragma unroll
      for (int i = 0; i < PRE; ++i) {
        const int j = tid + i * NT;
        if (j < Skv && key_candidate(kp_pre[i], qmin, qmax, causal, window)) {
          jlo = min(jlo, j);
          jhi = j;
        }
      }
      for (int j = tid + PRE * NT; j < Skv; j += NT)
        if (key_candidate(kpos[(long long)b * Skv + j], qmin, qmax, causal, window)) {
          jlo = min(jlo, j);
          jhi = j;
        }
    }
    jlo = __reduce_min_sync(0xffffffffu, jlo);
    jhi = __reduce_max_sync(0xffffffffu, jhi);
    if (lane == 0 && jhi >= 0) {
      atomicMin(&sRed[2], jlo);
      atomicMax(&sRed[3], jhi);
    }
  }
  __syncthreads();
  // key tiles [t_begin, t_end), tile t covering keys [t*WG_KEYS, +WG_KEYS)
  const int t_begin = sRed[3] >= 0 ? sRed[2] / WG_KEYS : 0;
  const int nt = sRed[3] >= 0 ? sRed[3] / WG_KEYS + 1 - t_begin : 0;
  const int wg = tid / 128;

  if (wg == 0) {  // producer: one warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid < 32) {  // lane 0 issues the tile's TMA loads, every lane loads 4 of its key positions
      for (int n = 0; n < nt; ++n) {
        const int stage = n % W::STAGES, t = t_begin + n;
        fused::mbar_wait(&empty[stage], ((n / W::STAGES) & 1) ^ 1);  // the first pass finds it free
        unsigned char* st = ring + stage * W::STAGE;
        if (lane == 0) {
          fused::mbar_expect_tx(&full[stage], W::TX);  // out-of-range boxes count in full
#pragma unroll
          for (int c = 0; c < W::CH; ++c) {
            fused::tma_load_4d(st + c * WG_KEYS * 128, &tmK, &full[stage], c * 64, hk,
                               t * WG_KEYS, b);
            fused::tma_load_4d(st + W::KV_BYTES + c * WG_KEYS * 128, &tmV, &full[stage], c * 64,
                               hk, t * WG_KEYS, b);
          }
        }
        int* sp = reinterpret_cast<int*>(st + W::POS_OFF);
#pragma unroll
        for (int c = lane; c < WG_KEYS; c += 32) {
          const int j = t * WG_KEYS + c;
          sp[c] = j < Skv ? kpos[(long long)b * Skv + j] : -1;
        }
        fused::mbar_arrive(&full[stage]);  // release: the positions are visible to the waiters
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the key tiles t with t % 2 == cw
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int ct = tid - 128 * wg, warp = ct / 32;
  // this lane's two rows of the block's 64: warp*16 + lane/4 (+ 8)
  const int row0 = warp * 16 + (lane >> 2);
  int qp[2];
  int wmin = INT_MAX, wmax = -1, wpad = 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = sQp[row0 + hf * 8];
    qp[hf] = p;
    wmax = max(wmax, p);
    if (p >= 0)
      wmin = min(wmin, p);
    else
      wpad = 1;
  }
  const int wqmax = __reduce_max_sync(0xffffffffu, wmax);
  const int wqmin = __reduce_min_sync(0xffffffffu, wmin);
  const bool wall = !__any_sync(0xffffffffu, wpad);  // every row of the warp is a query
  const float sl = scale * LOG2E;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  fused::mbar_wait(qbar, 0);

  for (int n = (t_begin & 1) == cw ? 0 : 1; n < nt; n += WG_SPLIT) {
    const int stage = n % W::STAGES, t = t_begin + n;
    fused::mbar_wait(&full[stage], (n / W::STAGES) & 1);
    const unsigned char* st = ring + stage * W::STAGE;
    const int* kp = reinterpret_cast<const int*>(st + W::POS_OFF);
    const int nvalid = Skv - t * WG_KEYS;  // keys of the tile below Skv
    bool cand = false, fullv = wall;  // fullv: every pair of the warp's rows is valid
    if (wqmax >= 0) {
#pragma unroll
      for (int c = lane; c < WG_KEYS; c += 32) {
        const int kpv = kp[c];
        const bool in = c < nvalid;
        cand |= in && key_candidate(kpv, wqmin, wqmax, causal, window);
        fullv &= in && kpv >= 0 && (!causal || kpv <= wqmin) &&
                 (window <= 0 || wqmax - kpv < window);
      }
    }
    fullv = __all_sync(0xffffffffu, fullv);
    if (wg_any(__any_sync(0xffffffffu, cand), 2 + cw)) {
      float s[NS][4];
      fused::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        // Q and K: rows of 128 bytes (one column chunk), 8-row swizzle atoms
        // 1024 bytes apart; a k16 step is 32 bytes along the row
        const uint64_t da = fused::wg_desc(sQ + (kk / 4) * WG_ROWS * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = fused::wg_desc(st + (kk / 4) * WG_KEYS * 128 + (kk % 4) * 32, 16, 1024);
        fused::wgmma_ss<WG_KEYS, 0>(s, da, db, kk > 0);
      }
      fused::wgmma_commit();
      fused::wgmma_wait<0>();
      fused::fence_acc(s);
      online_softmax<NS, NO>(s, qp, kp, nvalid, fullv, sl, causal, window, m, l, o);
      // O += P V: p rounded to bf16 (V's type) is the A operand in place
      unsigned a[KP][4];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      fused::fence_frag(a);
      fused::fence_acc(o);
      fused::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        // V: 16 key rows of 128 bytes per k16 step; the column chunks
        // WG_KEYS * 128 bytes apart (leading), 8-row atoms 1024 (stride)
        const uint64_t db = fused::wg_desc(st + W::KV_BYTES + kk * 2048, WG_KEYS * 128, 1024);
        fused::wgmma_rs<HD, 1>(o, a[kk], db, 1);
      }
      fused::wgmma_commit();
      fused::wgmma_wait<0>();
      fused::fence_acc(o);
      fused::fence_frag(a);
    }
    fused::mbar_arrive(&empty[stage]);  // this thread is done with the stage
  }

  // merge the two warpgroups' (m, l, O) through the first stage, free now
  // that both are done with the ring
  named_sync(1, 128 * WG_SPLIT);
  float* xo = reinterpret_cast<float*>(ring);   // [half][j][e][thread]
  float* xml = xo + 2 * (NO / 2) * 4 * 128;      // [warpgroup][m0, m1, l0, l1][thread]
  if (cw == 0)
    wg_send<NO, 1>(o, xo, ct);
  else
    wg_send<NO, 0>(o, xo, ct);
  xml[(cw * 4 + 0) * 128 + ct] = m[0];
  xml[(cw * 4 + 1) * 128 + ct] = m[1];
  xml[(cw * 4 + 2) * 128 + ct] = l[0];
  xml[(cw * 4 + 3) * 128 + ct] = l[1];
  named_sync(1, 128 * WG_SPLIT);
  float w0[2], w1[2], lf[2], M[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float m0 = xml[(0 * 4 + hf) * 128 + ct], m1 = xml[(1 * 4 + hf) * 128 + ct];
    const float l0 = xml[(0 * 4 + 2 + hf) * 128 + ct], l1 = xml[(1 * 4 + 2 + hf) * 128 + ct];
    M[hf] = fmaxf(m0, m1);
    w0[hf] = m0 > NEG_INF / 2 ? exp2f(m0 - M[hf]) : 0.f;
    w1[hf] = m1 > NEG_INF / 2 ? exp2f(m1 - M[hf]) : 0.f;
    lf[hf] = fmaxf(__fadd_rn(__fmul_rn(w0[hf], l0), __fmul_rn(w1[hf], l1)), 1e-30f);
  }
  bf16* orow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + row0 + hf * 8;
    orow[hf] = s < Sq ? out + (((long long)b * Sq + s) * nq + h) * HD : nullptr;
    if (cw == 0 && s < Sq && lse != nullptr && (lane & 3) == 0)  // no valid key: M <= NEG_INF
      lse[((long long)b * nq + h) * Sq + s] =
          (M[hf] > NEG_INF / 2 ? M[hf] * LN2 : 0.f) + logf(lf[hf]);
  }
  const int col = (lane & 3) * 2;
  if (cw == 0)
    wg_finish<HD, 0>(o, xo, ct, w0, w1, lf, orow[0], orow[1], col);
  else
    wg_finish<HD, 1>(o, xo, ct, w0, w1, lf, orow[0], orow[1], col);
}

// ---------------------------------------------------------------------------
// Path 3: decode, one block of DECODE_WARPS warps per (chunk, kv head,
// batch row), warp w on the keys [chunk*C + w*C/4, + C/4) of the chunk
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t decode_smem_bytes() {
  constexpr int LD = HD + 8, QW = decode_warp_keys(HD);
  return (size_t)(DECODE_ROWS * LD + DECODE_WARPS * 2 * QW * LD) * sizeof(bf16) +
         (size_t)(DECODE_WARPS * QW + DECODE_ROWS) * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(DECODE_WARPS * 32)
flash_fwd_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ qpos,
                        const int* __restrict__ kpos, bf16* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc, int Sq, int Skv,
                        int nq, int nkv, int n_splits, int direct, float scale, int causal,
                        int window) {
  constexpr int LD = HD + 8;  // shared row stride (elements): +16 bytes against bank conflicts
  constexpr int QW = decode_warp_keys(HD);  // keys of one warp
  constexpr int NT = DECODE_WARPS * 32;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NS = QW / 8;   // n8 tiles of S
  constexpr int NO = HD / 8;   // n8 tiles of O
  constexpr int KS = HD / 16;  // k16 steps of Q K^T
  static_assert((DECODE_WARPS * (NO * 4 + 4) * 32) * sizeof(float) <=
                    2 * DECODE_WARPS * QW * LD * sizeof(bf16),
                "the merge's exchange fits the K/V tiles");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(dec_smem);      // DECODE_ROWS x LD
  bf16* sK = sQ + DECODE_ROWS * LD;                   // warps x QW x LD
  bf16* sV = sK + DECODE_WARPS * QW * LD;             // warps x QW x LD
  int* sKp = reinterpret_cast<int*>(sV + DECODE_WARPS * QW * LD);  // warps x QW
  int* sQp = sKp + DECODE_WARPS * QW;                 // DECODE_ROWS
  float* xo = reinterpret_cast<float*>(sK);  // after the products: [warp][j][e][lane]
  float* xml = xo + DECODE_WARPS * NO * 4 * 32;       // [warp][m0, m1, l0, l1][lane]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv, R = Sq * g;
  const int key0 = chunk * decode_chunk(HD) + warp * QW;  // this warp's first key
  const float sl = scale * LOG2E;
  // row r -> (query index s, query head h); false for a padding row
  auto row_of = [&](int r, int& s, int& h) -> bool {
    s = r / g;
    h = hk * g + r % g;
    return r < R;
  };

  for (int c = tid; c < DECODE_ROWS * CPR; c += NT) {
    const int r = c / CPR, d = (c % CPR) * 8;
    int s, h;
    const bool ok = row_of(r, s, h);
    cp_async16(sQ + r * LD + d, ok ? q + (((long long)b * Sq + s) * nq + h) * HD + d : q, ok);
  }
  if (tid < DECODE_ROWS) {
    int s, h;
    sQp[tid] = row_of(tid, s, h) ? qpos[(long long)b * Sq + s] : -1;
  }
  const int kpv = lane < QW && key0 + lane < Skv ? kpos[(long long)b * Skv + key0 + lane] : -1;
  if (lane < QW) sKp[warp * QW + lane] = kpv;
  __syncthreads();
  int qmax = -1, qmin = INT_MAX;
#pragma unroll
  for (int r = 0; r < DECODE_ROWS; ++r) {
    const int p = sQp[r];
    if (p >= 0) {
      qmax = max(qmax, p);
      qmin = min(qmin, p);
    }
  }
  // whether some pair of the block can use one of this warp's keys
  const bool cand = __any_sync(0xffffffffu, qmax >= 0 && key_candidate(kpv, qmin, qmax, causal,
                                                                       window));
  bf16* tk = sK + warp * QW * LD;
  bf16* tv = sV + warp * QW * LD;
  if (cand) {
    for (int c = lane; c < QW * CPR; c += 32) {
      const int r = c / CPR, d = (c % CPR) * 8, j = key0 + r;
      const bool ok = j < Skv;
      const long long off = ok ? (((long long)b * Skv + j) * nkv + hk) * HD + d : 0;
      cp_async16(tk + r * LD + d, k + off, ok);
      cp_async16(tv + r * LD + d, v + off, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q, copied by every warp, has landed

  // this lane's two rows of the 16: lane/4 (+ 8)
  const int row0 = lane >> 2;
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (cand) {
    const int qp[2] = {sQp[row0], sQp[row0 + 8]};
    const int* kp = sKp + warp * QW;
    const int nvalid = Skv - key0;
    // full: every row is a query and every pair of the warp's keys is valid
    bool fullv = qp[0] >= 0 && qp[1] >= 0;
    fullv = __all_sync(0xffffffffu, fullv);
    if (lane < QW)
      fullv &= lane < nvalid && kpv >= 0 && (!causal || kpv <= qmin) &&
               (window <= 0 || qmax - kpv < window);
    fullv = __all_sync(0xffffffffu, fullv);
    float sc[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, sQ + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {  // 16 keys: two n8 tiles
        unsigned bk[4];
        ldmatrix_x4(bk, tk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(sc[2 * np], a, bk);
        mma_bf16_16816(sc[2 * np + 1], a, bk + 2);
      }
    }
    online_softmax<NS, NO>(sc, qp, kp, nvalid, fullv, sl, causal, window, m, l, o);
#pragma unroll
    for (int j = 0; j < QW / 16; ++j) {
      const unsigned a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tv + (j * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * np], a, bv);
        mma_bf16_16816(o[2 * np + 1], a, bv + 2);
      }
    }
  }
  __syncthreads();  // every warp is done with the tiles: the exchange reuses them
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) xo[((warp * NO + nt) * 4 + e) * 32 + lane] = o[nt][e];
  xml[(warp * 4 + 0) * 32 + lane] = m[0];
  xml[(warp * 4 + 1) * 32 + lane] = m[1];
  xml[(warp * 4 + 2) * 32 + lane] = l[0];
  xml[(warp * 4 + 3) * 32 + lane] = l[1];
  __syncthreads();

  // the chunk's state: the warps' states merged in warp order,
  // M = max m_w, L = sum w_w l_w, acc = sum w_w acc_w, w_w = 2^(m_w - M)
  // (0 for a warp with no valid key); warp w finishes n8 tiles w, w + 4,
  // ... of both rows (3, 3, 2 and 2 of the 10 at head dim 80)
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + hf * 8;
    int s, h;
    if (!row_of(r, s, h)) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) M = fmaxf(M, xml[(w * 4 + hf) * 32 + lane]);
    float wt[DECODE_WARPS], L = 0.f;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float mw = xml[(w * 4 + hf) * 32 + lane];
      wt[w] = mw > NEG_INF / 2 ? exp2f(mw - M) : 0.f;
      L = __fadd_rn(L, __fmul_rn(wt[w], xml[(w * 4 + 2 + hf) * 32 + lane]));
    }
    const float lf = fmaxf(L, 1e-30f);
    const long long idx = (((long long)b * nkv + hk) * n_splits + chunk) * R + r;
#pragma unroll
    for (int nt = warp; nt < NO; nt += DECODE_WARPS) {
      float x[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < DECODE_WARPS; ++w)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          x[c] = __fadd_rn(x[c],
                           __fmul_rn(wt[w], xo[((w * NO + nt) * 4 + 2 * hf + c) * 32 + lane]));
      if (direct)  // the row's keys fit this chunk: its output
        *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * Sq + s) * nq + h) * HD +
                                           nt * 8 + col) =
            __floats2bfloat162_rn(x[0] / lf, x[1] / lf);
      else  // the chunk's partial state, unnormalised (m in log2 units)
        *reinterpret_cast<float2*>(part_acc + idx * HD + nt * 8 + col) = make_float2(x[0], x[1]);
    }
    if (warp == 0 && (lane & 3) == 0) {
      if (!direct) {
        part_m[idx] = M;
        part_l[idx] = L;
      } else if (lse != nullptr) {  // no valid key: M is -inf or NEG_INF
        lse[((long long)b * nq + h) * Sq + s] = (M > NEG_INF / 2 ? M * LN2 : 0.f) + logf(lf);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Path 2: mma.sync tiles (head dims 32, 80 and 256), one block of TILE_WARPS
// warps per (64 query rows, head, batch row)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(TILE_WARPS * 32, q_in_registers(HD) ? 3 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, bf16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Skv, int nq, int nkv, float scale, int causal, int window) {
  constexpr int NW = TILE_WARPS;
  constexpr int BN = key_tile(HD);
  constexpr int LD = HD + 8;  // shared row stride (elements): +16 bytes against bank conflicts
  constexpr int QR = 16 * NW;  // query rows of the block, 16 per warp
  constexpr int NT = NW * 32;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NS = BN / 8;   // n8 tiles of S
  constexpr int NO = HD / 8;   // n8 tiles of O
  constexpr int KS = HD / 16;  // k16 steps of Q K^T
  constexpr bool QREG = q_in_registers(HD);  // else Q fragments are re-read from shared
  static_assert(!QREG || QR <= BN, "Q must fit one K stage");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem) + (QREG ? 0 : QR * LD);  // 2 stages x BN x LD
  bf16* sQ = QREG ? sK + BN * LD : reinterpret_cast<bf16*>(tc_smem);  // QR x LD
  bf16* sV = sK + 2 * BN * LD;                                        // 2 stages x BN x LD
  int* sKp = reinterpret_cast<int*>(sV + 2 * BN * LD);   // 2 stages x BN
  int* sQp = sKp + 2 * BN;                               // QR
  int* sRed = sQp + QR;                                  // qmax, qmin, first key, last key

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int hk = (int)((long long)blockIdx.y * nkv / nq);
  const float sl = scale * LOG2E;

  // block row r -> (query index s, query head h); false for a padding row
  auto row_of = [&](int r, int& s, int& h) -> bool {
    s = blockIdx.x * QR + r;
    h = blockIdx.y;
    return s < Sq;
  };

  for (int c = tid; c < QR * CPR; c += NT) {
    const int r = c / CPR, d = (c % CPR) * 8;
    int s, h;
    const bool ok = row_of(r, s, h);
    cp_async16(sQ + r * LD + d, ok ? q + (((long long)b * Sq + s) * nq + h) * HD + d : q, ok);
  }
  cp_async_commit();
  for (int r = tid; r < QR; r += NT) {
    int s, h;
    sQp[r] = row_of(r, s, h) ? qpos[(long long)b * Sq + s] : -1;
  }
  if (tid == 0) {
    sRed[0] = -1;
    sRed[1] = INT_MAX;
    sRed[2] = INT_MAX;
    sRed[3] = -1;
  }
  __syncthreads();
  {  // the block's query-position range
    int qmax = -1, qmin = INT_MAX;
    for (int r = tid; r < QR; r += NT) {
      const int p = sQp[r];
      if (p >= 0) {
        qmax = max(qmax, p);
        qmin = min(qmin, p);
      }
    }
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    if (lane == 0 && qmax >= 0) {
      atomicMax(&sRed[0], qmax);
      atomicMin(&sRed[1], qmin);
    }
  }
  __syncthreads();
  {  // the first and last key of the block's range that some pair can use
    const int qmax = sRed[0], qmin = sRed[1];
    int jlo = INT_MAX, jhi = -1;
    if (qmax >= 0) {
      for (int j = tid; j < Skv; j += NT) {
        if (key_candidate(kpos[(long long)b * Skv + j], qmin, qmax, causal, window)) {
          jlo = min(jlo, j);
          jhi = j;
        }
      }
    }
    jlo = __reduce_min_sync(0xffffffffu, jlo);
    jhi = __reduce_max_sync(0xffffffffu, jhi);
    if (lane == 0 && jhi >= 0) {
      atomicMin(&sRed[2], jlo);
      atomicMax(&sRed[3], jhi);
    }
  }
  __syncthreads();
  // key tiles [t_begin, t_end), tile t covering keys [t*BN, t*BN + BN)
  const int t_begin = sRed[3] >= 0 ? sRed[2] / BN : 0;
  const int t_end = sRed[3] >= 0 ? sRed[3] / BN + 1 : 0;

  auto load_tile = [&](int stage, int t) {
    const int j0 = t * BN;
    bf16* dk = sK + stage * BN * LD;
    bf16* dv = sV + stage * BN * LD;
    for (int c = tid; c < BN * CPR; c += NT) {
      const int r = c / CPR, d = (c % CPR) * 8, j = j0 + r;
      const bool ok = j < Skv;
      const long long off = ok ? (((long long)b * Skv + j) * nkv + hk) * HD + d : 0;
      cp_async16(dk + r * LD + d, k + off, ok);
      cp_async16(dv + r * LD + d, v + off, ok);
    }
    for (int r = tid; r < BN; r += NT) {
      const int j = j0 + r;
      cp_async4(sKp + stage * BN + r, kpos + (j < Skv ? (long long)b * Skv + j : 0), j < Skv);
    }
  };

  if (t_begin < t_end) load_tile(0, t_begin);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this lane's two rows of the warp's 16: warp*16 + lane/4 (+ 8)
  const int row0 = warp * 16 + (lane >> 2);
  int qp[2];
  int wmin = INT_MAX, wmax = -1, wpad = 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = sQp[row0 + hf * 8];
    qp[hf] = p;
    wmax = max(wmax, p);
    if (p >= 0)
      wmin = min(wmin, p);
    else
      wpad = 1;
  }
  const int wqmax = __reduce_max_sync(0xffffffffu, wmax);
  const int wqmin = __reduce_min_sync(0xffffffffu, wmin);
  const bool wall = !__any_sync(0xffffffffu, wpad);  // every row of the warp is a query
  unsigned qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    __syncthreads();  // every warp holds Q before stage 1 is filled
  }

  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_tile(stage ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const int* kp = sKp + stage * BN;
    const int nvalid = Skv - t * BN;  // keys of the tile below Skv
    bool cand = false, full = wall;  // full: every pair of the warp's rows is valid
    if (wqmax >= 0) {
#pragma unroll
      for (int c = lane; c < BN; c += 32) {
        const int kpv = kp[c];
        const bool in = c < nvalid;
        cand |= in && key_candidate(kpv, wqmin, wqmax, causal, window);
        full &= in && kpv >= 0 && (!causal || kpv <= wqmin) &&
                (window <= 0 || wqmax - kpv < window);
      }
    }
    full = __all_sync(0xffffffffu, full);
    if (__any_sync(0xffffffffu, cand)) {
      const bf16* tk = sK + stage * BN * LD;
      const bf16* tv = sV + stage * BN * LD;
      float sc[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {  // 16 keys: two n8 tiles
          unsigned bk[4];
          ldmatrix_x4(bk, tk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[2 * np], a, bk);
          mma_bf16_16816(sc[2 * np + 1], a, bk + 2);
        }
      }
      online_softmax<NS, NO>(sc, qp, kp, nvalid, full, sl, causal, window, m, l, o);
      // O += P V: p rounded to bf16 (V's type) is the A operand in place
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const unsigned a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                               pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                               pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                               pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, tv + (j * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * np], a, bv);
          mma_bf16_16816(o[2 * np + 1], a, bv + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const int col = (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + hf * 8;
    int s, h;
    if (!row_of(r, s, h)) continue;
    const float lf = fmaxf(l[hf], 1e-30f);
    bf16* orow = out + (((long long)b * Sq + s) * nq + h) * HD;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + col) =
          __floats2bfloat162_rn(o[nt][2 * hf] / lf, o[nt][2 * hf + 1] / lf);
    if (lse != nullptr && (lane & 3) == 0)  // no valid key: m is -inf or NEG_INF
      lse[((long long)b * nq + h) * Sq + s] = (m[hf] > NEG_INF / 2 ? m[hf] * LN2 : 0.f) + logf(lf);
  }
}

// Decode path, second kernel: one block per (row, kv head, batch row), one
// thread per output column, merging the chunks' partials in chunk order:
// M = max m_i; out = sum w_i acc_i / max(sum w_i l_i, 1e-30) with
// w_i = exp(m_i - M), 0 for a chunk with no valid key.
template <int HD>
__global__ void __launch_bounds__(HD)
flash_fwd_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                       const float* __restrict__ part_acc, bf16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int nq, int nkv, int n_splits) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int g = nq / nkv, R = Sq * g, s = r / g, h = hk * g + r % g;
  const long long base = ((long long)b * nkv + hk) * n_splits * R + r;
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, part_m[base + (long long)i * R]);
  float L = 0.f, acc = 0.f;
  if (M > NEG_INF / 2) {
    for (int i = 0; i < n_splits; ++i) {
      const long long idx = base + (long long)i * R;
      const float mi = part_m[idx];
      const float w = mi > NEG_INF / 2 ? exp2f(mi - M) : 0.f;
      L += w * part_l[idx];
      acc += w * part_acc[idx * HD + d];
    }
  }
  const float lf = fmaxf(L, 1e-30f);
  out[(((long long)b * Sq + s) * nq + h) * HD + d] = __float2bfloat16_rn(acc / lf);
  if (lse != nullptr && d == 0)
    lse[((long long)b * nq + h) * Sq + s] = (M > NEG_INF / 2 ? M * LN2 : 0.f) + logf(lf);
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* qpos,
                      const int* kpos, void* out, float* lse, int B, int Sq, int Skv, int nq,
                      int nkv, float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = smem_limit_once(attr_set, flash_fwd_tc_kernel<HD>, smem);
  if (attr != cudaSuccess) return attr;
  constexpr int QR = 16 * TILE_WARPS;
  flash_fwd_tc_kernel<HD><<<dim3((Sq + QR - 1) / QR, nq, B), TILE_WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qpos,
      kpos, static_cast<bf16*>(out), lse, Sq, Skv, nq, nkv, scale, causal, window);
  return cudaGetLastError();
}

// (B, S, nh, HD) bf16 as a rank-4 tensor map (innermost first), loaded in
// boxes of `rows` sequence positions x 64 columns of one head, 128-byte
// swizzled; zeros past S
template <int HD>
cudaError_t encode_heads(CUtensorMap* map, const void* base, int B, int S, int nh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)nh, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)nh * HD * 2,
                                 (cuuint64_t)S * nh * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return fused::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
cudaError_t launch_wg(const void* q, const void* k, const void* v, const int* qpos,
                      const int* kpos, void* out, float* lse, int B, int Sq, int Skv, int nq,
                      int nkv, float scale, int causal, int window, cudaStream_t st) {
  using W = WgFlash<HD>;
  const long long n_qt = (Sq + WG_ROWS - 1) / WG_ROWS, blocks = n_qt * nq * B;
  // TMA reads 16-byte aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (bases % 16 || blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_heads<HD>(&tq, q, B, Sq, nq, WG_ROWS);
  if (err == cudaSuccess) err = encode_heads<HD>(&tk, k, B, Skv, nkv, WG_KEYS);
  if (err == cudaSuccess) err = encode_heads<HD>(&tv, v, B, Skv, nkv, WG_KEYS);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = smem_limit_once(attr_set, flash_fwd_wg_kernel<HD>, W::SMEM);
  if (attr != cudaSuccess) return attr;
  flash_fwd_wg_kernel<HD><<<(unsigned)blocks, WG_THREADS, W::SMEM, st>>>(
      tq, tk, tv, qpos, kpos, static_cast<bf16*>(out), lse, B, Sq, Skv, nq, nkv, (int)n_qt,
      scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* qpos,
                          const int* kpos, void* out, float* lse, float* pm, float* pl, float* pa,
                          int B, int Sq, int Skv, int nq, int nkv, int n_splits, int merge,
                          float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = decode_smem_bytes<HD>();
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = smem_limit_once(attr_set, flash_fwd_decode_kernel<HD>, smem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_decode_kernel<HD><<<dim3(n_splits, nkv, B), DECODE_WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qpos,
      kpos, static_cast<bf16*>(out), lse, pm, pl, pa, Sq, Skv, nq, nkv, n_splits, !merge, scale,
      causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  flash_fwd_merge_kernel<HD><<<dim3(Sq * (nq / nkv), nkv, B), HD, 0, st>>>(
      pm, pl, pa, static_cast<bf16*>(out), lse, Sq, nq, nkv, n_splits);
  return cudaGetLastError();
}

// the bf16 plan of kernels/flash_attention.py::flash_plan, checked against
// this file's own: the path for the rows and the head dim, its key tile
// and split, and on the decode path the chunk, the chunk count that
// covers Skv and the merge (required past one chunk, with its scratch)
template <int HD>
int launch_bf16(int path, int key_tile_, int key_split, int chunk, int n_splits, int merge,
                const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                void* out, float* lse, float* pm, float* pl, float* pa, int B, int Sq, int Skv,
                int nq, int nkv, float scale, int causal, int window, cudaStream_t st) {
  const int rows = Sq * (nq / nkv);
  if (path == PATH_DECODE) {
    if (rows > DECODE_ROWS || key_tile_ != decode_warp_keys(HD) || key_split != DECODE_WARPS ||
        chunk != decode_chunk(HD) || n_splits != (Skv + chunk - 1) / chunk || n_splits < 1 ||
        (merge != 0 && merge != 1) || (!merge && n_splits != 1) ||
        (merge && (pm == nullptr || pl == nullptr || pa == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_decode<HD>(q, k, v, qpos, kpos, out, lse, pm, pl, pa, B, Sq,
                                              Skv, nq, nkv, n_splits, merge, scale, causal,
                                              window, st));
  }
  if (rows <= DECODE_ROWS || chunk != 0 || n_splits != 0 || merge != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (HD == 64 || HD == 128) {
    if (path == PATH_WGMMA && key_tile_ == WG_KEYS && key_split == WG_SPLIT)
      return static_cast<int>(launch_wg<HD>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv,
                                            scale, causal, window, st));
  } else {
    if (path == PATH_MMA && key_tile_ == key_tile(HD) && key_split == 1)
      return static_cast<int>(launch_tc<HD>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv,
                                            scale, causal, window, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#define REPRO_FLASH_HD(HD_, CALL) \
  case HD_:                       \
    return CALL<HD_>

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, void* lse,
                                     void* part_m, void* part_l, void* part_acc, int B, int Sq,
                                     int Skv, int nq, int nkv, int hd, int dtype, int path,
                                     int key_tile_, int key_split, int chunk, int n_splits,
                                     int merge, float scale, int causal, int window,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (path == PATH_F32 && dtype == REPRO_F32) {
    if (key_tile_ != 0 || key_split != 1 || chunk != 0 || n_splits != 0 || merge != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      REPRO_FLASH_HD(32, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                     causal, window, st);
      REPRO_FLASH_HD(64, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                     causal, window, st);
      REPRO_FLASH_HD(80, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                     causal, window, st);
      REPRO_FLASH_HD(128, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
      REPRO_FLASH_HD(256, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
    }
  } else if (path != PATH_F32 && dtype == REPRO_BF16) {
    switch (hd) {
      REPRO_FLASH_HD(32, launch_bf16)(path, key_tile_, key_split, chunk, n_splits, merge, q, k, v,
                                      qp, kp, out, ls, pm, pl, pa, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
      REPRO_FLASH_HD(64, launch_bf16)(path, key_tile_, key_split, chunk, n_splits, merge, q, k, v,
                                      qp, kp, out, ls, pm, pl, pa, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
      REPRO_FLASH_HD(80, launch_bf16)(path, key_tile_, key_split, chunk, n_splits, merge, q, k, v,
                                      qp, kp, out, ls, pm, pl, pa, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
      REPRO_FLASH_HD(128, launch_bf16)(path, key_tile_, key_split, chunk, n_splits, merge, q, k,
                                       v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv, nq, nkv, scale,
                                       causal, window, st);
      REPRO_FLASH_HD(256, launch_bf16)(path, key_tile_, key_split, chunk, n_splits, merge, q, k,
                                       v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv, nq, nkv, scale,
                                       causal, window, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
