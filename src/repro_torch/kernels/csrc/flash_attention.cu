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
// Three paths; kernels/flash_attention.py::flash_plan picks one from the
// dtype, Sq and nq/nkv alone (never from Skv or B, so a row's bits do not
// depend on them):
//
// 1. bf16 tile path (prefill, chunked prefill, training, routed
//    sub-sequences): one block of 4 warps per (64 query rows, head, batch
//    row), 16 rows per warp. K/V tiles of 64 keys (32 at head_dim 256)
//    stay bf16 in shared memory, double-buffered through cp.async (rows
//    padded by 16 bytes so ldmatrix hits distinct banks). S = Q K^T on
//    tensor cores (mma.sync m16n8k16, bf16 in, f32 sums) with Q's
//    fragments in registers (head_dim <= 128: Q is staged in the second K
//    stage, so 3 blocks fit an SM); the mask and the online softmax work
//    on the accumulator fragments (quad shuffles for the row max and sum;
//    scores carry log2(e), so p = 2^(s - m); a tile in which every pair of
//    a warp's rows is valid skips the mask); p goes to bf16 in registers
//    and is the A operand of P V, with V through ldmatrix.trans.
// 2. bf16 decode path (Sq * nq/nkv <= 16): the 16 rows of one mma tile are
//    the (query position, query head of the group) pairs of one kv head,
//    so K/V are read once per kv head. Keys are split into chunks of
//    decode_chunk(hd) key indices (two key tiles, fixed); one
//    one-warp block per (chunk, kv head, batch row) reduces its chunk to a
//    partial (m, l, acc) in f32 scratch the wrapper allocates, and a
//    second small kernel merges the partials in chunk order. A chunk with
//    no valid key adds exact zeros (l = 0, acc = 0, weight 0).
// 3. f32: the CUDA-core kernel below (no TF32: f32 results stay within 2e-5
//    of the plain version, which the CPU-vs-card parity phases rely on).
//
// Tiles are skipped by position, never by index (ring caches wrap, routed
// sub-sequences have gaps): a block walks only the key tiles between the
// first and the last key that some (query, key) pair of the block can
// use, and a warp skips the compute of a tile in which none of its rows
// has a valid key. Skipping a tile with no valid pair is exact: it would
// rescale by 2^0 = 1 and add zeros.
//
// Bound on the H100: bytes for decode (each kv head's valid keys are read
// once), operations for long prefill (4*Sq*Skv*hd per head, half of it
// masked by causality). mma.sync is not the card's full tensor-core rate
// (wgmma with TMA-staged tiles is later work), and neither kernel
// allocates or synchronises with the host, so both are capturable in a
// CUDA graph.
#include <limits.h>
#include <math.h>

#include "common.cuh"

REPRO_ERROR_STRING

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's masked score

// path codes passed by kernels/flash_attention.py
constexpr int PATH_F32 = 0, PATH_TILE = 1, PATH_DECODE = 2;

// ===========================================================================
// f32: CUDA cores. One block of 4 warps per (q-tile of 16 rows, head, batch
// row); the 16 query rows sit in shared memory in f32, and a loop walks K/V
// in tiles of 32 keys staged in shared memory (K rows padded by one float so
// 32 lanes reading 32 keys hit 32 banks). Each warp owns 4 query rows; for a
// row, lane j scores key j of the tile, the warp reduces the tile's max and
// sum, and every lane accumulates head_dim/32 output columns. A tile in
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
  constexpr int DPL = HD / 32;  // output columns per lane
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
          for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(pj, vr[32 * i], acc[rr][i]);
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
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[rr][i] / lf;
    if (lse != nullptr && lane == 0)  // a row with no valid key: m is -inf or NEG_INF
      lse[((long long)b * nq + h) * Sq + s] = (m[rr] > NEG_INF / 2 ? m[rr] : 0.f) + logf(lf);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
               void* out, float* lse, int B, int Sq, int Skv, int nq, int nkv, float scale,
               int causal, int window, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * HD + BKV * (HD + 1) + BKV * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((Sq + BQ - 1) / BQ, nq, B);
  flash_fwd_kernel<HD><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, static_cast<float*>(out), lse, Sq, Skv, nq, nkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int TILE_WARPS = 4;    // tile path: 4 warps per block
constexpr int DECODE_ROWS = 16;  // decode path: one mma tile of (position, head) rows
constexpr float LOG2E = 1.4426950408889634f;  // scores carry log2(e): p = 2^(s - m)
constexpr float LN2 = 0.6931471805599453f;

// keys per K/V tile, and per decode chunk (a fixed multiple of the tile)
__host__ __device__ constexpr int key_tile(int hd) { return hd == 256 ? 32 : 64; }
__host__ __device__ constexpr int decode_chunk(int hd) { return 2 * key_tile(hd); }
// Q fragments live in registers at head dims <= 128; Q is then staged in
// the second K stage (read into registers before that stage is first
// filled), which leaves room for 3 tile-path blocks per SM
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
  unsigned valid = 0;
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
        valid |= (unsigned)ok << (nt * 4 + e);
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
          full || ((valid >> (nt * 4 + e)) & 1u) ? exp2f(sc[nt][e] - ms[e >> 1]) : 0.f;
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

// dynamic shared memory of a block: Q (unless it is staged in the second K
// stage), two stages of K/V tiles and their positions, the rows' positions
template <int HD, int NW>
constexpr size_t tc_smem_bytes() {
  constexpr int BN = key_tile(HD), LD = HD + 8, QR = 16 * NW;
  constexpr int q_elems = q_in_registers(HD) ? 0 : QR * LD;
  return (size_t)(q_elems + 4 * BN * LD) * sizeof(bf16) + (size_t)(2 * BN + QR + 4) * sizeof(int);
}

// NW = 4, DECODE = false: the tile path; NW = 1, DECODE = true: one chunk
// of the decode path (partials to part_*).
template <int HD, int NW, bool DECODE>
__global__ void __launch_bounds__(NW * 32, NW == 4 && q_in_registers(HD) ? 3 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, bf16* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int Sq, int Skv, int nq, int nkv, float scale,
                    int causal, int window) {
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
  const int g = nq / nkv;
  const int hk = DECODE ? blockIdx.y : (int)((long long)blockIdx.y * nkv / nq);
  const int key_lo = DECODE ? blockIdx.x * decode_chunk(HD) : 0;
  const int key_hi = DECODE ? min(Skv, key_lo + decode_chunk(HD)) : Skv;
  const float sl = scale * LOG2E;

  // block row r -> (query index s, query head h); false for a padding row
  auto row_of = [&](int r, int& s, int& h) -> bool {
    if (DECODE) {
      s = r / g;
      h = hk * g + r % g;
      return r < Sq * g;
    }
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
      for (int j = key_lo + tid; j < key_hi; j += NT) {
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
  // key tiles [t_begin, t_end), tile t covering keys [t*BN, t*BN + BN); a
  // chunk is a whole number of tiles, so no tile crosses a chunk boundary
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
    if (DECODE) {  // the chunk's partial state, unnormalised (m in log2 units)
      const long long idx = (((long long)b * nkv + hk) * gridDim.x + blockIdx.x) * (Sq * g) + r;
      float* pa = part_acc + idx * HD;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<float2*>(pa + nt * 8 + col) =
            make_float2(o[nt][2 * hf], o[nt][2 * hf + 1]);
      if ((lane & 3) == 0) {
        part_m[idx] = m[hf];
        part_l[idx] = l[hf];
      }
    } else {
      const float lf = fmaxf(l[hf], 1e-30f);
      bf16* orow = out + (((long long)b * Sq + s) * nq + h) * HD;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + col) =
            __floats2bfloat162_rn(o[nt][2 * hf] / lf, o[nt][2 * hf + 1] / lf);
      if (lse != nullptr && (lane & 3) == 0)  // no valid key: m is -inf or NEG_INF
        lse[((long long)b * nq + h) * Sq + s] =
            (m[hf] > NEG_INF / 2 ? m[hf] * LN2 : 0.f) + logf(lf);
    }
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

template <int HD, int NW, bool DECODE>
cudaError_t launch_tc(dim3 grid, const void* q, const void* k, const void* v, const int* qpos,
                      const int* kpos, void* out, float* lse, float* pm, float* pl, float* pa,
                      int Sq, int Skv, int nq, int nkv, float scale, int causal, int window,
                      cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<HD, NW>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD, NW, DECODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<HD, NW, DECODE><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qpos,
      kpos, static_cast<bf16*>(out), lse, pm, pl, pa, Sq, Skv, nq, nkv, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(int path, const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* out, float* lse, float* pm, float* pl, float* pa, int B,
                int Sq, int Skv, int nq, int nkv, int chunk, int n_splits, float scale,
                int causal, int window, cudaStream_t st) {
  if (path == PATH_TILE) {
    constexpr int QR = 16 * TILE_WARPS;
    return static_cast<int>(launch_tc<HD, TILE_WARPS, false>(
        dim3((Sq + QR - 1) / QR, nq, B), q, k, v, qpos, kpos, out, lse, nullptr, nullptr,
        nullptr, Sq, Skv, nq, nkv, scale, causal, window, st));
  }
  // the wrapper's plan must be this file's: one mma tile of rows, the
  // fixed chunk, and the chunk count that covers Skv
  const int rows = Sq * (nq / nkv);
  if (rows > DECODE_ROWS || chunk != decode_chunk(HD) ||
      n_splits != (Skv + chunk - 1) / chunk || pm == nullptr || pl == nullptr || pa == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_tc<HD, 1, true>(dim3(n_splits, nkv, B), q, k, v, qpos, kpos, out,
                                              lse, pm, pl, pa, Sq, Skv, nq, nkv, scale, causal,
                                              window, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_merge_kernel<HD><<<dim3(rows, nkv, B), HD, 0, st>>>(
      pm, pl, pa, static_cast<bf16*>(out), lse, Sq, nq, nkv, n_splits);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_FLASH_HD(HD_, CALL) \
  case HD_:                       \
    return CALL<HD_>

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, void* lse,
                                     void* part_m, void* part_l, void* part_acc, int B, int Sq,
                                     int Skv, int nq, int nkv, int hd, int dtype, int path,
                                     int chunk, int n_splits, float scale, int causal,
                                     int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (path == PATH_F32 && dtype == REPRO_F32) {
    switch (hd) {
      REPRO_FLASH_HD(32, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                     causal, window, st);
      REPRO_FLASH_HD(64, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                     causal, window, st);
      REPRO_FLASH_HD(128, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
      REPRO_FLASH_HD(256, launch_f32)(q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
    }
  } else if ((path == PATH_TILE || path == PATH_DECODE) && dtype == REPRO_BF16) {
    switch (hd) {
      REPRO_FLASH_HD(32, launch_bf16)(path, q, k, v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv,
                                      nq, nkv, chunk, n_splits, scale, causal, window, st);
      REPRO_FLASH_HD(64, launch_bf16)(path, q, k, v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv,
                                      nq, nkv, chunk, n_splits, scale, causal, window, st);
      REPRO_FLASH_HD(128, launch_bf16)(path, q, k, v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv,
                                       nq, nkv, chunk, n_splits, scale, causal, window, st);
      REPRO_FLASH_HD(256, launch_bf16)(path, q, k, v, qp, kp, out, ls, pm, pl, pa, B, Sq, Skv,
                                       nq, nkv, chunk, n_splits, scale, causal, window, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
