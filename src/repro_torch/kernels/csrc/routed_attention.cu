// Fused routed attention of the pallas_fused MoD backend, forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// routed_attention (_routed_attention_call / _routed_attn_kernel). Same
// function: the routed rows x[b, idx[b, i]] are gathered out of the full
// (B, S, D) residual stream, RMS-normed (ln1), projected to q/k/v (+bias),
// rotated by their original positions (keys at max(pos, 0)), attended with
// a dense softmax over the k routed rows under the model's make_mask
// (keys need pos >= 0, kv_pos <= q_pos when causal, a sliding window), and
// projected by wo. Returns a_sub and h_sub = x_sub + a_sub, both (B, k, D).
// Every working-type rounding of the JAX mirror (_attn_stage) is kept:
// after each projection and its bias add, after RoPE, for the scores before
// the f32 scale, for p before p@V, after p@V, after @wo, and for h.
//
// Design: one C entry point, five steps on the caller's stream, each a
// kernel writing scratch the wrapper allocated (the TPU kernel keeps these
// in VMEM; here they are small, (B*k, D) rows, and stay in L2):
//   1. gather + RMSNorm, one block per routed row (gemm.cuh);
//   2. the q, k and v projections on the GEMM path the wrapper chose
//      (kernels/flash_attention.py::routed_attention_path): in bf16 with D
//      a multiple of 8 and aligned weights gemm.cuh's Hopper GEMM (TMA +
//      wgmma), k and v in one launch that reads hn once with two B
//      matrices; else the CUDA-core GEMM, one launch each (there two B
//      matrices cost registers and ran slower than two launches on an H100
//      at the 1b shape in f32). The bias add is the epilogue; a path that
//      does not fit fails the call;
//   3. RoPE in place on q and k in one launch, one block per routed row
//      taking the row's angles, cos and sin once for every head, with the
//      plain version's frequency table passed in (no powf drift);
//   4. attention over the k routed rows of each batch row:
//      - bf16 on tensor cores (routed_attn_tc_kernel): one block of 4 warps
//        per (64 query rows, head, batch row), 16 rows per warp, Q
//        fragments in registers (head_dim <= 128) or shared memory; K/V
//        tiles of 64 keys (32 at head_dim 256) stay bf16 in shared memory,
//        double-buffered through cp.async; S = Q K^T by mma.sync m16n8k16
//        (bf16 in, f32 sums) on the accumulator fragments; p, rounded to
//        bf16, is the A operand of P V from registers, V read through
//        ldmatrix.trans. The values are the dense softmax's, not an online
//        one's: three passes over the key tiles recompute Q K^T (4·k²·hd
//        per head, cheap at the MoD capacity) and take (0) the row max m
//        over every key, masked ones (-1e30) included, before any
//        exponential; (1) l = sum expf(s - m); (2) p = bf16(expf(s - m) /
//        l) and o += p V. Keys past k are out of the softmax.
//        Tiles are skipped by position, never by index (routed rows are
//        not contiguous positions), and exactly: a block walks only the key
//        tiles that hold a key some of its rows can use, and a warp skips
//        the products of a tile in which none of its rows can use a key.
//        A tile left out of pass 0 holds masked keys only, so the row max
//        is floored at -1e30, which is what they would have given. In a
//        row with m > -5e29 a masked key's expf(-1e30 - m) is exactly 0,
//        so passes 1 and 2 take 0 for it without the exponential and the
//        division, and skip its tiles once every row of the warp (block)
//        has such an m. A row with no valid key at all (m = -1e30: every
//        p = 1/k, the mean of V, not flash's 0) makes passes 1 and 2 walk
//        every tile.
//      - f32 on CUDA cores (routed_attn_kernel): one block of 4 warps per
//        (16 query rows, head, batch row), K/V staged 32 keys at a time,
//        lane j scoring key j, the same three passes. No TF32: the
//        CPU-vs-card parity runs hold f32 within 1e-4.
//   5. out-projection on the same GEMM path, with the residual add as its
//      epilogue.
// Neither kernel allocates or synchronises with the host, and the GEMM's
// tensor maps are encoded per call, so a call captures into a CUDA graph.
//
// Bound on the H100 at the 1b training shape (B=4, S=2048, k=256, D=1792,
// 14x128 heads): operations. 4 projections of (1024 x 1792) by (1792 x
// 1792) are 26 GFLOP, attention over the causal pairs 1 GFLOP (the three
// passes run 4x that on mma.sync), against under 30 MB of bytes.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "gemm.cuh"

REPRO_ERROR_STRING

namespace {

using fused::rnd;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // masked score, as the mirror's where()

// The projections' epilogues, under names of their own so that a profile
// tells this kernel's GEMMs from the MLP kernels' (swiglu's down product
// also stores through EpiStore): q = T(T(acc) + bq) (and k or v alone);
// k and v from one GEMM with two B matrices, each as q; a = T(acc) and
// h = T(x_sub + a).
template <typename T>
struct EpiAttnStore : fused::EpiStore<T> {};

template <typename T>
struct EpiAttnKV {
  fused::EpiStore<T> k, v;
  __device__ __forceinline__ void operator()(int r, int c, float vk, float vv) const {
    k(r, c, vk, 0.f);
    v(r, c, vv, 0.f);
  }
};

template <typename T>
struct EpiAttnOut : fused::EpiResid<T> {};

// rotate-half RoPE in place, one block per routed row r: q (rows, nq, hd)
// at angle pos[r] * freq[i], k (rows, nkv, hd) at max(pos[r], 0) * freq[i];
// the row's cos and sin are taken once into shared memory for all its heads
//   out1 = x1*cos - x2*sin, out2 = x1*sin + x2*cos
constexpr int ROPE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_kernel(T* __restrict__ q, T* __restrict__ k, const int* __restrict__ pos,
            const float* __restrict__ freqs, int nq, int nkv, int hd) {
  __shared__ float cs[4][128];  // cos and sin of q's angles, then of k's (hd <= 256)
  const long long r = blockIdx.x;
  const int half = hd / 2;
  const int p = pos[r];
  for (int i = threadIdx.x; i < half; i += ROPE_THREADS) {
    const float aq = __fmul_rn((float)p, freqs[i]);
    const float ak = __fmul_rn((float)(p < 0 ? 0 : p), freqs[i]);
    cs[0][i] = cosf(aq);
    cs[1][i] = sinf(aq);
    cs[2][i] = cosf(ak);
    cs[3][i] = sinf(ak);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (nq + nkv) * half; e += ROPE_THREADS) {
    const int hh = e / half, i = e % half, key = hh >= nq;
    T* base = key ? k + (r * nkv + hh - nq) * hd : q + (r * nq + hh) * hd;
    const float c = cs[2 * key][i], s = cs[2 * key + 1][i];
    const float x1 = to_f32(base[i]), x2 = to_f32(base[i + half]);
    base[i] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    base[i + half] = from_f32<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
  }
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int BQ = 16;   // query rows per block
constexpr int BKV = 32;  // keys per tile (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Attention over the k routed rows of one batch row. q: (B*k, nq, HD),
// kk/vv: (B*k, nkv, HD), pos: (B, k), o: (B*k, nq, HD).
template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
routed_attn_kernel(const float* __restrict__ q, const float* __restrict__ kk,
                   const float* __restrict__ vv, const int* __restrict__ pos,
                   float* __restrict__ o, int k, int nq, int nkv, float scale, int causal,
                   int window) {
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
  const long long row0 = (long long)b * k;  // first routed row of this batch row

  for (int e = tid; e < BQ * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sQ[e] = s < k ? q[((row0 + s) * nq + h) * HD + d] : 0.f;
  }
  if (tid < BQ) sQp[tid] = q0 + tid < k ? pos[row0 + q0 + tid] : 0;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // pass 0: row max; pass 1: sum of exp(s - max); pass 2: p @ V
  for (int pass = 0; pass < 3; ++pass) {
    for (int j0 = 0; j0 < k; j0 += BKV) {
      __syncthreads();  // the previous tile's readers are done
      if (tid < BKV) sKp[tid] = j0 + tid < k ? pos[row0 + j0 + tid] : -1;
      for (int e = tid; e < BKV * HD; e += blockDim.x) {
        const int r = e / HD, d = e % HD, j = j0 + r;
        float kv = 0.f, vx = 0.f;
        if (j < k) {
          const long long off = ((row0 + j) * nkv + hk) * HD + d;
          kv = kk[off];
          if (pass == 2) vx = vv[off];
        }
        sK[r * (HD + 1) + d] = kv;
        if (pass == 2) sV[r * HD + d] = vx;
      }
      __syncthreads();

      const int j = j0 + lane;
      const int kp = sKp[lane];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp + rr * NWARPS;
        if (q0 + r >= k) continue;  // warp-uniform: past the last routed row
        const int qp = sQp[r];
        float s = -INFINITY;  // a key past k is not part of the softmax at all
        if (j < k) {
          const float* qr = sQ + r * HD;
          const float* kr = sK + lane * (HD + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          const bool valid =
              kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
          s = valid ? __fmul_rn(dot, scale) : NEG_INF;
        }
        if (pass == 0) {
          m[rr] = fmaxf(m[rr], warp_max(s));
        } else if (pass == 1) {
          l[rr] += warp_sum(expf(s - m[rr]));
        } else {
          const float p = __fdiv_rn(expf(s - m[rr]), l[rr]);
#pragma unroll 8
          for (int jj = 0; jj < BKV; ++jj) {
            const float pj = __shfl_sync(0xffffffffu, p, jj);
            const float* vr = sV + jj * HD + lane;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(pj, vr[32 * i], acc[rr][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = q0 + warp + rr * NWARPS;
    if (s >= k) continue;
    float* orow = o + ((row0 + s) * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[rr][i];
  }
}

template <int HD>
cudaError_t attend_f32(const float* q, const float* kk, const float* vv, const int* pos,
                       float* o, int B, int k, int nq, int nkv, float scale, int causal,
                       int window, cudaStream_t st) {
  const size_t smem = (size_t)(BQ * HD + BKV * (HD + 1) + BKV * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((k + BQ - 1) / BQ, nq, B);
  routed_attn_kernel<HD><<<grid, NWARPS * 32, smem, st>>>(q, kk, vv, pos, o, k, nq, nkv, scale,
                                                          causal, window);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ===========================================================================

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows per block

__host__ __device__ constexpr int tc_key_tile(int hd) { return hd == 256 ? 32 : 64; }
__host__ __device__ constexpr bool tc_q_in_registers(int hd) { return hd <= 128; }

// Q, two stages of K and of V (rows padded by 16 bytes so ldmatrix hits
// distinct banks), and the two stages' key positions
template <int HD>
constexpr size_t tc_smem_bytes() {
  constexpr int BN = tc_key_tile(HD), LD = HD + 8;
  return (size_t)(TC_ROWS * LD + 4 * BN * LD) * sizeof(bf16) + (size_t)(2 * BN) * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32)
routed_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kk,
                      const bf16* __restrict__ vv, const int* __restrict__ pos,
                      bf16* __restrict__ o, int k, int nq, int nkv, float scale, int causal,
                      int window) {
  constexpr int BN = tc_key_tile(HD);
  constexpr int LD = HD + 8;  // shared row stride (elements)
  constexpr int NT = TC_WARPS * 32;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NS = BN / 8;   // n8 tiles of S
  constexpr int NO = HD / 8;   // n8 tiles of O
  constexpr int KS = HD / 16;  // k16 steps of Q K^T
  constexpr bool QREG = tc_q_in_registers(HD);
  extern __shared__ __align__(16) unsigned char ra_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(ra_smem);          // TC_ROWS x LD
  bf16* sK = sQ + TC_ROWS * LD;                         // 2 stages x BN x LD
  bf16* sV = sK + 2 * BN * LD;                          // 2 stages x BN x LD
  int* sKp = reinterpret_cast<int*>(sV + 2 * BN * LD);  // 2 stages x BN
  __shared__ int sRed[4];  // the block's query positions min, max; candidate keys first, last

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = (int)((long long)h * nkv / nq);
  const int q0 = blockIdx.x * TC_ROWS;
  const long long row0 = (long long)b * k;  // first routed row of this batch row
  const int ntiles = (k + BN - 1) / BN;

  for (int c = tid; c < TC_ROWS * CPR; c += NT) {
    const int r = c / CPR, d = (c % CPR) * 8, s = q0 + r;
    const bool ok = s < k;
    cp_async16(sQ + r * LD + d, ok ? q + ((row0 + s) * nq + h) * HD + d : q, ok);
  }
  cp_async_commit();
  if (tid == 0) {
    sRed[0] = INT_MAX;
    sRed[1] = INT_MIN;
    sRed[2] = INT_MAX;
    sRed[3] = -1;
  }

  // this lane's two rows of the warp's 16: warp*16 + lane/4 (+ 8)
  const int rw = warp * 16 + (lane >> 2);
  int qp[2];
  bool in[2];
  int wmin = INT_MAX, wmax = INT_MIN;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + rw + hf * 8;
    in[hf] = s < k;
    qp[hf] = in[hf] ? pos[row0 + s] : 0;
    if (in[hf]) {
      wmin = min(wmin, qp[hf]);
      wmax = max(wmax, qp[hf]);
    }
  }
  const int wqmin = __reduce_min_sync(0xffffffffu, wmin);
  const int wqmax = __reduce_max_sync(0xffffffffu, wmax);
  const bool wact = __any_sync(0xffffffffu, in[0] || in[1]);  // the warp has a routed row
  __syncthreads();
  if (lane == 0 && wact) {
    atomicMin(&sRed[0], wqmin);
    atomicMax(&sRed[1], wqmax);
  }
  __syncthreads();
  {  // the first and last key some query row of the block can use
    int jlo = INT_MAX, jhi = -1;
    for (int j = tid; j < k; j += NT) {
      if (key_candidate(pos[row0 + j], sRed[0], sRed[1], causal, window)) {
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
  cp_async_wait<0>();  // Q has landed
  __syncthreads();
  // key tiles that hold a candidate key: [t_lo, t_hi); none when t_lo == t_hi
  const int t_lo = sRed[3] >= 0 ? sRed[2] / BN : 0;
  const int t_hi = sRed[3] >= 0 ? sRed[3] / BN + 1 : 0;

  unsigned qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk16 = 0; kk16 < KS; ++kk16)
      ldmatrix_x4(qf[kk16], sQ + (warp * 16 + (lane & 15)) * LD + kk16 * 16 + (lane >> 4) * 8);
  }

  float oacc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  // per lane until the end of its pass, then the row's: max m, sum l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  bool live[2] = {false, false};  // from pass 1: the row's m > NEG_INF / 2
  bool mok = false;               // from pass 1: so is every routed row's of the warp
  bool skipped = t_hi - t_lo < ntiles;  // pass 0 left out a tile of the warp's keys

  for (int pass = 0; pass < 3; ++pass) {
    int a = t_lo, z = t_hi;
    if (pass == 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // a tile left out in pass 0 held masked keys only (-1e30 each)
        if (skipped) m[hf] = fmaxf(m[hf], NEG_INF);
        m[hf] = quad_max(m[hf]);
        live[hf] = m[hf] > NEG_INF / 2;
      }
      mok = __all_sync(0xffffffffu, (!in[0] || live[0]) && (!in[1] || live[1]));
    } else if (pass == 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = quad_sum(l[hf]);
    }
    // a row with no valid key takes every key into its sum and its p @ V
    if (pass > 0 && !__syncthreads_and(!wact || mok)) {
      a = 0;
      z = ntiles;
    }
    // K (and in pass 2 V) of key tile t into a stage; rows past k are
    // zeros, so their products are finite and p = 0 meets V = 0
    auto load = [&](int stage, int t) {
      const int j0 = t * BN;
      bf16* dk = sK + stage * BN * LD;
      bf16* dv = sV + stage * BN * LD;
      for (int c = tid; c < BN * CPR; c += NT) {
        const int r = c / CPR, d = (c % CPR) * 8, j = j0 + r;
        const bool ok = j < k;
        const long long off = ok ? ((row0 + j) * nkv + hk) * HD + d : 0;
        cp_async16(dk + r * LD + d, kk + off, ok);
        if (pass == 2) cp_async16(dv + r * LD + d, vv + off, ok);
      }
      for (int r = tid; r < BN; r += NT) {
        const int j = j0 + r;
        cp_async4(sKp + stage * BN + r, pos + (j < k ? row0 + j : 0), j < k);
      }
    };
    if (a < z) load(0, a);
    cp_async_commit();
    for (int t = a; t < z; ++t) {
      const int stage = (t - a) & 1;
      if (t + 1 < z) load(stage ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed
      __syncthreads();
      const int* kp = sKp + stage * BN;
      const int nvalid = k - t * BN;  // keys of the tile below k
      bool run = wact;
      if (run && (pass == 0 || mok)) {  // skip a tile no key of which can be valid
        bool cand = false;
#pragma unroll
        for (int c = lane; c < BN; c += 32)
          cand |= c < nvalid && key_candidate(kp[c], wqmin, wqmax, causal, window);
        run = __any_sync(0xffffffffu, cand);
        if (pass == 0 && !run) skipped = true;
      }
      if (run) {
        const bf16* tk = sK + stage * BN * LD;
        float sc[NS][4];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
        for (int kk16 = 0; kk16 < KS; ++kk16) {
          unsigned a4[4];
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a4[i] = qf[kk16][i];
          } else {
            ldmatrix_x4(a4, sQ + (warp * 16 + (lane & 15)) * LD + kk16 * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {  // 16 keys: two n8 tiles
            unsigned bk[4];
            ldmatrix_x4(bk, tk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk16 * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16_16816(sc[2 * np], a4, bk);
            mma_bf16_16816(sc[2 * np + 1], a4, bk + 2);
          }
        }
        // the score of (row e >> 1, key c): bf16(q.k) * scale, -1e30 where
        // masked; a key past k takes no part, a masked one in a live row
        // adds 0 to l and has p = 0
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + (lane & 3) * 2 + (e & 1), hf = e >> 1;
            const int kpv = kp[c], qv = qp[hf];
            const bool valid = c < nvalid && kpv >= 0 && (!causal || kpv <= qv) &&
                               (window <= 0 || qv - kpv < window);
            const bool part = valid || (c < nvalid && !live[hf]);
            const float s = valid ? __fmul_rn(rnd<bf16>(sc[nt][e]), scale) : NEG_INF;
            if (pass == 0) {
              if (c < nvalid) m[hf] = fmaxf(m[hf], s);
            } else if (pass == 1) {
              if (part) l[hf] += expf(s - m[hf]);
            } else {
              sc[nt][e] = part ? rnd<bf16>(__fdiv_rn(expf(s - m[hf]), l[hf])) : 0.f;
            }
          }
        if (pass == 2) {  // O += P V with P (already bf16) the A operand in place
          const bf16* tv = sV + stage * BN * LD;
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            const unsigned pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                    pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                    pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                    pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
            for (int np = 0; np < HD / 16; ++np) {
              unsigned bv[4];
              ldmatrix_x4_trans(bv, tv + (j * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
              mma_bf16_16816(oacc[2 * np], pa, bv);
              mma_bf16_16816(oacc[2 * np + 1], pa, bv + 2);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    cp_async_wait<0>();
  }

  const int col = (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!in[hf]) continue;
    bf16* orow = o + ((row0 + q0 + rw + hf * 8) * nq + h) * HD;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + col) =
          __floats2bfloat162_rn(oacc[nt][2 * hf], oacc[nt][2 * hf + 1]);
  }
}

template <int HD>
cudaError_t attend_tc(const bf16* q, const bf16* kk, const bf16* vv, const int* pos, bf16* o,
                      int B, int k, int nq, int nkv, float scale, int causal, int window,
                      cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      routed_attn_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((k + TC_ROWS - 1) / TC_ROWS, nq, B);
  routed_attn_tc_kernel<HD><<<grid, TC_WARPS * 32, smem, st>>>(q, kk, vv, pos, o, k, nq, nkv,
                                                               scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t attend(const T* q, const T* kk, const T* vv, const int* pos, T* o, int B, int k,
                   int nq, int nkv, float scale, int causal, int window, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return attend_tc<HD>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
  else
    return attend_f32<HD>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
}

template <typename T>
cudaError_t attend_hd(int hd, const T* q, const T* kk, const T* vv, const int* pos, T* o, int B,
                      int k, int nq, int nkv, float scale, int causal, int window,
                      cudaStream_t st) {
  switch (hd) {
    case 32: return attend<T, 32>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
    case 64: return attend<T, 64>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
    case 128: return attend<T, 128>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
    case 256: return attend<T, 256>(q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t rope(T* q, T* k, const int* pos, const float* freqs, int rows, int nq, int nkv,
                 int hd, cudaStream_t st) {
  rope_kernel<T><<<rows, ROPE_THREADS, 0, st>>>(q, k, pos, freqs, nq, nkv, hd);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x_, const void* idx_, const void* pos_, const void* ln_, const void* wq_,
        const void* wk_, const void* wv_, const void* wo_, const void* bq_, const void* bk_,
        const void* bv_, const void* freqs_, void* xs_, void* hn_, void* q_, void* k_, void* v_,
        void* o_, void* a_, void* h_, int B, int S, int k, int D, int nq, int nkv, int hd,
        int path, float eps, float scale, int causal, int window, int use_rope,
        cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const long long* idx = static_cast<const long long*>(idx_);
  const int* pos = static_cast<const int*>(pos_);
  T* xs = static_cast<T*>(xs_);
  T* hn = static_cast<T*>(hn_);
  T* q = static_cast<T*>(q_);
  T* kk = static_cast<T*>(k_);
  T* vv = static_cast<T*>(v_);
  T* o = static_cast<T*>(o_);
  const int M = B * k, Nq = nq * hd, Nkv = nkv * hd;
  FUSED_TRY(fused::rmsnorm_rows<T>(x, idx, static_cast<const T*>(ln_), xs, hn, M, k, S, D, eps,
                                   st));
  const T* wk = static_cast<const T*>(wk_);
  const T* wv = static_cast<const T*>(wv_);
  const EpiAttnStore<T> sq{{q, static_cast<const T*>(bq_), Nq}};
  const EpiAttnStore<T> sk{{kk, static_cast<const T*>(bk_), Nkv}};
  const EpiAttnStore<T> sv{{vv, static_cast<const T*>(bv_), Nkv}};
  FUSED_TRY((fused::gemm_on<T, 1>(path, hn, static_cast<const T*>(wq_), nullptr, M, Nq, D, sq,
                                  st)));
  if (path == REPRO_GEMM_WGMMA) {
    FUSED_TRY((fused::gemm_on<T, 2>(path, hn, wk, wv, M, Nkv, D, EpiAttnKV<T>{sk, sv}, st)));
  } else {
    FUSED_TRY((fused::gemm_on<T, 1>(path, hn, wk, nullptr, M, Nkv, D, sk, st)));
    FUSED_TRY((fused::gemm_on<T, 1>(path, hn, wv, nullptr, M, Nkv, D, sv, st)));
  }
  if (use_rope)
    FUSED_TRY(rope<T>(q, kk, pos, static_cast<const float*>(freqs_), M, nq, nkv, hd, st));
  FUSED_TRY(attend_hd<T>(hd, q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st));
  FUSED_TRY((fused::gemm_on<T, 1>(path, o, static_cast<const T*>(wo_), nullptr, M, D, Nq,
                                  EpiAttnOut<T>{{static_cast<T*>(a_), static_cast<T*>(h_), xs, D}},
                                  st)));
  return 0;
}

}  // namespace

// path: the GEMM of all four projections (REPRO_GEMM_CUDA_CORES /
// REPRO_GEMM_WGMMA, bf16 only); the attention core follows the dtype.
extern "C" int repro_routed_attention(
    const void* x, const void* idx, const void* pos, const void* ln, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bq, const void* bk,
    const void* bv, const void* freqs, void* xs, void* hn, void* q, void* k_, void* v, void* o,
    void* a, void* h, int B, int S, int k, int D, int nq, int nkv, int hd, int dtype, int path,
    float eps, float scale, int causal, int window, int use_rope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return run<bf16>(x, idx, pos, ln, wq, wk, wv, wo, bq, bk, bv, freqs, xs, hn, q, k_, v, o, a,
                     h, B, S, k, D, nq, nkv, hd, path, eps, scale, causal, window, use_rope, st);
  return run<float>(x, idx, pos, ln, wq, wk, wv, wo, bq, bk, bv, freqs, xs, hn, q, k_, v, o, a, h,
                    B, S, k, D, nq, nkv, hd, path, eps, scale, causal, window, use_rope, st);
}
