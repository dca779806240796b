// Ragged paged flash attention: flash attention of a flat query stream whose
// K/V is read straight out of the block-paged KV pool through the page table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ragged.py::
// ragged_paged_flash_attention (_ragged_flash_kernel for wide pages,
// _ragged_flash_quant_kernel for int8/e4m3 pages with scales). Same function:
// segment s owns flat rows [offs[s], offs[s+1]) and reads the pages
// table[seg_slot[s], 0..P) of its slot; query row t (position q_pos[t])
// attends page row (n, r) (position kp = pos_pages[n, r]) iff kp >= 0,
// q_pos >= 0, kp <= q_pos when causal and q_pos - kp < window when
// window > 0; query head h reads kv head h*nkv/nq. Scores and the softmax
// are f32 with the Pallas kernel's NEG_INF, m_safe and corr guards; wide
// pages round p to the page type before p@V, narrow pages widen K and V to
// f32 times the row's per-kv-head scale and keep p in f32; only the output
// is rounded, to q's type. A row with no valid key comes out as 0, as do the
// rows outside [offs[0], offs[n_seg]); a segment longer than seg_cap gives
// its rows past seg_cap the output of its row seg_cap-1 (the clipped gather
// of the Pallas wrapper). Page ids and slots are clamped into range.
//
// Two paths; kernels/ragged.py::ragged_attention_plan picks one from q's
// type and sizes it, and this file refuses a plan that is not its own:
//
// 1. "mma", bf16 queries on bf16, int8 or e4m3 pages. What bounds it on the
//    H100: bytes at decode (each page row of the segments' slots is needed
//    once per kv head: ~20 MB for 8 slots of mod-paper-1b's pool, 6 us at
//    3.35 TB/s), operations for a long prefill segment (4 * hd per valid
//    (query, key) pair and query head). The first port read K/V once per
//    query head, one key a lane with 16-byte loads 256 bytes apart, on CUDA
//    cores, with 8 x 14 blocks of 4 warps at a decode step. This design:
//    - A block's rows are the (query row, query head of the group) pairs of
//      one kv head, so a staged page row serves the whole GQA group. The
//      plan tiles them by 16 (one m16 tile) when seg_cap * group <= 16,
//      else by 64 (16 rows a warp). The grid walks a flat list of the
//      segments' tiles (each block finds its entry from the row offsets by
//      a block-wide scan), so a decode segment of a call whose seg_cap is a
//      prefill chunk costs one tile, not seg_cap's.
//    - Split-KV: the slot's logical context (P*p keys) is cut into chunks of
//      two key tiles, fixed by the head dim (128 keys at head dims 32-128,
//      64 at 256); one block of 4 warps takes one (chunk, kv head, tile), so
//      a decode step of 8 slots x 14 kv heads runs 896 blocks. With one
//      chunk (P*p <= chunk) the block writes the output (one launch);
//      otherwise it writes its unnormalised (m, l, acc) to f32 scratch the
//      wrapper allocates, and a merge kernel (a programmatic dependent
//      launch: its blocks find their rows while the main grid ends) combines
//      the chunks in order. A chunk with no valid key adds exact zeros.
//    - The block first reads its chunk's key positions (one key a thread:
//      table entry -> page row -> position, and on narrow pages the row's K
//      and V scales). A key that no (query, key) pair of the block can use
//      is dropped there (the NULL pages past a sequence, the future half of
//      a causal prefill); a key tile left without keys is never read, and a
//      chunk left without keys exits at once. Then the K and V rows of both
//      tiles are copied with 16-byte cp.async into two shared-memory stages
//      at once, coalesced along each row, each row looked up through the
//      table on its own, so any page size and page order work (shared
//      prefix pages come from L2 to the segments after the first). Q's
//      fragments are read from global memory into registers, so a block
//      holds ~71 KB and 3 fit an SM.
//    - S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 sums); the mask (tested
//      per score, so no bit mask bounds the tile; skipped where every pair
//      of a warp's tile is valid) and the online softmax run on the
//      accumulator fragments (scores carry log2(e), so p = 2^(s - m); a
//      masked score is NEG_INF and its p exactly 0); then O += P V. Wide
//      pages: p goes to bf16 in registers as the A operand (the Pallas
//      kernel's p.astype(v.dtype)). Narrow pages: the bytes are staged at
//      the end of each shared bf16 row and widened to bf16 in place by the
//      row's thread, exactly (every int8 and e4m3 value is a bf16 value);
//      the K scale multiplies the score columns after the product, the V
//      scale folds into p (p' = p * vs in f32), and p' is split into two
//      bf16 terms (hi + lo) so that P V keeps p to ~16 bits, as the Pallas
//      kernel's f32 p requires (V itself is exact).
//    - A tile of at most 16 rows (decode) gives each warp a quarter of the
//      chunk's keys, and the 4 warps' (m, l, O) merge in warp order through
//      shared memory; a taller tile gives each warp 16 rows and all keys,
//      the second tile's copies landing while the first is computed.
// 2. "f32", f32 queries on f32, int8 or e4m3 pages: the CUDA-core kernel of
//    the first port, kept for the f32 parity runs. One block of 4 warps per
//    (row tile of BQ query rows, query head, segment), plus one block row
//    that writes the zero rows; the slot's context is walked in 32-key
//    chunks, one key per lane, dealt to the warps in turn, each warp
//    keeping its own online softmax, merged at the end.
//
// No kernel allocates or synchronises with the host, so both paths capture
// in a CUDA graph.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "narrow.cuh"

REPRO_ERROR_STRING

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's masked score
constexpr int NWARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

// kv kinds passed by the wrapper: 0 f32 and 1 bf16 (wide pages of q's
// type), 2 int8 and 3 e4m3 (narrow pages with scales)
constexpr int KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2, KV_E4M3 = 3;
// path codes of kernels/ragged.py (_ATTN_PATHS)
constexpr int PATH_F32 = 0, PATH_MMA = 1;

// The plan of kernels/ragged.py::ragged_attention_plan, as passed to C.
struct Plan {
  int path, rows, key_tile, chunk, n_chunks, gx, gy, gz, smem;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ===========================================================================
// Path 2: f32 queries on CUDA cores
// ===========================================================================

// K/V element access: 8 consecutive elements (8-element aligned) or one,
// widened to f32; ``narrow`` pages carry a scale per (page row, kv head)
template <typename KV>
struct Kv;
template <>
struct Kv<float> {
  static constexpr bool narrow = false;
  __device__ static void load8(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  __device__ static float load1(const float* p) { return *p; }
};
template <typename Q>
struct KvNarrow {
  static constexpr bool narrow = true;
  __device__ static void load8(const Q* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = widen<Q>(b[j]);
  }
  __device__ static float load1(const Q* p) {
    return widen<Q>(*reinterpret_cast<const unsigned char*>(p));
  }
};
template <>
struct Kv<int8_t> : KvNarrow<int8_t> {};
template <>
struct Kv<__nv_fp8_e4m3> : KvNarrow<__nv_fp8_e4m3> {};

template <typename KV, int HD, int BQ>
__global__ void __launch_bounds__(NWARPS * 32)
ragged_attn_f32_kernel(const float* __restrict__ q, const KV* __restrict__ kpg,
                   const KV* __restrict__ vpg, const float* __restrict__ ksc,
                   const float* __restrict__ vsc, const int* __restrict__ pos_pages,
                   const int* __restrict__ table, const int* __restrict__ offs,
                   const int* __restrict__ seg_slot, const int* __restrict__ qpos,
                   float* __restrict__ out, int n_rows, int nq, int nkv, int N, int p, int B,
                   int P, int n_seg, int C, float scale, int causal, int window) {
  constexpr int DPL = HD / 32;  // output columns per lane
  constexpr bool NARROW = Kv<KV>::narrow;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // BQ x HD query rows, f32
  float* sAcc = sQ + BQ * HD;    // NWARPS x BQ x HD partial outputs
  __shared__ float sM[NWARPS][BQ];
  __shared__ float sL[NWARPS][BQ];
  __shared__ int sQp[BQ];

  const int tile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = clampi(offs[0], 0, n_rows);
  const int last = clampi(offs[n_seg], first, n_rows);

  if (s == n_seg) {  // the rows no segment owns: zeros
    const float zero = 0.f;
    for (int t = tile; t < first; t += gridDim.x)
      for (int d = tid; d < HD; d += blockDim.x) out[((long long)t * nq + h) * HD + d] = zero;
    for (int t = last + tile; t < n_rows; t += gridDim.x)
      for (int d = tid; d < HD; d += blockDim.x) out[((long long)t * nq + h) * HD + d] = zero;
    return;
  }

  const int lo = clampi(offs[s], first, last);
  const int hi = clampi(offs[s + 1], lo, last);
  const int r0 = tile * BQ;
  const int nrows = min(BQ, min(hi - lo, C) - r0);  // this tile's rows
  if (nrows <= 0) return;  // block-uniform: a tile past the segment
  const int slot = clampi(seg_slot[s], 0, B - 1);
  const int hk = (int)((long long)h * nkv / nq);

  for (int e = tid; e < nrows * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    sQ[e] = to_f32(q[((long long)(lo + r0 + r) * nq + h) * HD + d]);
  }
  if (tid < BQ) sQp[tid] = tid < nrows ? qpos[lo + r0 + tid] : -1;
  __syncthreads();
  int qmax = -1, qmin = INT_MAX;
  for (int r = 0; r < nrows; ++r) {
    const int qp = sQp[r];
    if (qp >= 0) {
      qmax = max(qmax, qp);
      qmin = min(qmin, qp);
    }
  }

  float m[BQ], l[BQ], acc[BQ][DPL];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  if (qmax >= 0) {  // block-uniform: some query row of the tile is valid
    const int ctx = P * p;
    const int n_chunks = (ctx + 31) / 32;
    for (int c = warp; c < n_chunks; c += NWARPS) {
      const int kk = c * 32 + lane;  // this lane's key in the slot's context
      int kp = -1;
      long long row = 0;  // physical page row: page * p + offset
      if (kk < ctx) {
        const int pid = clampi(table[(long long)slot * P + kk / p], 0, N - 1);
        row = (long long)pid * p + kk % p;
        kp = pos_pages[row];
      }
      const bool cand =
          kp >= 0 && (!causal || kp <= qmax) && (window <= 0 || kp > qmin - window);
      const unsigned live = __ballot_sync(FULL, cand);
      if (live == 0) continue;  // warp-uniform: no valid pair in this chunk

      float ks = 1.f, vs = 1.f;
      if (NARROW && cand) {
        ks = ksc[row * nkv + hk];
        vs = vsc[row * nkv + hk];
      }
      float sc[BQ];
#pragma unroll
      for (int r = 0; r < BQ; ++r) sc[r] = 0.f;
      if (cand) {
        const KV* krow = kpg + (row * nkv + hk) * HD;
#pragma unroll 2
        for (int d0 = 0; d0 < HD; d0 += 8) {
          float kf[8];
          Kv<KV>::load8(krow + d0, kf);
          if (NARROW) {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = __fmul_rn(kf[e], ks);
          }
#pragma unroll
          for (int r = 0; r < BQ; ++r) {
            if (r < nrows) {
              const float4 qa = *reinterpret_cast<const float4*>(sQ + r * HD + d0);
              const float4 qb = *reinterpret_cast<const float4*>(sQ + r * HD + d0 + 4);
              float a = sc[r];
              a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
              a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
              a = fmaf(qb.x, kf[4], a); a = fmaf(qb.y, kf[5], a);
              a = fmaf(qb.z, kf[6], a); a = fmaf(qb.w, kf[7], a);
              sc[r] = a;
            }
          }
        }
      }

      // online softmax, one row at a time; sc[r] becomes p (rounded for p@V)
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        if (r < nrows) {  // warp-uniform
          const int qp = sQp[r];
          const bool valid = cand && qp >= 0 && (!causal || kp <= qp) &&
                             (window <= 0 || qp - kp < window);
          const float sv = valid ? sc[r] * scale : NEG_INF;
          const float m_new = fmaxf(m[r], warp_max(sv));
          const float m_safe = m_new > NEG_INF / 2 ? m_new : 0.f;
          const float pr = valid ? expf(sv - m_safe) : 0.f;
          const float corr = m[r] > NEG_INF / 2 ? expf(m[r] - m_safe) : 0.f;
          l[r] = l[r] * corr + warp_sum(pr);
          m[r] = m_new;
          sc[r] = pr;  // p stays f32
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
        }
      }

      // p @ V over the chunk's candidate keys
      unsigned rem = live;
      while (rem) {
        const int j = __ffs(rem) - 1;
        rem &= rem - 1;
        const long long vrow = __shfl_sync(FULL, row, j);
        const float vsj = __shfl_sync(FULL, vs, j);
        const KV* vp = vpg + (vrow * nkv + hk) * HD + lane;
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          vv[i] = Kv<KV>::load1(vp + 32 * i);
          if (NARROW) vv[i] = __fmul_rn(vv[i], vsj);
        }
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          if (r < nrows) {
            const float pj = __shfl_sync(FULL, sc[r], j);
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
          }
        }
      }
    }
  }

  // merge the warps' states: rescale each to the common maximum
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    if (r < nrows) {
      if (lane == 0) {
        sM[warp][r] = m[r];
        sL[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sAcc[(warp * BQ + r) * HD + lane + 32 * i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sM[w][r]);
    const float m_safe = mx > NEG_INF / 2 ? mx : 0.f;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = sM[w][r] > NEG_INF / 2 ? expf(sM[w][r] - m_safe) : 0.f;
      a = fmaf(f, sAcc[(w * BQ + r) * HD + d], a);
      lsum = fmaf(f, sL[w][r], lsum);
    }
    const float o = a / fmaxf(lsum, 1e-30f);
    out[((long long)(lo + r0 + r) * nq + h) * HD + d] = o;
    if (r0 + r == C - 1)  // rows of an over-long segment past seg_cap
      for (int t = lo + C; t < hi; ++t) out[((long long)t * nq + h) * HD + d] = o;
  }
}

// f32 rows per block: bounds the acc registers per lane
__host__ __device__ constexpr int f32_rows(int hd) { return hd >= 256 ? 8 : 16; }
constexpr int F32_KEYS = 32;  // keys per warp step of the f32 kernel: one per lane

// One call's arguments, as the C entry point takes them.
struct Call {
  const void *q, *k, *v, *ks, *vs, *pos, *table, *offs, *slot, *qpos;
  void *out, *part_m, *part_l, *part_acc;
  int n_rows, nq, nkv, N, p, B, P, n_seg, C;
  float scale;
  int causal, window;
  cudaStream_t st;
};

template <typename KV, int HD>
int launch_f32(const Plan& pl, const Call& a) {
  constexpr int BQ = f32_rows(HD);
  constexpr size_t smem = (size_t)(BQ * HD + NWARPS * BQ * HD) * sizeof(float);
  if (pl.rows != BQ || pl.key_tile != F32_KEYS || pl.chunk != 0 || pl.n_chunks != 0 ||
      pl.gx != (a.C + BQ - 1) / BQ || pl.gy != a.nq || pl.gz != a.n_seg + 1 ||
      pl.smem != (int)smem)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = smem_limit_once(attr_set, ragged_attn_f32_kernel<KV, HD, BQ>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ragged_attn_f32_kernel<KV, HD, BQ><<<dim3(pl.gx, pl.gy, pl.gz), NWARPS * 32, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.table),
      static_cast<const int*>(a.offs), static_cast<const int*>(a.slot),
      static_cast<const int*>(a.qpos), static_cast<float*>(a.out), a.n_rows, a.nq, a.nkv, a.N,
      a.p, a.B, a.P, a.n_seg, a.C, a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// Path 1: bf16 queries on tensor cores
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int MMA_WARPS = 4;
constexpr int SPLIT_ROWS = 16;  // a tile of at most one m16 tile of rows splits its keys
constexpr int TALL_ROWS = 64;   // the taller tile: 16 rows a warp
constexpr float LOG2E = 1.4426950408889634f;

// keys per staged K/V tile; a chunk is two tiles, staged whole
__host__ __device__ constexpr int mma_key_tile(int hd) { return hd == 256 ? 32 : 64; }

template <int HD>
struct MmaCfg {
  static constexpr int KT = mma_key_tile(HD);
  static constexpr int CH = 2 * KT;
  static constexpr int LD = HD + 8;  // shared row stride (bf16): +16 bytes against bank conflicts
  static constexpr int NO = HD / 8;  // n8 tiles of O
  static constexpr int KV_ELEMS = 2 * 2 * KT * LD;  // 2 stages x (K, V) x KT rows
  static_assert(MMA_WARPS * (NO * 4 + 4) * 32 * 4 <= KV_ELEMS * 2,
                "the split merge's exchange fits the stages");
  static_assert(NO % MMA_WARPS == 0, "each warp finishes whole n8 tiles");
  // the stages, the chunk's key positions and page rows, the rows'
  // positions and, on narrow pages, the chunk's K and V scales (Q is read
  // into registers from global memory: 3 blocks fit an SM at every plan)
  static constexpr size_t smem(int rows, bool narrow) {
    return (size_t)KV_ELEMS * 2 + (size_t)(2 * CH + rows) * 4 +
           (narrow ? (size_t)2 * CH * 4 : 0);
  }
};

// x0, x1 as two bf16 terms each: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Two narrow bytes as a bf16 pair (a in the low half), exactly: every int8
// and e4m3 value is a bf16 value, so the pair is the high halves of their
// f32 values. int8: f32 of x as (2^23 + 2^22 + x) - (2^23 + 2^22), two
// full-rate operations in place of an int-to-float conversion; e4m3: the
// hardware's pair conversion to f16.
template <typename KV>
__device__ __forceinline__ unsigned bf16_pair(unsigned char a, unsigned char b);
template <>
__device__ __forceinline__ unsigned bf16_pair<int8_t>(unsigned char a, unsigned char b) {
  const float fa = __int_as_float(0x4B400000 + (int)(signed char)a) - 12582912.f;
  const float fb = __int_as_float(0x4B400000 + (int)(signed char)b) - 12582912.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}
template <>
__device__ __forceinline__ unsigned bf16_pair<__nv_fp8_e4m3>(unsigned char a, unsigned char b) {
  const __half2 h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(a | (b << 8)), __NV_E4M3);
  const float2 f = __half22float2(h);
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// Widens one narrow K or V row (HD bytes, staged at byte HD + 16 of its
// shared bf16 row) to bf16 in place; every int8 and e4m3 value is a bf16
// value, so this is exact. Piece j's 32 bytes of bf16 end before piece
// j + 1's raw bytes begin (32j + 32 <= HD + 16 + 16(j + 1)), so the thread
// that owns a row widens it in order with no barrier.
template <typename KV, int HD>
__device__ __forceinline__ void widen_row(bf16* row) {
  unsigned char* base = reinterpret_cast<unsigned char*>(row);
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(base + HD + 16 + 16 * j);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
    unsigned w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = bf16_pair<KV>(b[2 * e], b[2 * e + 1]);
    uint4* dst = reinterpret_cast<uint4*>(base + 32 * j);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// One warp's 16 rows (qrow: this lane's rows lane/4 and lane/4 + 8 in q,
// null for no row; qp their positions) against NK staged keys (tk, tv: NK rows of K and V; kp their positions,
// -1 for no key; ks, vs their scales on narrow pages): S = Q K^T, the mask
// and the online softmax on the accumulator fragments (e = 0, 1: row
// lane/4; e = 2, 3: row lane/4 + 8), then O += P V. Wide pages: p rounded
// to bf16. Narrow: s = scale * ks * (q . k), p' = p * vs split into bf16
// hi + lo, two products.
template <int HD, int NK, bool NARROW>
__device__ __forceinline__ void warp_keys(const bf16* const (&qrow)[2], const bf16* tk,
                                          const bf16* tv,
                                          const int* kp, const float* ks, const float* vs,
                                          const int (&qp)[2], float sl, int causal, int window,
                                          float (&m)[2], float (&l)[2],
                                          float (&o)[HD / 8][4]) {
  constexpr int LD = HD + 8, NS = NK / 8, NO = HD / 8, KS = HD / 16;
  static_assert(NK % 16 == 0 && NK <= 64, "whole k16 steps of P V");
  const int lane = threadIdx.x & 31;
  // the warp's query positions, and whether every (row, key) pair is valid
  // (then no score needs its mask)
  const int qlo = __reduce_min_sync(FULL, min(qp[0], qp[1]));
  const int qhi = __reduce_max_sync(FULL, max(qp[0], qp[1]));
  bool any = false, all = qlo >= 0;
#pragma unroll
  for (int i = lane; i < NK; i += 32) {  // any: some row of the warp may use key i
    any |= kp[i] >= 0 && (!causal || kp[i] <= qhi) && (window <= 0 || qlo - kp[i] < window);
    all &= kp[i] >= 0 && (!causal || kp[i] <= qlo) && (window <= 0 || qhi - kp[i] < window);
  }
  if (!__any_sync(FULL, any)) return;  // warp-uniform: no pair of the warp is valid
  const bool full = __all_sync(FULL, all);

  float sc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned a[4];  // Q's A fragment from global memory (L1 after the first tile)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const bf16* r = qrow[x & 1];
      a[x] = r ? __ldg(reinterpret_cast<const unsigned*>(r + kk * 16 + (x >> 1) * 8 +
                                                          (lane & 3) * 2))
               : 0u;
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

  // mask and scale: the validity of each score is tested in place, so no
  // bit mask bounds the tile's width
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
      const int kpv = kp[c], q = qp[e >> 1];
      const bool ok = full || (q >= 0 && kpv >= 0 && (!causal || kpv <= q) &&
                               (window <= 0 || q - kpv < window));
      const float sv = NARROW ? sc[nt][e] * ks[c] * sl : sc[nt][e] * sl;
      sc[nt][e] = ok ? sv : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
      const float pe = exp2f(sc[nt][e] - ms[e >> 1]);  // 0 for a masked score
      sc[nt][e] = pe;
      sum[e >> 1] += pe;
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * corr[hf] + quad_sum(sum[hf]);
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];

#pragma unroll
  for (int j = 0; j < NK / 16; ++j) {
    // a[x]: n8 tile 2j + x/2, rows lane/4 (x even) and lane/4 + 8 (x odd)
    unsigned a[4], lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int nt = 2 * j + (x >> 1), e = 2 * (x & 1);
      if (NARROW) {
        const int c = nt * 8 + (lane & 3) * 2;
        split_bf16(sc[nt][e] * vs[c], sc[nt][e + 1] * vs[c + 1], a[x], lo[x]);
      } else {
        a[x] = pack_bf16(sc[nt][e], sc[nt][e + 1]);
      }
    }
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, tv + (j * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o[2 * np], a, bv);
      mma_bf16_16816(o[2 * np + 1], a, bv + 2);
      if (NARROW) {
        mma_bf16_16816(o[2 * np], lo, bv);
        mma_bf16_16816(o[2 * np + 1], lo, bv + 2);
      }
    }
  }
}

// The flat tile list: segment s owns ceil(min(len_s, C) * g / RT) row
// tiles, listed in segment order; entry i -> (segment, tile of it, its
// first and last flat row). Block-wide, 128 segments at a time (a warp
// scan of their tile counts, then across the warps); false past the end.
__device__ bool locate_tile(const int* offs, int n_seg, int first, int last, int C, int g,
                            int RT, int i, int (&sh)[MMA_WARPS + 4], int& seg, int& tile,
                            int& lo, int& hi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;  // tiles of the segments before this group
  for (int s0 = 0; s0 < n_seg; s0 += MMA_WARPS * 32) {
    const int s = s0 + tid;
    int n = 0, slo = 0, shi = 0;
    if (s < n_seg) {
      slo = clampi(offs[s], first, last);
      shi = clampi(offs[s + 1], slo, last);
      n = (min(shi - slo, C) * g + RT - 1) / RT;
    }
    int x = n;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      before += w < warp ? sh[w] : 0;
      total += sh[w];
    }
    if (i >= before + x - n && i < before + x) {  // one thread: its segment holds tile i
      sh[MMA_WARPS] = s;
      sh[MMA_WARPS + 1] = i - (before + x - n);
      sh[MMA_WARPS + 2] = slo;
      sh[MMA_WARPS + 3] = shi;
    }
    __syncthreads();
    if (i < base + total) {
      seg = sh[MMA_WARPS];
      tile = sh[MMA_WARPS + 1];
      lo = sh[MMA_WARPS + 2];
      hi = sh[MMA_WARPS + 3];
      return true;
    }
    base += total;
    __syncthreads();  // every thread has read sh before the next group writes it
  }
  return false;
}

// One block of 4 warps per (chunk, kv head, segment, row tile): blockIdx.x
// = i * n_chunks + chunk for entry i of the flat tile list, y the kv head;
// z = 1 (one launch only) writes the rows no segment owns, zeros. Writes
// the output when n_chunks == 1, else the chunk's unnormalised (m in log2
// units, l, acc) per (row, query head) at part_*[chunk, t, h].
template <typename KV, int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32, HD <= 128 ? 3 : 1)  // 3 blocks fit an SM's smem
ragged_attn_mma_kernel(const bf16* __restrict__ q, const KV* __restrict__ kpg,
                       const KV* __restrict__ vpg, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const int* __restrict__ pos_pages,
                       const int* __restrict__ table, const int* __restrict__ offs,
                       const int* __restrict__ seg_slot, const int* __restrict__ qpos,
                       bf16* __restrict__ out, float* __restrict__ part_m,
                       float* __restrict__ part_l, float* __restrict__ part_acc, int n_rows,
                       int nq, int nkv, int N, int p, int B, int P, int n_seg, int C, int RT,
                       int n_chunks, float scale, int causal, int window) {
  using Cfg = MmaCfg<HD>;
  constexpr bool NARROW = !std::is_same<KV, bf16>::value;
  constexpr int KT = Cfg::KT, CH = Cfg::CH, LD = Cfg::LD, NO = Cfg::NO, NT = MMA_WARPS * 32;
  constexpr int KVP = HD * (int)sizeof(KV) / 16;  // 16-byte pieces of a K/V row
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sKV = reinterpret_cast<bf16*>(mma_smem);    // [stage][K, V][KT][LD]
  int* sKp = reinterpret_cast<int*>(sKV + Cfg::KV_ELEMS);  // CH key positions (-1: none here)
  int* sRow = sKp + CH;                              // CH physical page rows
  int* sQp = sRow + CH;                              // RT query positions (-1: no row)
  float* sKs = reinterpret_cast<float*>(sQp + RT);   // CH K scales (narrow pages)
  float* sVs = sKs + CH;                             // CH V scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the merge grid (a programmatic dependent launch) may start once every
  // block of this one has: its blocks find their rows, then wait for this
  // grid's end before reading the partial states
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int chunk = blockIdx.x % n_chunks, hk = blockIdx.y, g = nq / nkv;
  const int first = clampi(offs[0], 0, n_rows);
  const int last = clampi(offs[n_seg], first, n_rows);
  const bool direct = n_chunks == 1;

  if (blockIdx.z == 1) {  // the rows no segment owns: zeros (this kv head's query heads)
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int t = blockIdx.x; t < first; t += gridDim.x)
      for (int e = tid; e < g * HD; e += NT) out[((long long)t * nq + hk * g) * HD + e] = zero;
    for (int t = last + blockIdx.x; t < n_rows; t += gridDim.x)
      for (int e = tid; e < g * HD; e += NT) out[((long long)t * nq + hk * g) * HD + e] = zero;
    return;
  }

  __shared__ int sTile[MMA_WARPS + 4];
  int s, tile, lo, hi;
  if (!locate_tile(offs, n_seg, first, last, C, g, RT, blockIdx.x / n_chunks, sTile, s, tile, lo,
                   hi))
    return;  // block-uniform: past the list's end
  const int R0 = tile * RT;                          // the tile's first (row, head) pair
  const int nr = min(RT, min(hi - lo, C) * g - R0);  // the tile's pairs, >= 1
  const bool split = nr <= SPLIT_ROWS;
  const int slot = clampi(seg_slot[s], 0, B - 1);
  const long long ctx = (long long)P * p;
  const int key0 = chunk * CH;
  // pair r of the tile -> flat query row t and query head h
  auto row_of = [&](int r, int& t, int& h) -> bool {
    const int pr = R0 + r;
    t = lo + pr / g;
    h = hk * g + pr % g;
    return r < nr;
  };

  if (tid < RT) {
    int t, h;
    sQp[tid] = row_of(tid, t, h) ? qpos[t] : -1;
  }
  if (tid < CH) {  // this thread's key: table entry -> page row -> position (and scales)
    const long long kk = key0 + tid;
    int kp = -1, row = 0;
    float kscale = 0.f, vscale = 0.f;
    if (kk < ctx) {
      const int pid = clampi(table[(long long)slot * P + kk / p], 0, N - 1);
      row = pid * p + (int)(kk % p);
      kp = pos_pages[row];
      if (NARROW) {
        kscale = ksc[(long long)row * nkv + hk];
        vscale = vsc[(long long)row * nkv + hk];
      }
    }
    sKp[tid] = kp;
    sRow[tid] = row;
    if (NARROW) {
      sKs[tid] = kscale;
      sVs[tid] = vscale;
    }
  }
  __syncthreads();
  int qmax = -1, qmin = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    const int v = sQp[r];
    if (v >= 0) {
      qmax = max(qmax, v);
      qmin = min(qmin, v);
    }
  }
  // a key no (query, key) pair of the block can use is no key here: its
  // K/V rows are not read, and a tile left without keys is not staged
  bool cand = false;
  if (tid < CH) {
    cand = qmax >= 0 && key_candidate(sKp[tid], qmin, qmax, causal, window);
    if (!cand) sKp[tid] = -1;
  }
  const bool live0 = __syncthreads_or(cand && tid < KT) != 0;
  const bool live1 = __syncthreads_or(cand && tid >= KT) != 0;

  if (!live0 && !live1) {  // block-uniform: no key of the chunk is valid for the tile
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < nr * (direct ? HD : 1); e += NT) {
      int t, h;
      row_of(direct ? e / HD : e, t, h);
      if (!direct) {  // the merge reads neither l nor acc of such a chunk
        part_m[((long long)chunk * n_rows + t) * nq + h] = -INFINITY;
        continue;
      }
      const int d = e % HD;  // one chunk: the rows have no valid key, 0
      out[((long long)t * nq + h) * HD + d] = zero;
      if (t - lo == C - 1)
        for (int u = lo + C; u < hi; ++u) out[((long long)u * nq + h) * HD + d] = zero;
    }
    return;
  }

  auto stage = [&](int st) { return sKV + st * 2 * KT * LD; };  // K rows, then V rows
  auto issue = [&](int st) {  // K and V rows of tile st, 16-byte pieces along each row
    bf16* sk = stage(st);
    for (int c = tid; c < KT * KVP; c += NT) {
      const int r = c / KVP, j = c % KVP, key = st * KT + r;
      const bool ok = sKp[key] >= 0;
      const long long off =
          ok ? ((long long)sRow[key] * nkv + hk) * HD + j * (16 / (int)sizeof(KV)) : 0;
      unsigned char* dk =
          reinterpret_cast<unsigned char*>(sk + r * LD) + (NARROW ? HD + 16 : 0) + 16 * j;
      cp_async16(dk, kpg + off, ok);
      cp_async16(dk + KT * LD * 2, vpg + off, ok);
    }
  };
  if (live0) issue(0);
  cp_async_commit();
  if (live1) issue(1);
  cp_async_commit();

  const int row0 = lane >> 2, col = (lane & 3) * 2;
  const float sl = scale * LOG2E;
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int wr = split ? 0 : warp * 16;  // the warp's first row
  const int qp[2] = {sQp[wr + row0], sQp[wr + row0 + 8]};
  const bf16* qrow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    int t, h;
    qrow[hf] = row_of(wr + row0 + hf * 8, t, h) ? q + ((long long)t * nq + h) * HD : nullptr;
  }
  if (split) {  // warp w: keys [w * KT/2, (w+1) * KT/2) of the chunk
    cp_async_wait<0>();
    __syncthreads();
    const int st = warp >> 1, off = (warp & 1) * (KT / 2);
    if constexpr (NARROW) {  // the warp's own K and V rows, a lane each
      if (st == 0 ? live0 : live1) {
        for (int r = lane; r < KT / 2; r += 32) {
          widen_row<KV, HD>(stage(st) + (off + r) * LD);
          widen_row<KV, HD>(stage(st) + (KT + off + r) * LD);
        }
        __syncwarp();
      }
    }
    if (st == 0 ? live0 : live1)
      warp_keys<HD, KT / 2, NARROW>(qrow, stage(st) + off * LD, stage(st) + (KT + off) * LD,
                                    sKp + st * KT + off, sKs + st * KT + off,
                                    sVs + st * KT + off, qp, sl, causal, window, m, l, o);
  } else {  // warp w: rows [16w, 16w + 16), every key; tile 1 lands during tile 0
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      if (st == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      const bool live = st == 0 ? live0 : live1;
      if constexpr (NARROW) {  // the stage's K and V rows, a thread each
        if (live) {
          if (tid < 2 * KT) widen_row<KV, HD>(stage(st) + tid * LD);
          __syncthreads();
        }
      }
      if (live && wr < nr)
        warp_keys<HD, KT, NARROW>(qrow, stage(st), stage(st) + KT * LD, sKp + st * KT,
                                  sKs + st * KT, sVs + st * KT, qp, sl, causal, window, m, l, o);
    }
  }

  // the output of pair r, columns nt*8 + col, +1: normalised (one chunk),
  // or the chunk's partial state (`ml`: this lane writes m and l)
  auto emit = [&](int r, int nt, float x0, float x1, float M, float L, bool ml) {
    int t, h;
    row_of(r, t, h);
    if (direct) {
      const float lf = fmaxf(L, 1e-30f);
      const __nv_bfloat162 val = __floats2bfloat162_rn(x0 / lf, x1 / lf);
      *reinterpret_cast<__nv_bfloat162*>(out + ((long long)t * nq + h) * HD + nt * 8 + col) = val;
      if (t - lo == C - 1)  // rows of an over-long segment past seg_cap
        for (int u = lo + C; u < hi; ++u)
          *reinterpret_cast<__nv_bfloat162*>(out + ((long long)u * nq + h) * HD + nt * 8 + col) =
              val;
    } else {
      const long long idx = ((long long)chunk * n_rows + t) * nq + h;
      if (M > NEG_INF / 2)  // else the merge does not read acc
        *reinterpret_cast<float2*>(part_acc + idx * HD + nt * 8 + col) = make_float2(x0, x1);
      if (ml) {
        part_m[idx] = M;
        part_l[idx] = L;
      }
    }
  };

  if (!split) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr + row0 + hf * 8;
      if (r >= nr) continue;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        emit(r, nt, o[nt][2 * hf], o[nt][2 * hf + 1], m[hf], l[hf], nt == 0 && (lane & 3) == 0);
    }
    return;
  }
  // split: the warps' states merged in warp order, M = max m_w,
  // L = sum w_w l_w, acc = sum w_w acc_w, w_w = 2^(m_w - M) (0 for a warp
  // with no valid key); warp w finishes n8 tiles [w*NO/4, (w+1)*NO/4)
  __syncthreads();  // every warp is done with the stages: the exchange reuses them
  float* xo = reinterpret_cast<float*>(sKV);      // [warp][nt][e][lane]
  float* xml = xo + MMA_WARPS * NO * 4 * 32;       // [warp][m0, m1, l0, l1][lane]
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) xo[((warp * NO + nt) * 4 + e) * 32 + lane] = o[nt][e];
  xml[(warp * 4 + 0) * 32 + lane] = m[0];
  xml[(warp * 4 + 1) * 32 + lane] = m[1];
  xml[(warp * 4 + 2) * 32 + lane] = l[0];
  xml[(warp * 4 + 3) * 32 + lane] = l[1];
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + hf * 8;
    if (r >= nr) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) M = fmaxf(M, xml[(w * 4 + hf) * 32 + lane]);
    float wt[MMA_WARPS], L = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float mw = xml[(w * 4 + hf) * 32 + lane];
      wt[w] = mw > NEG_INF / 2 ? exp2f(mw - M) : 0.f;
      L = __fadd_rn(L, __fmul_rn(wt[w], xml[(w * 4 + 2 + hf) * 32 + lane]));
    }
#pragma unroll
    for (int i = 0; i < NO / MMA_WARPS; ++i) {
      const int nt = warp * (NO / MMA_WARPS) + i;
      float x[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          x[c] = __fadd_rn(x[c],
                           __fmul_rn(wt[w], xo[((w * NO + nt) * 4 + 2 * hf + c) * 32 + lane]));
      emit(r, nt, x[0], x[1], M, L, warp == 0 && i == 0 && (lane & 3) == 0);
    }
  }
}

// The chunks' partial states merged, one warp per (flat row, query head),
// MERGE_WARPS warps a block: M = max m_c, L = sum w_c l_c, out = sum w_c
// acc_c / max(L, 1e-30), w_c = 2^(m_c - M). Lane c holds chunk c's weight
// (chunks 32 apart in turns), L is a fixed shuffle tree over the lanes, acc
// sums the chunks in order, each lane HD/32 columns. A chunk with no valid
// key (m_c <= NEG_INF/2) adds nothing and its acc, never written, is not
// read. A row past a segment's seg_cap takes row seg_cap-1's; a row no
// segment owns is 0.
constexpr int MERGE_WARPS = 4;

template <int HD>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
ragged_attn_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                         const float* __restrict__ part_acc, const int* __restrict__ offs,
                         bf16* __restrict__ out, int n_rows, int nq, int n_seg, int C,
                         int n_chunks) {
  constexpr int CPL = HD / 32;  // columns a lane
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);  // t*nq + h
  if (pair >= (long long)n_rows * nq) return;  // warp-uniform
  const int t = (int)(pair / nq), h = (int)(pair % nq);
  const int first = clampi(offs[0], 0, n_rows);
  const int last = clampi(offs[n_seg], first, n_rows);
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  float L = 0.f;
  if (t >= first && t < last) {
    int a = 0, b = n_seg - 1;  // the segment holding t: the last one starting at or before it
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (clampi(offs[mid], first, last) <= t)
        a = mid;
      else
        b = mid - 1;
    }
    const int src = min(t, clampi(offs[a], first, last) + C - 1);
    const long long stride = (long long)n_rows * nq, base = (long long)src * nq + h;
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the main grid has ended
    float M = -INFINITY;
    for (int c = lane; c < n_chunks; c += 32) M = fmaxf(M, part_m[base + c * stride]);
    M = warp_max(M);
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      float w = 0.f;
      if (c0 + lane < n_chunks) {
        const long long idx = base + (c0 + lane) * stride;
        const float mc = part_m[idx], lc = part_l[idx];  // l is written with m
        if (mc > NEG_INF / 2) {
          w = exp2f(mc - M);
          L = __fadd_rn(L, __fmul_rn(w, lc));
        }
      }
      const int n = min(32, n_chunks - c0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(FULL, w, j);
        if (wj > 0.f) {
          const float* x = part_acc + (base + (c0 + j) * stride) * HD + lane * CPL;
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, x[e]));
        }
      }
    }
    L = warp_sum(L);
  }
  const float lf = fmaxf(L, 1e-30f);
  bf16* o = out + pair * HD + lane * CPL;
#pragma unroll
  for (int e = 0; e < CPL; ++e) o[e] = __float2bfloat16_rn(acc[e] / lf);
}

// the plan of kernels/ragged.py::ragged_attention_plan, checked against
// this file's own: rows per tile by seg_cap x group, the key tile and
// chunk of the head dim, the chunks that cover P*p, the grid, the shared
// memory, and the scratch when the chunks merge
template <typename KV, int HD>
int launch_mma(const Plan& pl, const Call& a) {
  using Cfg = MmaCfg<HD>;
  constexpr bool NARROW = !std::is_same<KV, bf16>::value;
  const long long pairs = (long long)a.C * (a.nq / a.nkv);
  const int rows = pairs <= SPLIT_ROWS ? SPLIT_ROWS : TALL_ROWS;
  const long long n_chunks = ((long long)a.P * a.p + Cfg::CH - 1) / Cfg::CH;
  const bool direct = n_chunks == 1;
  // entries of the flat tile list: at most n_seg tiles of seg_cap rows, and
  // at most one partial tile a segment past T rows' worth
  const long long rect = a.n_seg * ((pairs + rows - 1) / rows);
  const long long flat =
      ((long long)a.n_rows * (a.nq / a.nkv) + (long long)a.n_seg * (rows - 1)) / rows;
  const long long tiles = rect < flat ? rect : flat;
  if (pl.rows != rows || pl.key_tile != Cfg::KT || pl.chunk != Cfg::CH ||
      pl.n_chunks != n_chunks || pl.gx != tiles * n_chunks || pl.gy != a.nkv ||
      pl.gz != (direct ? 2 : 1) ||
      (size_t)pl.smem != Cfg::smem(rows, NARROW) ||
      (!direct && (a.part_m == nullptr || a.part_l == nullptr || a.part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the limit is set once per device, to the taller tile's (the most any plan asks)
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = smem_limit_once(attr_set, ragged_attn_mma_kernel<KV, HD>,
                                           Cfg::smem(TALL_ROWS, NARROW));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float* pm = static_cast<float*>(a.part_m);
  float* pl_ = static_cast<float*>(a.part_l);
  float* pa = static_cast<float*>(a.part_acc);
  ragged_attn_mma_kernel<KV, HD><<<dim3(pl.gx, pl.gy, pl.gz), MMA_WARPS * 32, pl.smem, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.table),
      static_cast<const int*>(a.offs), static_cast<const int*>(a.slot),
      static_cast<const int*>(a.qpos), static_cast<bf16*>(a.out), pm, pl_, pa, a.n_rows, a.nq,
      a.nkv, a.N, a.p, a.B, a.P, a.n_seg, a.C, rows, (int)n_chunks, a.scale, a.causal, a.window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const long long pairs_total = (long long)a.n_rows * a.nq;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)((pairs_total + MERGE_WARPS - 1) / MERGE_WARPS));
  lc.blockDim = dim3(MERGE_WARPS * 32);
  lc.stream = a.st;
  lc.attrs = pdl;
  lc.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&lc, ragged_attn_merge_kernel<HD>,
                                             (const float*)pm, (const float*)pl_,
                                             (const float*)pa, static_cast<const int*>(a.offs),
                                             static_cast<bf16*>(a.out), a.n_rows, a.nq, a.n_seg,
                                             a.C, (int)n_chunks));
}

template <typename KV>
int mma_by_hd(int hd, const Plan& pl, const Call& a) {
  switch (hd) {
    case 32: return launch_mma<KV, 32>(pl, a);
    case 64: return launch_mma<KV, 64>(pl, a);
    case 128: return launch_mma<KV, 128>(pl, a);
    case 256: return launch_mma<KV, 256>(pl, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int f32_by_hd(int hd, const Plan& pl, const Call& a) {
  switch (hd) {
    case 32: return launch_f32<KV, 32>(pl, a);
    case 64: return launch_f32<KV, 64>(pl, a);
    case 128: return launch_f32<KV, 128>(pl, a);
    case 256: return launch_f32<KV, 256>(pl, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (n_rows, nq, hd) bf16 (path "mma") or f32 (path "f32"); k/v pages
// (N, p, nkv, hd) of kv kind (0 f32, 1 bf16: q's type; 2 int8, 3 e4m3 with
// k_scales / v_scales (N, p, nkv) f32); pos_pages (N, p), table (B, P),
// row_offsets (n_seg+1,), seg_slot (n_seg,), q_pos (n_rows,) int32; out
// (n_rows, nq, hd) of q's type; part_m / part_l (n_chunks, n_rows, nq) and
// part_acc (n_chunks, n_rows, nq, hd) f32 scratch when the mma plan merges
// chunks (else null). All contiguous; q, K and V at 16-byte aligned bases.
// The plan fields are kernels/ragged.py::ragged_attention_plan's.
extern "C" int repro_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* pos_pages, const void* table, const void* row_offsets,
    const void* seg_slot, const void* q_pos, void* out, void* part_m, void* part_l,
    void* part_acc, int n_rows, int nq, int nkv, int hd, int N, int p, int B, int P, int n_seg,
    int seg_cap, int q_dtype, int kv_kind, int path, int rows, int key_tile, int chunk,
    int n_chunks, int grid_x, int grid_y, int grid_z, int smem, float scale, int causal,
    int window, void* stream) {
  const Plan pl{path, rows, key_tile, chunk, n_chunks, grid_x, grid_y, grid_z, smem};
  const Call a{q, k_pages, v_pages, k_scales, v_scales, pos_pages, table, row_offsets, seg_slot,
               q_pos, out, part_m, part_l, part_acc, n_rows, nq, nkv, N, p, B, P, n_seg,
               seg_cap, scale, causal, window, static_cast<cudaStream_t>(stream)};
  if (nkv <= 0 || nq % nkv || n_seg < 1 || seg_cap < 1 || N < 1 || p < 1 || B < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == PATH_MMA && q_dtype == REPRO_BF16) {
    if (kv_kind == KV_BF16) return mma_by_hd<bf16>(hd, pl, a);
    if (kv_kind == KV_INT8) return mma_by_hd<int8_t>(hd, pl, a);
    if (kv_kind == KV_E4M3) return mma_by_hd<__nv_fp8_e4m3>(hd, pl, a);
  } else if (path == PATH_F32 && q_dtype == REPRO_F32) {
    if (kv_kind == KV_F32) return f32_by_hd<float>(hd, pl, a);
    if (kv_kind == KV_INT8) return f32_by_hd<int8_t>(hd, pl, a);
    if (kv_kind == KV_E4M3) return f32_by_hd<__nv_fp8_e4m3>(hd, pl, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
