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
// Design. One block of 4 warps per (row tile of BQ rows, q head, segment),
// plus one block row (segment index n_seg) that writes the zero rows; tiles
// past a segment's length return at once, so a decode segment costs one
// tile and the grid never gives a block all seg_cap rows. The tile's query
// rows sit in shared memory in f32. The slot's logical context (P*p keys)
// is walked in chunks of 32 keys, one key per lane, the chunks dealt to the
// warps in turn: each lane looks its key up through the page table, so any
// page size works and a slot's pages need not be contiguous or unshared
// (prefix pages are shared between slots, unmapped entries point at the
// NULL page). A chunk in which no (query, key) pair of the tile can be
// valid is skipped before its K/V are read; its softmax terms are all 0,
// so this is exact, and it skips the NULL pages past a sequence and the
// future half of a causal prefill. A lane scores its key against every row
// of the tile from registers (its K row read in 8-element vectors and
// widened), the warp reduces each row's max and sum, and every lane
// accumulates HD/32 output columns over the chunk's V rows. Each warp keeps
// its own online-softmax state for the tile's rows; at the end the 4 states
// are merged through shared memory, rescaled to the common maximum. Giving
// the warps different keys (not different rows) keeps all 4 busy on a
// one-row decode tile.
//
// Bound on the H100: bytes at decode (each page row of the slots is needed
// once; the kernel reads a kv head's page once per query head that maps to
// it and once per segment of the same slot, the repeats from L2), and
// operations for a long prefill segment (4 * valid pairs * hd per head).
// This first version computes on CUDA cores in f32: no tensor cores, no
// cp.async or TMA staging of the pages.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "narrow.cuh"

REPRO_ERROR_STRING

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's masked score
constexpr int NWARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

// narrow kv element kinds passed by the wrapper (0 and 1: wide pages, f32
// and bf16, of q's type)
constexpr int KV_INT8 = 2, KV_E4M3 = 3;

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
  __device__ static float round_p(float x) { return x; }
};
template <>
struct Kv<__nv_bfloat16> {
  static constexpr bool narrow = false;
  __device__ static void load8(const __nv_bfloat16* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(e[j]);
  }
  __device__ static float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  // p in the page type before p@V, as the Pallas kernel's p.astype(v.dtype)
  __device__ static float round_p(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
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
  __device__ static float round_p(float x) { return x; }  // p stays f32
};
template <>
struct Kv<int8_t> : KvNarrow<int8_t> {};
template <>
struct Kv<__nv_fp8_e4m3> : KvNarrow<__nv_fp8_e4m3> {};

template <typename T, typename KV, int HD, int BQ>
__global__ void __launch_bounds__(NWARPS * 32)
ragged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kpg,
                   const KV* __restrict__ vpg, const float* __restrict__ ksc,
                   const float* __restrict__ vsc, const int* __restrict__ pos_pages,
                   const int* __restrict__ table, const int* __restrict__ offs,
                   const int* __restrict__ seg_slot, const int* __restrict__ qpos,
                   T* __restrict__ out, int n_rows, int nq, int nkv, int N, int p, int B,
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
    const T zero = from_f32<T>(0.f);
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
          sc[r] = Kv<KV>::round_p(pr);
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
    const T o = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    out[((long long)(lo + r0 + r) * nq + h) * HD + d] = o;
    if (r0 + r == C - 1)  // rows of an over-long segment past seg_cap
      for (int t = lo + C; t < hi; ++t) out[((long long)t * nq + h) * HD + d] = o;
  }
}

template <typename T, typename KV, int HD>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* table, const void* offs, const void* slot,
           const void* qpos, void* out, int n_rows, int nq, int nkv, int N, int p, int B, int P,
           int n_seg, int C, float scale, int causal, int window, cudaStream_t st) {
  constexpr int BQ = HD >= 256 ? 8 : 16;  // bounds the acc registers per lane
  const size_t smem = (size_t)(BQ * HD + NWARPS * BQ * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ragged_attn_kernel<T, KV, HD, BQ>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((C + BQ - 1) / BQ, nq, n_seg + 1);
  ragged_attn_kernel<T, KV, HD, BQ><<<grid, NWARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const int*>(table),
      static_cast<const int*>(offs), static_cast<const int*>(slot),
      static_cast<const int*>(qpos), static_cast<T*>(out), n_rows, nq, nkv, N, p, B, P, n_seg,
      C, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* pos, const void* table, const void* offs,
                const void* slot, const void* qpos, void* out, int n_rows, int nq, int nkv, int N,
                int p, int B, int P, int n_seg, int C, float scale, int causal, int window,
                cudaStream_t st) {
#define REPRO_RAGGED_HD(H)                                                                 \
  case H:                                                                                  \
    return launch<T, KV, H>(q, k, v, ks, vs, pos, table, offs, slot, qpos, out, n_rows, nq, \
                            nkv, N, p, B, P, n_seg, C, scale, causal, window, st);
  switch (hd) {
    REPRO_RAGGED_HD(32)
    REPRO_RAGGED_HD(64)
    REPRO_RAGGED_HD(128)
    REPRO_RAGGED_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_RAGGED_HD
}

template <typename T>
int dispatch_kv(int kv, int hd, const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* pos, const void* table, const void* offs,
                const void* slot, const void* qpos, void* out, int n_rows, int nq, int nkv, int N,
                int p, int B, int P, int n_seg, int C, float scale, int causal, int window,
                cudaStream_t st) {
  switch (kv) {
    case KV_INT8:
      return dispatch_hd<T, int8_t>(hd, q, k, v, ks, vs, pos, table, offs, slot, qpos, out,
                                    n_rows, nq, nkv, N, p, B, P, n_seg, C, scale, causal,
                                    window, st);
    case KV_E4M3:
      return dispatch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, ks, vs, pos, table, offs, slot, qpos,
                                           out, n_rows, nq, nkv, N, p, B, P, n_seg, C, scale,
                                           causal, window, st);
    default:  // wide pages are q's type (the wrapper checks)
      return dispatch_hd<T, T>(hd, q, k, v, ks, vs, pos, table, offs, slot, qpos, out, n_rows,
                               nq, nkv, N, p, B, P, n_seg, C, scale, causal, window, st);
  }
}

}  // namespace

// q (n_rows, nq, hd) of q_dtype (REPRO_F32 / REPRO_BF16); k/v pages
// (N, p, nkv, hd) of kv kind (0 f32, 1 bf16: q's type; 2 int8, 3 e4m3 with
// k_scales / v_scales (N, p, nkv) f32); pos_pages (N, p), table (B, P),
// row_offsets (n_seg+1,), seg_slot (n_seg,), q_pos (n_rows,) int32;
// out (n_rows, nq, hd) of q's type. All contiguous.
extern "C" int repro_ragged_paged_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* k_scales,
                                            const void* v_scales, const void* pos_pages,
                                            const void* table, const void* row_offsets,
                                            const void* seg_slot, const void* q_pos, void* out,
                                            int n_rows, int nq, int nkv, int hd, int N, int p,
                                            int B, int P, int n_seg, int seg_cap, int q_dtype,
                                            int kv_kind, float scale, int causal, int window,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == REPRO_BF16)
    return dispatch_kv<__nv_bfloat16>(kv_kind, hd, q, k_pages, v_pages, k_scales, v_scales,
                                      pos_pages, table, row_offsets, seg_slot, q_pos, out, n_rows,
                                      nq, nkv, N, p, B, P, n_seg, seg_cap, scale, causal, window,
                                      st);
  return dispatch_kv<float>(kv_kind, hd, q, k_pages, v_pages, k_scales, v_scales, pos_pages,
                            table, row_offsets, seg_slot, q_pos, out, n_rows, nq, nkv, N, p, B, P,
                            n_seg, seg_cap, scale, causal, window, st);
}
