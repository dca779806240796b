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
// f32, p is cast to V's type before p@V, and a query row with no valid key
// comes out as 0. The layout is the JAX package's (no transposes): the
// kernel computes its own offsets. Unlike the Pallas kernel, Sq and Skv
// need not divide the tile sizes: ragged edges are masked here.
//
// Design: one block of 4 warps per (q-tile of 16 rows, head, batch row);
// the 16 query rows sit in shared memory in f32, and a loop walks K/V in
// tiles of 32 keys staged in shared memory (K rows padded by one float so
// 32 lanes reading 32 keys hit 32 banks). Each warp owns 4 query rows; for
// a row, lane j scores key j of the tile, the warp reduces the tile's max
// and sum, and every lane accumulates head_dim/32 output columns. A tile
// in which no (query, key) pair of the block can be valid is skipped
// before its K/V are loaded, which is exact (its softmax terms are all 0)
// and halves the work of a causal prefill.
//
// Bound on the H100 at the serving shapes: bytes for decode (Sq = 1: each
// block streams one kv head's whole cache for one query row), operations
// for long prefill (Sq = Skv = 2048: 4*Sq*Skv*hd per head, half of it
// masked). This first version keeps all math in CUDA cores (no wgmma, no
// TMA, no split-KV for decode); those are for a later change.
#include <limits.h>
#include <math.h>

#include "common.cuh"

REPRO_ERROR_STRING

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's masked score
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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int nq, int nkv,
                 float scale, int causal, int window) {
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
    sQ[e] = s < Sq ? to_f32(q[(((long long)b * Sq + s) * nq + h) * HD + d]) : 0.f;
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
          kv = to_f32(k[off]);
          vv = to_f32(v[off]);
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
        const float pc = round_to<T>(p);  // p in V's type, as before p@V on the TPU
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pc, j);
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
    T* orow = out + (((long long)b * Sq + s) * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = from_f32<T>(acc[rr][i] / lf);
    if (lse != nullptr && lane == 0)  // a row with no valid key: m is -inf or NEG_INF
      lse[((long long)b * nq + h) * Sq + s] = (m[rr] > NEG_INF / 2 ? m[rr] : 0.f) + logf(lf);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, float* lse, int B, int Sq, int Skv, int nq, int nkv, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * HD + BKV * (HD + 1) + BKV * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((Sq + BQ - 1) / BQ, nq, B);
  flash_fwd_kernel<T, HD><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos,
      kpos, static_cast<T*>(out), lse, Sq, Skv, nq, nkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* out, float* lse, int B, int Sq, int Skv, int nq, int nkv,
                float scale, int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv, scale, causal,
                           window, st);
    case 64:
      return launch<T, 64>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv, scale, causal,
                           window, st);
    case 128:
      return launch<T, 128>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv, scale, causal,
                            window, st);
    case 256:
      return launch<T, 256>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, nq, nkv, scale, causal,
                            window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, void* lse,
                                     int B, int Sq, int Skv, int nq, int nkv, int hd, int dtype,
                                     float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  if (dtype == REPRO_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale,
                                      causal, window, st);
  return dispatch_hd<float>(hd, q, k, v, qp, kp, out, ls, B, Sq, Skv, nq, nkv, scale, causal,
                            window, st);
}
