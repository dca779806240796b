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
//   2. q, k, v projections, the tiled CUDA-core GEMM of gemm.cuh;
//   3. RoPE in place, one thread per rotated pair, with the plain
//      version's frequency table passed in (no powf drift);
//   4. attention: one block of 4 warps per (16 query rows, head, batch
//      row), K/V staged 32 keys at a time in shared memory, lane j scoring
//      key j; three passes over the keys (row max, sum of exp, then p@V
//      with p = T(exp(s - max) / sum)) give the dense softmax's values
//      rather than an online rescaling;
//   5. out-projection with the residual add as its epilogue.
//
// Bound on the H100 at the 1b training shape (B=4, S=2048, k=256, D=1792,
// 14x128 heads): operations. 4 projections of (1024 x 1792) by (1792 x
// 1792) are 26 GFLOP, attention 4 GFLOP, against under 30 MB of bytes.
// This first version runs all of it on CUDA cores in f32, so it is far
// above that bound; tensor cores (mma.sync / wgmma) are later work.
#include <math.h>

#include "gemm.cuh"

REPRO_ERROR_STRING

namespace {

using fused::rnd;

constexpr float NEG_INF = -1e30f;  // masked score, as the mirror's where()
constexpr int BQ = 16;             // query rows per block
constexpr int BKV = 32;            // keys per tile (one per lane)
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

// rotate-half RoPE in place on t (rows, heads, hd):
//   out1 = x1*cos - x2*sin, out2 = x1*sin + x2*cos, angle = pos * freq[i]
template <typename T>
__global__ void rope_kernel(T* __restrict__ t, const int* __restrict__ pos,
                            const float* __restrict__ freqs, int rows, int heads, int hd,
                            int clamp) {
  const int half = hd / 2;
  const long long n = (long long)rows * heads * half;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(e % half);
    const long long rh = e / half;  // row * heads + head
    const int r = (int)(rh / heads);
    int p = pos[r];
    if (clamp && p < 0) p = 0;
    const float ang = __fmul_rn((float)p, freqs[i]);
    const float c = cosf(ang), s = sinf(ang);
    T* base = t + rh * hd;
    const float x1 = to_f32(base[i]), x2 = to_f32(base[i + half]);
    base[i] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    base[i + half] = from_f32<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
  }
}

// Attention over the k routed rows of one batch row. q: (B*k, nq, HD),
// kk/vv: (B*k, nkv, HD), pos: (B, k), o: (B*k, nq, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(NWARPS * 32)
routed_attn_kernel(const T* __restrict__ q, const T* __restrict__ kk, const T* __restrict__ vv,
                   const int* __restrict__ pos, T* __restrict__ o, int k, int nq, int nkv,
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
  const long long row0 = (long long)b * k;  // first routed row of this batch row

  for (int e = tid; e < BQ * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sQ[e] = s < k ? to_f32(q[((row0 + s) * nq + h) * HD + d]) : 0.f;
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
          kv = to_f32(kk[off]);
          if (pass == 2) vx = to_f32(vv[off]);
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
          s = valid ? __fmul_rn(rnd<T>(dot), scale) : NEG_INF;
        }
        if (pass == 0) {
          m[rr] = fmaxf(m[rr], warp_max(s));
        } else if (pass == 1) {
          l[rr] += warp_sum(expf(s - m[rr]));
        } else {
          const float p = rnd<T>(__fdiv_rn(expf(s - m[rr]), l[rr]));
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
    T* orow = o + ((row0 + s) * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = from_f32<T>(acc[rr][i]);
  }
}

template <typename T, int HD>
cudaError_t attend(const T* q, const T* kk, const T* vv, const int* pos, T* o, int B, int k,
                   int nq, int nkv, float scale, int causal, int window, cudaStream_t st) {
  const size_t smem = (size_t)(BQ * HD + BKV * (HD + 1) + BKV * HD) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((k + BQ - 1) / BQ, nq, B);
  routed_attn_kernel<T, HD><<<grid, NWARPS * 32, smem, st>>>(q, kk, vv, pos, o, k, nq, nkv,
                                                               scale, causal, window);
  return cudaGetLastError();
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
cudaError_t rope(T* t, const int* pos, const float* freqs, int rows, int heads, int hd,
                 int clamp, cudaStream_t st) {
  const long long n = (long long)rows * heads * (hd / 2);
  long long blocks = (n + 255) / 256;
  if (blocks > 65535) blocks = 65535;
  rope_kernel<T><<<(int)blocks, 256, 0, st>>>(t, pos, freqs, rows, heads, hd, clamp);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x_, const void* idx_, const void* pos_, const void* ln_, const void* wq_,
        const void* wk_, const void* wv_, const void* wo_, const void* bq_, const void* bk_,
        const void* bv_, const void* freqs_, void* xs_, void* hn_, void* q_, void* k_, void* v_,
        void* o_, void* a_, void* h_, int B, int S, int k, int D, int nq, int nkv, int hd,
        float eps, float scale, int causal, int window, int use_rope, cudaStream_t st) {
  using fused::EpiResid;
  using fused::EpiStore;
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
  FUSED_TRY((fused::gemm<T, 1>(hn, static_cast<const T*>(wq_), nullptr, M, Nq, D,
                               EpiStore<T>{q, static_cast<const T*>(bq_), Nq}, st)));
  FUSED_TRY((fused::gemm<T, 1>(hn, static_cast<const T*>(wk_), nullptr, M, Nkv, D,
                               EpiStore<T>{kk, static_cast<const T*>(bk_), Nkv}, st)));
  FUSED_TRY((fused::gemm<T, 1>(hn, static_cast<const T*>(wv_), nullptr, M, Nkv, D,
                               EpiStore<T>{vv, static_cast<const T*>(bv_), Nkv}, st)));
  if (use_rope) {
    const float* freqs = static_cast<const float*>(freqs_);
    FUSED_TRY(rope<T>(q, pos, freqs, M, nq, hd, 0, st));
    FUSED_TRY(rope<T>(kk, pos, freqs, M, nkv, hd, 1, st));
  }
  FUSED_TRY(attend_hd<T>(hd, q, kk, vv, pos, o, B, k, nq, nkv, scale, causal, window, st));
  FUSED_TRY((fused::gemm<T, 1>(o, static_cast<const T*>(wo_), nullptr, M, D, Nq,
                               EpiResid<T>{static_cast<T*>(a_), static_cast<T*>(h_), xs, D},
                               st)));
  return 0;
}

}  // namespace

extern "C" int repro_routed_attention(
    const void* x, const void* idx, const void* pos, const void* ln, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bq, const void* bk,
    const void* bv, const void* freqs, void* xs, void* hn, void* q, void* k_, void* v, void* o,
    void* a, void* h, int B, int S, int k, int D, int nq, int nkv, int hd, int dtype, float eps,
    float scale, int causal, int window, int use_rope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return run<__nv_bfloat16>(x, idx, pos, ln, wq, wk, wv, wo, bq, bk, bv, freqs, xs, hn, q, k_,
                              v, o, a, h, B, S, k, D, nq, nkv, hd, eps, scale, causal, window,
                              use_rope, st);
  return run<float>(x, idx, pos, ln, wq, wk, wv, wo, bq, bk, bv, freqs, xs, hn, q, k_, v, o, a, h,
                    B, S, k, D, nq, nkv, hd, eps, scale, causal, window, use_rope, st);
}
