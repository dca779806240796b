// Building blocks shared by the fused routed-block kernels
// (routed_attention.cu, routed_mlp.cu) and the SwiGLU MLP (swiglu.cu): a
// tiled GEMM with fused epilogues, an RMSNorm over rows (optionally
// gathered by index), and the rounding and activation helpers that put the
// working-type roundings where the JAX mirrors put them.
//
// GEMM: C[M, N] = A[M, K] @ B[K, N], A and B row-major in the working type
// T (f32 or bf16), the sum in f32 on CUDA cores. A block of 256 threads
// owns a 64 x 64 tile of C and walks K in steps of 16, staging both tiles
// in shared memory as f32 (A transposed, padded by one float against bank
// conflicts); each thread accumulates a 4 x 4 sub-tile. With two B matrices
// (the GLU case) the block keeps two accumulators and reads A once. Every
// edge is masked, so M, N and K need not divide the tile. Products are
// computed here, never by a library: this is the simple, correct first
// version (no tensor cores, no TMA); it is bound by shared-memory traffic
// and the FMA rate, far from the card's bf16 tensor-core peak.
#pragma once

#include <math.h>

#include "common.cuh"

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
// The same GEMM for bf16 on tensor cores (used by swiglu.cu): C = A @ B (and
// A @ B1) with A (M, K) and B (K, N) row-major bf16, K and N multiples of 8,
// both bases 16-byte aligned; the sums are f32 (mma.sync m16n8k16, bf16
// products exact in f32). A block of 8 warps owns a 128 x 128 tile of C and
// walks K in steps of 32 through a 3-stage cp.async ring in shared memory
// (rows padded by 16 bytes so ldmatrix reads hit 32 distinct banks); each
// warp owns 64 x 32 of the tile, 4 x 4 mma tiles (twice with two B
// matrices). Out-of-range rows and columns load as zeros and are not
// stored. Same epilogue interface as gemm_kernel. No wgmma or TMA: that is
// later work.
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_STAGES = 3, TC_THREADS = 256;
constexpr int TC_ALD = TC_BK + 8;  // shared row strides, in elements
constexpr int TC_BLD = TC_BN + 8;

template <int NB>
constexpr size_t tc_smem_bytes() {
  return (size_t)TC_STAGES * (TC_BM * TC_ALD + NB * TC_BK * TC_BLD) * sizeof(__nv_bfloat16);
}

template <int NB, class Epi>
__global__ void __launch_bounds__(TC_THREADS)
gemm_bf16_tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B0,
                    const __nv_bfloat16* __restrict__ B1, int M, int N, int K, Epi epi) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [stage][BM][ALD]
  __nv_bfloat16* sB = sA + TC_STAGES * TC_BM * TC_ALD;             // [stage][NB][BK][BLD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int ktiles = (K + TC_BK - 1) / TC_BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
    __nv_bfloat16* a = sA + stage * TC_BM * TC_ALD;
    for (int c = tid; c < TC_BM * TC_BK / 8; c += TC_THREADS) {
      const int r = c / (TC_BK / 8), kc = (c % (TC_BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;  // K % 8 == 0: a chunk is all in or all out
      cp_async16(a + r * TC_ALD + kc, ok ? A + (long long)(m0 + r) * K + k0 + kc : A, ok);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const __nv_bfloat16* Bg = b == 0 ? B0 : B1;
      __nv_bfloat16* bs = sB + (stage * NB + b) * TC_BK * TC_BLD;
      for (int c = tid; c < TC_BK * TC_BN / 8; c += TC_THREADS) {
        const int r = c / (TC_BN / 8), nc = (c % (TC_BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + nc < N;
        cp_async16(bs + r * TC_BLD + nc, ok ? Bg + (long long)(k0 + r) * N + n0 + nc : Bg, ok);
      }
    }
  };

  float acc[NB][4][4][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TC_STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // and every warp is done with tile kt - 1
    if (kt + TC_STAGES - 1 < ktiles) load((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    cp_async_commit();
    const int stage = kt % TC_STAGES;
    const __nv_bfloat16* a = sA + stage * TC_BM * TC_ALD;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a + (wm * 64 + mt * 16 + (lane & 15)) * TC_ALD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const __nv_bfloat16* bs = sB + (stage * NB + b) * TC_BK * TC_BLD;
        unsigned bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix
          unsigned t[4];
          ldmatrix_x4_trans(t, bs + (kk + (lane & 15)) * TC_BLD + wn * 32 + np * 16 +
                                   (lane >> 4) * 8);
          bf[2 * np][0] = t[0];
          bf[2 * np][1] = t[1];
          bf[2 * np + 1][0] = t[2];
          bf[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[b][mt][nt], af[mt], bf[nt]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 64 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (r < M && c < N) epi(r, c, acc[0][mt][nt][e], acc[NB - 1][mt][nt][e]);
      }
}

// whether gemm_bf16_tc takes these operands
inline bool tc_ok(const void* A, const void* B0, const void* B1, int N, int K) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B0) |
                      reinterpret_cast<uintptr_t>(B1);
  return N % 8 == 0 && K % 8 == 0 && a % 16 == 0;
}

template <int NB, class Epi>
cudaError_t gemm_bf16_tc(const __nv_bfloat16* A, const __nv_bfloat16* B0,
                         const __nv_bfloat16* B1, int M, int N, int K, Epi epi, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(gemm_bf16_tc_kernel<NB, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)tc_smem_bytes<NB>());
  if (err != cudaSuccess) return err;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  gemm_bf16_tc_kernel<NB, Epi><<<grid, TC_THREADS, tc_smem_bytes<NB>(), st>>>(A, B0, B1, M, N,
                                                                               K, epi);
  return cudaGetLastError();
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
