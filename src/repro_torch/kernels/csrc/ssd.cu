// Mamba2 SSD intra-chunk quadratic on Hopper (f32 on CUDA cores).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd.py
// (ssd_intra_chunk / _ssd_kernel). Per (batch b, head h, chunk c), with
// l = cumsum(loglam) inside the chunk:
//
//   y_intra[i, :] = sum_{j <= i} C_i.B_j * exp(l_i - l_j) * dt_j * x[j, :]
//   inc[:, :]     = sum_j exp(l_{Q-1} - l_j) * dt_j * x[j, :] B_j^T
//
// What differs from the TPU kernel, and why:
// - Blocking. The Pallas grid is (B, H, NC) and recomputes the (Q, Q) tile
//   C.B^T for every head, although B and C have no head axis (ngroups = 1).
//   Here a block owns one (b, c) and a group of G heads: it computes C.B^T
//   once into shared memory and reuses it for each of its heads. G is
//   chosen by the wrapper so that B*NC*ceil(H/G) blocks fill the card.
// - The masked exponential. exp(l_i - l_j) is formed only for j <= i, by
//   selecting: above the diagonal l_i - l_j reaches hundreds at mamba2's
//   A and dt and the exponential is inf, and inf * 0 is NaN.
// - Arithmetic. f32 FMAs on CUDA cores, the sums in f32, outputs f32. Each
//   product is a small tiled loop over shared memory: a warp owns 8 output
//   rows, lane l owns columns l, l+32, ..; per step of the reduction it
//   reads its 8 row values as two broadcast float4 loads and one value
//   per column, all without bank conflicts. In y's causal product a row
//   block stops at its diagonal and the blocks are dealt to the warps in a
//   snake order, so every warp does the same amount of work.
//
// Bound on the H100: operations. At mamba2-1.3b's training shape
// (B=4, H=64, NC=16, Q=128, hd=64, ds=128, bf16 inputs) a call moves 344 MB
// (the two f32 outputs are 268 MB of it) and needs 13.1 GFLOP (C.B^T and y
// over the lower triangle, inc in full) once C.B^T is shared: 0.19 ms at
// the f32 CUDA-core peak against 0.10 ms of device-memory time. Tensor
// cores (TF32 or bf16 inputs with f32 sums) and TMA loads are later work.
//
// Shared memory (f32), with Q8/hd8 = Q/hd rounded up to a multiple of 8:
//   phase 1: CBt (Q x Q8) | Bt (ds x Q8) | Ct (ds x Q8)
//   phase 2: CBt (Q x Q8) | B (Q x ds)   | Mt (Q x Q8), X (Q x hd8) | l, dt, w
// 230,912 bytes at Q=128, hd=64, ds=128: one block per SM.
#include "common.cuh"

REPRO_ERROR_STRING

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

struct Strides {
  long long x[4];   // b, h, c, q (the head-dim axis is contiguous)
  long long ll[4];  // loglam: b, h, c, q
  long long dt[4];  // dt: b, h, c, q
  long long bm[3];  // Bm: b, c, q (the state axis is contiguous)
  long long cm[3];  // Cm: b, c, q
};

// out[r * ors + c] = sum_{k < kend} ks[k] * A[k * lda + r] * Bk[k * ldb + c]
// for r < R, c < C. A is k-major with lda a multiple of 8 and rows padded
// up to it, so a warp's 8 rows are two aligned float4 loads; ks is a
// per-k scale of A (nullptr: none), applied as the f32 product ks*A before
// the FMA. causal: row block rb reduces over k < 8*rb + 8 only (A is zero
// above its diagonal there).
template <int NC>
__device__ void smem_gemm(const float* __restrict__ A, int lda, const float* __restrict__ Bk,
                          int ldb, const float* __restrict__ ks, int R, int C, int K,
                          bool causal, float* __restrict__ out, int ors) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrb = (R + 7) / 8;
  const int ncb = (C + 32 * NC - 1) / (32 * NC);
  const int ntask = nrb * ncb;
  for (int it = 0; it * kWarps < ntask; ++it) {
    const int slot = it * kWarps + ((it & 1) ? kWarps - 1 - warp : warp);
    if (slot >= ntask) continue;
    const int rb = slot / ncb, cb = slot % ncb;
    const int r0 = rb * 8;
    const int c0 = cb * 32 * NC + lane;
    const int kend = causal ? min(K, r0 + 8) : K;
    float acc[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kend; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + (long long)k * lda + r0);
      const float4 a1 = *reinterpret_cast<const float4*>(A + (long long)k * lda + r0 + 4);
      float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      if (ks != nullptr) {
        const float s = ks[k];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = s * a[i];
      }
      float b[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = c0 + 32 * j;
        b[j] = c < C ? Bk[(long long)k * ldb + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      if (r >= R) break;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = c0 + 32 * j;
        if (c < C) out[(long long)r * ors + c] = acc[i][j];
      }
    }
  }
}

// Columns per lane from the output width: 32, 64 or up to 128 per warp.
__device__ void gemm(const float* A, int lda, const float* Bk, int ldb, const float* ks, int R,
                     int C, int K, bool causal, float* out, int ors) {
  if (C <= 32) {
    smem_gemm<1>(A, lda, Bk, ldb, ks, R, C, K, causal, out, ors);
  } else if (C <= 64) {
    smem_gemm<2>(A, lda, Bk, ldb, ks, R, C, K, causal, out, ors);
  } else {
    smem_gemm<4>(A, lda, Bk, ldb, ks, R, C, K, causal, out, ors);
  }
}

// Grid (B * NC, ceil(H / G)): block (bc, hg) computes chunk c of batch b
// for heads hg*G .. hg*G+G-1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ loglam,
                     const float* __restrict__ dt, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ y, float* __restrict__ inc,
                     Strides st, int H, int NC, int Q, int hd, int ds, int G) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q8 = round8(Q), hd8 = round8(hd);
  const int b = blockIdx.x / NC, c = blockIdx.x % NC;
  const int h0 = blockIdx.y * G, h1 = min(H, h0 + G);
  const int tid = threadIdx.x;

  float* sCBt = smem;                      // [j][i]
  float* sB = sCBt + (long long)Q * Q8;    // phase 1: Bt [s][j]; phase 2: B [j][s]
  float* sR2 = sB + (long long)Q8 * ds;    // phase 1: Ct [s][i]; phase 2: Mt, X
  float* sMt = sR2;                        // [j][i]
  float* sX = sR2 + (long long)Q * Q8;     // [j][d]
  float* sL = sR2 + max((long long)ds * Q8, (long long)Q * Q8 + (long long)Q * hd8);
  float* sDt = sL + Q8;
  float* sW = sDt + Q8;

  // ---- phase 1: CBt[j][i] = B_j . C_i, once for the block's heads ----
  const T* bg = bm + b * st.bm[0] + c * st.bm[1];
  const T* cg = cm + b * st.cm[0] + c * st.cm[1];
  for (int e = tid; e < ds * Q8; e += kThreads) {
    const int s = e / Q8, j = e % Q8;
    const bool in = j < Q;
    sB[e] = in ? to_f32(bg[j * st.bm[2] + s]) : 0.f;
    sR2[e] = in ? to_f32(cg[j * st.cm[2] + s]) : 0.f;
  }
  __syncthreads();
  gemm(sB, Q8, sR2, Q8, nullptr, Q, Q, ds, false, sCBt, Q8);
  __syncthreads();
  for (int e = tid; e < Q * ds; e += kThreads) {
    const int j = e / ds, s = e % ds;
    sB[e] = to_f32(bg[j * st.bm[2] + s]);
  }

  // ---- phase 2: per head ----
  for (int h = h0; h < h1; ++h) {
    const T* xg = x + b * st.x[0] + h * st.x[1] + c * st.x[2];
    for (int e = tid; e < Q * hd8; e += kThreads) {
      const int j = e / hd8, d = e % hd8;
      sX[e] = d < hd ? to_f32(xg[j * st.x[3] + d]) : 0.f;
    }
    const float* llg = loglam + b * st.ll[0] + h * st.ll[1] + c * st.ll[2];
    const float* dtg = dt + b * st.dt[0] + h * st.dt[1] + c * st.dt[2];
    for (int j = tid; j < Q; j += kThreads) {
      sL[j] = llg[j * st.ll[3]];
      sDt[j] = dtg[j * st.dt[3]];
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of the log-decay, in order
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += sL[j];
        sL[j] = run;
      }
    }
    __syncthreads();
    const float lq = sL[Q - 1];
    for (int j = tid; j < Q; j += kThreads) sW[j] = expf(lq - sL[j]) * sDt[j];
    // Mt[j][i] = C_i.B_j * exp(l_i - l_j) * dt_j, j <= i; the exponential
    // is never evaluated above the diagonal
    for (int e = tid; e < Q * Q8; e += kThreads) {
      const int j = e / Q8, i = e % Q8;
      float m = 0.f;
      if (j <= i && i < Q) m = (sCBt[e] * expf(sL[i] - sL[j])) * sDt[j];
      sMt[e] = m;
    }
    __syncthreads();
    const long long bhc = ((long long)b * H + h) * NC + c;
    gemm(sMt, Q8, sX, hd8, nullptr, Q, hd, Q, true, y + bhc * Q * hd, hd);
    gemm(sX, hd8, sB, ds, sW, hd, ds, Q, false, inc + bhc * hd * ds, ds);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* loglam, const void* dt, const void* bm,
                   const void* cm, void* y, void* inc, const Strides& st, int B, int H, int NC,
                   int Q, int hd, int ds, int G, size_t smem, cudaStream_t stream) {
  auto kern = ssd_intra_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * NC, (H + G - 1) / G);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(loglam),
      static_cast<const float*>(dt), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(y), static_cast<float*>(inc), st, H, NC, Q, hd, ds, G);
  return cudaGetLastError();
}

// The shared-memory plan above, in bytes (kernels/ssd.py::smem_bytes).
size_t smem_bytes(int Q, int hd, int ds) {
  const long long Q8 = round8(Q), hd8 = round8(hd);
  const long long r2 = (long long)ds * Q8 > Q * Q8 + Q * hd8 ? (long long)ds * Q8
                                                              : Q * Q8 + Q * hd8;
  return sizeof(float) * (size_t)(Q * Q8 + Q8 * ds + r2 + 3 * Q8);
}

}  // namespace

// strides: 18 int64 element strides, in the order of Strides' fields.
// dtype: REPRO_F32 or REPRO_BF16, of x, Bm and Cm alike.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* loglam, const void* dt,
                                     const void* bm, const void* cm, void* y, void* inc,
                                     const long long* strides, int B, int H, int NC, int Q,
                                     int hd, int ds, int G, int dtype, cudaStream_t stream) {
  Strides st;
  long long* dst = &st.x[0];
  for (int i = 0; i < 18; ++i) dst[i] = strides[i];
  const size_t smem = smem_bytes(Q, hd, ds);
  if (B * NC == 0 || H == 0) return cudaSuccess;
  if (G < 1 || Q < 1 || hd < 1 || ds < 1) return cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return launch<float>(x, loglam, dt, bm, cm, y, inc, st, B, H, NC, Q, hd, ds, G, smem,
                         stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, loglam, dt, bm, cm, y, inc, st, B, H, NC, Q, hd, ds, G,
                                 smem, stream);
  return cudaErrorInvalidValue;
}
