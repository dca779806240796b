// Mamba2 SSD intra-chunk quadratic on Hopper: bf16 inputs on tensor cores
// (mma.sync), f32 inputs on CUDA cores.
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
//   once and reuses it for each of its heads. kernels/ssd.py::ssd_plan
//   picks the path, G and the grid before launch; this file refuses a plan
//   it would not make.
// - The masked exponential. exp(l_i - l_j) is formed only for j <= i, by
//   selecting: above the diagonal l_i - l_j reaches hundreds at mamba2's
//   A and dt and the exponential is inf, and inf * 0 is NaN.
//
// Bound on the H100 at mamba2-1.3b's training shape (B=4, H=64, NC=16,
// Q=128, hd=64, ds=128, bf16 x/B/C): bytes. A call moves 344 MB, 268 MB of
// it the two f32 outputs: 0.103 ms at 3.35 TB/s, against 13.1 GFLOP (C.B^T
// and y over the lower triangle, inc in full), 0.013 ms at the bf16 tensor
// rate.
//
// The tensor-core path (bf16 x/B/C; Q <= 128 and hd, ds multiples of 16;
// 16-byte aligned rows): 16 warps, one block per SM (165 KB of shared memory
// at mamba2's shape), G heads per block.
// - C and B (Q x ds) arrive by cp.async; C.B^T is formed once on tensor
//   cores over the lower-triangle 16x16 tiles (bf16 products are exact, the
//   sums f32) and kept in shared memory in the mma accumulator layout, which
//   is also the A-operand layout of the product that uses it.
// - Per head, x (Q x hd, a strided view of the (B*S, H*hd) activations) is
//   loaded by cp.async one head ahead, double-buffered, with the head's
//   loglam and dt (one warp, stride H) in registers.
// - The operands that are f32 products are split into three bf16 terms
//   (hi, mid = bf16(v - hi), lo = bf16(v - hi - mid)): with the other
//   operand exact in bf16 every product is exact, and the split leaves
//   under 2^-27 of each value behind, below f32's own rounding. TF32 or one
//   bf16 term could not hold SSD_TOL (chip_smoke.py). x o w, w_j =
//   exp(l_{Q-1} - l_j) dt_j, is split by all threads into shared memory
//   (inc = (x o w)^T B); M_ij = C_i.B_j exp(l_i - l_j) dt_j is formed and
//   split by the warp that multiplies it, in registers, in the A-operand
//   layout, k-tile by k-tile (y = M x), the exponent selected to -inf above
//   the diagonal (no branch) and the k-tiles above the diagonal skipped.
// - The products run on mma.sync m16n8k16, three per product (lo, mid,
//   then hi, term by term over a task's tiles, so that no mma waits on the
//   one before), the next k-tile's fragments loading while one multiplies,
//   branch-free, in tasks (16
//   rows of y x 32 columns, 16 rows of inc x 64 columns) dealt to the warps
//   by the planner's longest-first schedule, so the 16 warps finish a head
//   together. Each thread stores its sums as float2: every 32-byte sector
//   of y and inc is written whole.
// - What holds it above the byte bound (PERF.md §6, PR 21): a head's prep
//   (the x o w split, the scan, three barriers) and the y warps' issue of
//   M's exponentials and splits.
//
// The CUDA-core path (f32 inputs, and bf16 shapes the tensor-core path does
// not take): f32 FMAs, the sums in f32. Each product is a small tiled loop
// over shared memory: a warp owns 8 output rows, lane l owns columns l,
// l+32, ..; per step of the reduction it reads its 8 row values as two
// broadcast float4 loads and one value per column, all without bank
// conflicts. In y's causal product a row block stops at its diagonal and
// the blocks are dealt to the warps in a snake order. Shared memory (f32),
// with Q8/hd8 = Q/hd rounded up to a multiple of 8:
//   phase 1: CBt (Q x Q8) | Bt (ds x Q8) | Ct (ds x Q8)
//   phase 2: CBt (Q x Q8) | B (Q x ds)   | Mt (Q x Q8), X (Q x hd8) | l, dt, w
// 230,912 bytes at Q=128, hd=64, ds=128: one block per SM, latency-bound.
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

// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 16;  // kernels/ssd.py: TC_WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 128;
constexpr int kMaxTasks = 128;  // kernels/ssd.py: TC_MAX_TASKS

// the warp of each task of a head (kernels/ssd.py::tc_schedule)
struct __align__(16) Sched {
  unsigned char owner[kMaxTasks];
};

// Byte offsets into dynamic shared memory (kernels/ssd.py::tc_smem_bytes).
// Rows of x and B are padded by 16 bytes, so the 8 rows an ldmatrix reads
// fall in 8 different 16-byte bank groups.
struct Layout {
  int rowX, rowB, nT;
  int sB, sCB, sX, sXw, sL, sDt, sW, sOwn, total;
};

__host__ __device__ inline Layout layout(int Q, int hd, int ds) {
  Layout L;
  L.rowX = 2 * hd + 16;
  L.rowB = 2 * ds + 16;
  const int QT = Q / 16;
  L.nT = QT * (QT + 1) / 2;  // lower-triangle 16x16 tiles of C.B^T
  int off = 0;
  L.sB = off;  // B (Q x ds) bf16
  off += Q * L.rowB;
  L.sCB = off;  // C.B^T tiles, f32, accumulator order: [tile][half][lane][4]
  off += L.nT * 1024;
  L.sX = off;  // x of two heads (Q x hd) bf16
  off += 2 * Q * L.rowX;
  L.sXw = off;  // x o w split into hi, mid, lo (3 x Q x hd) bf16; C (Q x ds) before it
  off += 3 * Q * L.rowX > Q * L.rowB ? 3 * Q * L.rowX : Q * L.rowB;
  L.sL = off;
  off += 4 * Q;
  L.sDt = off;
  off += 4 * Q;
  L.sW = off;
  off += 4 * Q;
  L.sOwn = off;
  off += kMaxTasks;
  L.total = off;
  return L;
}

__device__ __forceinline__ int tri(int m) { return m * (m + 1) / 2; }

// (row tile, column tile) of lower-triangle tile t
__device__ __forceinline__ void tile_of(int t, int& mi, int& kj) {
  mi = 0;
  while (tri(mi + 1) <= t) ++mi;
  kj = t - tri(mi);
}

// v = hi + mid + lo, each a bf16 (lo rounded): what the split leaves behind
// is under 2^-27 |v|
__device__ __forceinline__ void split3(float v, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - hi;  // exact
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;  // exact; rounded when packed
}

// v[8] (one thread's elements of a 16x16 A fragment, in register order)
// -> the three bf16 fragments hi, mid, lo
__device__ __forceinline__ void split_frag(const float* v, unsigned* h, unsigned* m,
                                           unsigned* l) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float h0, m0, l0, h1, m1, l1;
    split3(v[2 * r], h0, m0, l0);
    split3(v[2 * r + 1], h1, m1, l1);
    h[r] = pack_bf16(h0, h1);
    m[r] = pack_bf16(m0, m1);
    l[r] = pack_bf16(l0, l1);
  }
}

// rows x (cols 16-byte chunks) of a row-major bf16 tile, global -> shared
// (padded rows of `row` bytes), by all threads, asynchronously
__device__ __forceinline__ void load_tile(char* dst, int row, const __nv_bfloat16* src,
                                          long long ld, int rows, int chunks) {
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, k = e % chunks;
    cp_async16(dst + r * row + 16 * k, src + r * ld + 8 * k, true);
  }
}

// warp 0: a head's loglam and dt, lane l holding q = l*per .. l*per + per-1
__device__ __forceinline__ void load_ld(const float* llg, const float* dtg, long long sl,
                                        long long sd, int Q, float* ll, float* dd) {
  const int lane = threadIdx.x % 32, per = (Q + 31) / 32;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = lane * per + e;
    const bool in = e < per && q < Q;
    ll[e] = in ? __ldg(llg + q * sl) : 0.f;
    dd[e] = in ? __ldg(dtg + q * sd) : 0.f;
  }
}

// warp 0: l = inclusive cumsum of loglam (a lane's values in order, then a
// warp scan of the lanes' sums), dt, and w = exp(l_{Q-1} - l) dt into
// shared memory
__device__ __forceinline__ void scan_ld(const float* ll, const float* dd, int Q, float* sL,
                                        float* sDt, float* sW) {
  const int lane = threadIdx.x % 32, per = (Q + 31) / 32;
  float run[4], tot = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    tot += ll[e];
    run[e] = tot;
  }
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  const float excl = incl - tot;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = lane * per + e;
    if (e < per && q < Q) {
      sL[q] = excl + run[e];
      sDt[q] = dd[e];
    }
  }
  __syncwarp();
  const float lq = sL[Q - 1];
  for (int q = lane; q < Q; q += 32) sW[q] = expf(lq - sL[q]) * sDt[q];
}

// acc[n] += a (three bf16 terms) @ b for NP pairs of 8-column tiles, term by
// term (lo, mid, hi: the small ones first) over all tiles, so that 2 NP
// independent mma lie between two on one accumulator
template <int NP>
__device__ __forceinline__ void mma3(float (*acc)[4], unsigned (*a)[4], unsigned (*b)[4]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      mma_bf16_16816(acc[2 * p], a[s], b[p]);
      mma_bf16_16816(acc[2 * p + 1], a[s], b[p] + 2);
    }
}

// one thread's 2 NP accumulators -> float2 stores: rows r0 and r0 + 8 of
// `o` (row stride ld) at columns c0 + 8 n + 2 (lane % 4)
template <int NP>
__device__ __forceinline__ void store_acc(float* o, int ld, int r0, int c0, float (*acc)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(o + (r0 + g) * ld + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(o + (r0 + g + 8) * ld + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// What one thread needs of k-tile kj to form its A fragments of M (mi, kj):
// its 8 C.B^T values (accumulator order, which is the A-operand order) and
// l, dt of its 4 columns j0, j0 + 1, j0 + 8, j0 + 9 (j0 = 16 kj + 2 (lane % 4))
struct MTile {
  float4 cb[2];
  float2 l[2], dt[2];
};

// The A fragments (three bf16 terms) of M (mi, kj) = C.B^T o exp(l_i - l_j)
// o dt_j: element u sits at row i0 + 8 ((u >> 1) & 1), column j0 + (u & 1) +
// 8 (u >> 2). Above the diagonal the exponent is selected to -inf before the
// exponential (which gives 0, never inf), without a branch.
__device__ __forceinline__ void m_frags(const MTile& m, const float* li, int i0, int j0,
                                        unsigned (*f)[4]) {
  const float cv[8] = {m.cb[0].x, m.cb[0].y, m.cb[0].z, m.cb[0].w,
                       m.cb[1].x, m.cb[1].y, m.cb[1].z, m.cb[1].w};
  const float lj[4] = {m.l[0].x, m.l[0].y, m.l[1].x, m.l[1].y};
  const float dj[4] = {m.dt[0].x, m.dt[0].y, m.dt[1].x, m.dt[1].y};
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (u >> 1) & 1, c = (u & 1) + 2 * (u >> 2);
    const int j = j0 + (u & 1) + 8 * (u >> 2);
    const float e = j <= i0 + 8 * r ? li[r] - lj[c] : __int_as_float(0xff800000);  // -inf
    v[u] = (cv[u] * expf(e)) * dj[c];
  }
  split_frag(v, f[0], f[1], f[2]);
}

// y rows 16 mi.. x the 2 NP 8-column tiles from 32 nc: sum over the k-tiles
// kj <= mi of M (mi, kj) times x. A 2-stage pipeline without branches: while
// the mma of k-tile kj run, the warp forms M's fragments of kj + 1 and loads
// x's of kj + 1 and what M needs of kj + 2 (indices past mi clamped to it).
template <int NP>
__device__ __forceinline__ void y_task(const char* smem, const Layout& L, const char* sx,
                                       const float* sL, const float* sDt, int mi, int nc,
                                       float* yo, int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = 16 * mi + g;
  const float li[2] = {sL[i0], sL[i0 + 8]};
  const char* cbase = smem + L.sCB + tri(mi) * 1024 + lane * 16;
  auto load_m = [&](int kj, MTile& m) {
    const int j0 = 16 * kj + 2 * t;
    m.cb[0] = *reinterpret_cast<const float4*>(cbase + kj * 1024);
    m.cb[1] = *reinterpret_cast<const float4*>(cbase + kj * 1024 + 512);
    m.l[0] = *reinterpret_cast<const float2*>(sL + j0);
    m.l[1] = *reinterpret_cast<const float2*>(sL + j0 + 8);
    m.dt[0] = *reinterpret_cast<const float2*>(sDt + j0);
    m.dt[1] = *reinterpret_cast<const float2*>(sDt + j0 + 8);
  };
  auto load_b = [&](int kj, unsigned (*b)[4]) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldmatrix_x4_trans(b[p], sx + (16 * kj + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.rowX +
                                  2 * (32 * nc + 16 * p + (lane >> 4) * 8));
  };
  float acc[2 * NP][4] = {};
  MTile m;
  unsigned b[NP][4], f[3][4];
  load_m(0, m);
  load_b(0, b);
  m_frags(m, li, i0, 2 * t, f);
  load_m(min(1, mi), m);
  for (int kj = 0; kj <= mi; ++kj) {
    unsigned bk[NP][4], fk[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int p = 0; p < NP; ++p) bk[p][r] = b[p][r];
#pragma unroll
      for (int s = 0; s < 3; ++s) fk[s][r] = f[s][r];
    }
    const int k1 = min(kj + 1, mi);
    load_b(k1, b);
    mma3<NP>(acc, fk, bk);
    m_frags(m, li, i0, 16 * k1 + 2 * t, f);
    load_m(min(kj + 2, mi), m);
  }
  store_acc<NP>(yo, hd, 16 * mi, 32 * nc, acc);
}

// inc rows 16 dm.. (head dim) x the 2 NP 8-column tiles from 64 sc (state
// dim): sum over all QT k-tiles of (x o w)^T (three bf16 terms) times B; the
// next k-tile's fragments load while this one's mma run
template <int NP>
__device__ __forceinline__ void inc_task(const char* smem, const Layout& L, int QT, int Q,
                                         int dm, int sc, float* io, int ds) {
  const int lane = threadIdx.x % 32;
  const char* xw = smem + L.sXw + (16 * dm + ((lane >> 3) & 1) * 8) * 2;
  const char* sb = smem + L.sB + (64 * sc + (lane >> 4) * 8) * 2;
  auto load = [&](int kj, unsigned (*A)[4], unsigned (*b)[4]) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
      ldmatrix_x4_trans(A[s], xw + s * Q * L.rowX +
                                  (16 * kj + (lane >> 4) * 8 + (lane & 7)) * L.rowX);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldmatrix_x4_trans(b[p], sb + (16 * kj + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.rowB +
                                  32 * p);
  };
  float acc[2 * NP][4] = {};
  unsigned A[3][4], b[NP][4];
  load(0, A, b);
  for (int kj = 0; kj < QT; ++kj) {
    unsigned Ak[3][4], bk[NP][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int s = 0; s < 3; ++s) Ak[s][r] = A[s][r];
#pragma unroll
      for (int p = 0; p < NP; ++p) bk[p][r] = b[p][r];
    }
    load(min(kj + 1, QT - 1), A, b);
    mma3<NP>(acc, Ak, bk);
  }
  store_acc<NP>(io, ds, 16 * dm, 64 * sc, acc);
}

// Grid (B * NC, ceil(H / G)): block (bc, hg) computes chunk c of batch b
// for heads hg*G .. hg*G+G-1.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_intra_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ loglam,
                        const float* __restrict__ dt, const __nv_bfloat16* __restrict__ bm,
                        const __nv_bfloat16* __restrict__ cm, float* __restrict__ y,
                        float* __restrict__ inc, Strides st, int H, int NC, int Q, int hd,
                        int ds, int G, Sched sched) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(Q, hd, ds);
  const int b = blockIdx.x / NC, c = blockIdx.x % NC;
  const int h0 = blockIdx.y * G, h1 = min(H, h0 + G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int QT = Q / 16, nYc = (hd + 31) / 32, nSc = (ds + 63) / 64;
  const int nY = QT * nYc, nTasks = nY + (hd / 16) * nSc;
  float* sL = reinterpret_cast<float*>(smem + L.sL);
  float* sDt = reinterpret_cast<float*>(smem + L.sDt);
  float* sW = reinterpret_cast<float*>(smem + L.sW);
  unsigned char* own = reinterpret_cast<unsigned char*>(smem + L.sOwn);
#pragma unroll
  for (int i = 0; i < kMaxTasks / 16; ++i)
    if (tid == i)
      reinterpret_cast<uint4*>(own)[i] = reinterpret_cast<const uint4*>(sched.owner)[i];

  // C and B, then the first head's x, by cp.async; its loglam and dt
  load_tile(smem + L.sXw, L.rowB, cm + b * st.cm[0] + c * st.cm[1], st.cm[2], Q, ds / 8);
  load_tile(smem + L.sB, L.rowB, bm + b * st.bm[0] + c * st.bm[1], st.bm[2], Q, ds / 8);
  cp_async_commit();
  const __nv_bfloat16* xg = x + b * st.x[0] + c * st.x[2];
  load_tile(smem + L.sX, L.rowX, xg + h0 * st.x[1], st.x[3], Q, hd / 8);
  cp_async_commit();
  const float* llg = loglam + b * st.ll[0] + c * st.ll[2];
  const float* dtg = dt + b * st.dt[0] + c * st.dt[2];
  float ll[4], dd[4];
  if (warp == 0) load_ld(llg + h0 * st.ll[1], dtg + h0 * st.dt[1], st.ll[3], st.dt[3], Q, ll, dd);
  cp_async_wait<1>();
  __syncthreads();

  // C.B^T over the lower-triangle tiles, once for the block's heads
  for (int t = warp; t < L.nT; t += kWarps) {
    int mi, kj;
    tile_of(t, mi, kj);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < ds / 16; ++ks) {
      unsigned a[4], bb[4];
      ldmatrix_x4(a, smem + L.sXw + (16 * mi + (lane & 15)) * L.rowB +
                         2 * (16 * ks + (lane >> 4) * 8));
      ldmatrix_x4(bb, smem + L.sB + (16 * kj + (lane >> 4) * 8 + (lane & 7)) * L.rowB +
                          2 * (16 * ks + ((lane >> 3) & 1) * 8));
      mma_bf16_16816(acc[0], a, bb);
      mma_bf16_16816(acc[1], a, bb + 2);
    }
    char* dst = smem + L.sCB + t * 1024 + lane * 16;  // [tile][half][lane][4]
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    *reinterpret_cast<float4*>(dst + 512) =
        make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  __syncthreads();  // C (under x o w) is dead from here

  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const char* sx = smem + L.sX + buf * Q * L.rowX;
    if (warp == 0) {
      scan_ld(ll, dd, Q, sL, sDt, sW);
      if (h + 1 < h1)
        load_ld(llg + (h + 1) * st.ll[1], dtg + (h + 1) * st.dt[1], st.ll[3], st.dt[3], Q, ll, dd);
    }
    if (h + 1 < h1) {  // the other buffer's head finished before the last barrier
      load_tile(smem + L.sX + (buf ^ 1) * Q * L.rowX, L.rowX, xg + (h + 1) * st.x[1], st.x[3], Q,
                hd / 8);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x of head h, l, dt, w

    // x o w, split, for inc's A operand
    const int xc = hd / 8;
    for (int e = tid; e < Q * xc; e += kThreads) {
      const int j = e / xc, k = e % xc;
      const uint4 raw = *reinterpret_cast<const uint4*>(sx + j * L.rowX + 16 * k);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float w = sW[j];
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(xv[u]) * w;
      unsigned hv[4], mv[4], lv[4];
      split_frag(v, hv, mv, lv);
      char* dst = smem + L.sXw + j * L.rowX + 16 * k;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(dst + Q * L.rowX) = make_uint4(mv[0], mv[1], mv[2], mv[3]);
      *reinterpret_cast<uint4*>(dst + 2 * Q * L.rowX) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    __syncthreads();

    const long long bhc = ((long long)b * H + h) * NC + c;
    for (int task = 0; task < nTasks; ++task) {
      if (own[task] != warp) continue;
      if (task < nY) {  // 32 columns of y (16 at the edge of an hd of 16 (2k+1))
        const int mi = task / nYc, nc = task % nYc;
        if (hd - 32 * nc >= 32)
          y_task<2>(smem, L, sx, sL, sDt, mi, nc, y + bhc * Q * hd, hd);
        else
          y_task<1>(smem, L, sx, sL, sDt, mi, nc, y + bhc * Q * hd, hd);
      } else {
        const int u = task - nY, dm = u / nSc, sc = u % nSc;
        float* io = inc + bhc * hd * ds;
        switch (min(4, (ds - 64 * sc) / 16)) {  // 64 columns of inc, fewer at ds's edge
          case 4: inc_task<4>(smem, L, QT, Q, dm, sc, io, ds); break;
          case 3: inc_task<3>(smem, L, QT, Q, dm, sc, io, ds); break;
          case 2: inc_task<2>(smem, L, QT, Q, dm, sc, io, ds); break;
          default: inc_task<1>(smem, L, QT, Q, dm, sc, io, ds);
        }
      }
    }
    __syncthreads();  // before the next head overwrites x o w, l, dt, w
  }
}

}  // namespace tc

// The shared-memory plan above, in bytes (kernels/ssd.py::smem_bytes).
size_t smem_bytes(int Q, int hd, int ds) {
  const long long Q8 = round8(Q), hd8 = round8(hd);
  const long long r2 = (long long)ds * Q8 > Q * Q8 + Q * hd8 ? (long long)ds * Q8
                                                              : Q * Q8 + Q * hd8;
  return sizeof(float) * (size_t)(Q * Q8 + Q8 * ds + r2 + 3 * Q8);
}

}  // namespace

// strides: 18 int64 element strides, in the order of Strides' fields.
// dtype: REPRO_F32 or REPRO_BF16, of x, Bm and Cm alike. path: 0 CUDA cores,
// 1 tensor cores (bf16 only), with `sched` the warp of each of n_tasks tasks
// and `smem` the bytes of shared memory (kernels/ssd.py::ssd_plan). A plan
// this file would not run is refused: a tensor-core plan for f32, a Q over
// 128 or not a multiple of 16, an hd or ds not a multiple of 16, a base or
// row stride off 16 bytes, a task count, owner or shared-memory size other
// than its own.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* loglam, const void* dt,
                                     const void* bm, const void* cm, void* y, void* inc,
                                     const long long* strides, int B, int H, int NC, int Q,
                                     int hd, int ds, int G, int dtype, int path,
                                     const unsigned char* sched, int n_tasks, long long smem,
                                     cudaStream_t stream) {
  Strides st;
  long long* dst = &st.x[0];
  for (int i = 0; i < 18; ++i) dst[i] = strides[i];
  if (B * NC == 0 || H == 0) return cudaSuccess;
  if (G < 1 || Q < 1 || hd < 1 || ds < 1) return cudaErrorInvalidValue;
  if (path == 0) {
    if (smem != (long long)smem_bytes(Q, hd, ds)) return cudaErrorInvalidValue;
    if (dtype == REPRO_F32)
      return launch<float>(x, loglam, dt, bm, cm, y, inc, st, B, H, NC, Q, hd, ds, G, smem,
                           stream);
    if (dtype == REPRO_BF16)
      return launch<__nv_bfloat16>(x, loglam, dt, bm, cm, y, inc, st, B, H, NC, Q, hd, ds, G,
                                   smem, stream);
    return cudaErrorInvalidValue;
  }
  if (path != 1 || dtype != REPRO_BF16 || Q % 16 || Q > tc::kMaxQ || hd % 16 || ds % 16)
    return cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                          reinterpret_cast<uintptr_t>(cm);
  const long long rows = st.x[0] | st.x[1] | st.x[2] | st.x[3] | st.bm[0] | st.bm[1] |
                         st.bm[2] | st.cm[0] | st.cm[1] | st.cm[2];
  if (bases % 16 || rows % 8) return cudaErrorInvalidValue;
  const tc::Layout L = tc::layout(Q, hd, ds);
  const int want = (Q / 16) * ((hd + 31) / 32) + (hd / 16) * ((ds + 63) / 64);
  if (smem != L.total || n_tasks != want || n_tasks > tc::kMaxTasks) return cudaErrorInvalidValue;
  tc::Sched sc = {};
  for (int i = 0; i < n_tasks; ++i) {
    if (sched[i] >= tc::kWarps) return cudaErrorInvalidValue;
    sc.owner[i] = sched[i];
  }
  cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_intra_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  dim3 grid(B * NC, (H + G - 1) / G);
  tc::ssd_intra_tc_kernel<<<grid, tc::kThreads, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(loglam),
      static_cast<const float*>(dt), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<float*>(y), static_cast<float*>(inc),
      st, H, NC, Q, hd, ds, G, sc);
  return cudaGetLastError();
}
