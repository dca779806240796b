// MoD routed dispatch on Hopper: row gather and gated scatter-add, the two
// data-movement halves of paper Eq. 1.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/routing.py:
//   gather_rows      (_gather_call / _gather_kernel)
//   scatter_add_rows (_scatter_call / _scatter_kernel)
// and, called with B = 1 on a flat (T, D) token stream, those of
// src/repro/kernels/ragged.py:
//   ragged_gather_rows      (_ragged_gather_kernel)
//   ragged_scatter_add_rows (_ragged_scatter_kernel)
// whose -1 selections (segments shorter than their capacity) are the
// out-of-range indices below: a zero row in the gather, dropped in the
// scatter. Indices are int64 (padded dispatch) or int32 (flat stream).
// Precondition: the in-range indices of a batch row are unique, as top-k
// selections are (duplicates leave the scatter's result undefined).
//
// The TPU versions express the row permutation as a one-hot f32 matmul per
// S-block so the inner loop is MXU work. With unique indices each output
// row receives exactly one term, so that matmul is a copy; here it is
// written as one, bit-exact by construction.
//
// Bound on the H100: bytes (3.35 TB/s); one f32 multiply and one add per
// routed element are not worth counting. The functions need
//   gather:      2*B*k*D*es + idx bytes        (k rows in, k rows out)
//   scatter-add: 2*B*S*D*es + B*k*D*es + idx + gate bytes (x in, out, delta)
//   zero target: B*S*D*es + B*k*D*es + idx bytes           (out, delta)
//
// Both are planned in kernels/routing.py::dispatch_plan before launch: the
// vector width (the widest that divides the row bytes and every base:
// 16/4/1 bytes for the gather, a byte copy; 16/4/2 for the scatter, whose
// vectors hold whole elements), the threads and vectors a thread, 64-bit
// vector indices past 2^32 - 1 (the scatter) and the grid. The entry points
// refuse any other plan.
//
// gather: one block per output row b*k + i (grid x = i, z = b) and chunk
// (grid y) of 2 * threads vectors of it, threads the fewest multiple of 32
// that covers the row in two vectors a thread, at most 256. The block reads
// its one index once (so an index outside [0, S) zeroes the whole block's
// vectors), and each thread loads its two vectors before it stores. So
// B=1, k=128 rows of 1792 bf16 are 128 blocks of 128 threads. On an H100
// the flat grid the page gather runs (one vector a thread over the output,
// its row found by a division) was slower at every main-path shape, most
// at B=4 S=2048 and on the flat stream (PERF.md §6).
//
// scatter-add: one pass, one launch. Block x covers FLAT_THREADS * U
// consecutive vectors of the output (B, S, D), and each is written once:
//   x                                              row s of batch b unrouted,
//   from_f32(__fadd_rn(f32(x), f32(from_f32(__fmul_rn(gate[b,i], f32(delta[b,i])))))
//                                                  where idx[b, i] == s,
// the gate product rounded to x's type before the add, as the TPU kernel's
// x + cast(gate * delta) (no FMA contraction). To find i without a second
// pass, each block first issues its x loads, then turns the one-hot of the
// TPU kernel into a lookup: it reads its batch rows' k indices once (from
// L2) and builds an inverse map slot[s] = i (or -1) in shared memory for the
// rows its vectors cover. A thread then loads delta (and the gate) for its
// routed vectors only, computes and stores. Small blocks win although each
// rereads the indices (L2 hits): on an H100 one vector a thread (at B=1
// S=1000 D=1792 bf16, 875 blocks whose index reads are ~25% of the bytes
// they move) was faster at every main-path shape than the larger blocks
// that keep those reads under 2% (PERF.md §6). The zero target, whose
// map is not hidden behind x loads, takes 2 a thread once the output has
// more vectors than the card holds threads. Its row and batch are found
// by multiplies (flat.cuh's FastDiv), not divisions.
//
// zero target: the same kernel with no x to read (gather's backward: dx is
// zeros with rows g at idx). Unrouted rows are +0; a routed row is
// 0 + cast(1 * g) through the same f32 add, so the sign of a zero result is
// that of the zeros-then-scatter it replaces, and no B*S*D zero tensor is
// written and copied first.
#include "common.cuh"
#include "flat.cuh"

REPRO_ERROR_STRING

namespace {

// vectors a thread (kernels/routing.py: GATHER_UNROLL, SCATTER_UNROLL): the
// gather takes GATHER_UNROLL, the scatter 1 or SCATTER_UNROLL
constexpr int GATHER_UNROLL = 2;
constexpr int SCATTER_UNROLL = 2;

// out row b*k + i (blockIdx.z = b, blockIdx.x = i), vectors
// blockIdx.y * GATHER_UNROLL * blockDim.x + u * blockDim.x + threadIdx.x of
// its vpr: those of x row b*S + idx[b, i], or zeros for an index outside
// [0, S).
template <int VEC, typename Idx>
__global__ void __launch_bounds__(FLAT_THREADS)
gather_rows_kernel(const char* __restrict__ x, const Idx* __restrict__ idx,
                   char* __restrict__ out, int S, int k, unsigned vpr) {
  typedef typename Vec<VEC>::type V;
  const long long row = (long long)blockIdx.z * k + blockIdx.x;
  const long long s = (long long)__ldg(idx + row);
  const bool hit = s >= 0 && s < S;
  const V* src = reinterpret_cast<const V*>(x) + ((long long)blockIdx.z * S + (hit ? s : 0)) * vpr;
  V* dst = reinterpret_cast<V*>(out) + row * vpr;
  const unsigned c0 = blockIdx.y * GATHER_UNROLL * blockDim.x + threadIdx.x;
  V r[GATHER_UNROLL];
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const unsigned c = c0 + u * blockDim.x;
    r[u] = V{};
    if (hit && c < vpr) r[u] = __ldg(src + c);
  }
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const unsigned c = c0 + u * blockDim.x;
    if (c < vpr) dst[c] = r[u];
  }
}

// the raw bits of an element type, to and from f32
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  typedef uint32_t type;
  static __device__ __forceinline__ float f32(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t of(float v) { return __float_as_uint(v); }
};
template <>
struct Bits<__nv_bfloat16> {
  typedef unsigned short type;
  static __device__ __forceinline__ float f32(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ unsigned short of(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// x + cast(g * f32(delta)) element by element over one vector (x = +0 for
// the zero target). __fmul_rn / __fadd_rn: no contraction into an FMA, so
// f32 rounds the product before the add, as the reference does.
template <typename T, int VEC, bool ZERO>
__device__ __forceinline__ typename Vec<VEC>::type gated_add(typename Vec<VEC>::type xv,
                                                              typename Vec<VEC>::type dv,
                                                              float g) {
  typedef Bits<T> B;
  typedef typename B::type E;
  constexpr int N = VEC / sizeof(E);
  static_assert(N >= 1 && VEC % sizeof(E) == 0, "a vector holds whole elements");
  E xe[N], de[N], oe[N];
  memcpy(xe, &xv, VEC);
  memcpy(de, &dv, VEC);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float upd = B::f32(B::of(__fmul_rn(g, B::f32(de[j]))));
    oe[j] = B::of(__fadd_rn(ZERO ? 0.0f : B::f32(xe[j]), upd));
  }
  typename Vec<VEC>::type o;
  memcpy(&o, oe, VEC);
  return o;
}

// out vector v (of n_vec = B*S*vpr) of row r = v / vpr (batch r / S,
// position r % S): x's vector, or the gated update where a selection i of
// that batch row addresses the position. Block x covers FLAT_THREADS * U
// consecutive vectors, rows r0..r1; slot (dynamic shared memory, one int
// per row) maps each to its selection or -1. gate == nullptr: a unit gate.
template <typename T, int VEC, typename Idx, typename I, int U, bool ZERO>
__global__ void __launch_bounds__(FLAT_THREADS)
scatter_add_rows_kernel(const char* __restrict__ x, const Idx* __restrict__ idx,
                        const char* __restrict__ delta, const float* __restrict__ gate,
                        char* __restrict__ out, FastDiv S, I k, FastDiv vpr, I n_vec) {
  typedef typename Vec<VEC>::type V;
  extern __shared__ int slot[];
  const V* xs = reinterpret_cast<const V*>(x);
  const V* ds = reinterpret_cast<const V*>(delta);
  V* dst = reinterpret_cast<V*>(out);
  const I first = (I)blockIdx.x * (FLAT_THREADS * U);
  const I end = n_vec - first < (I)(FLAT_THREADS * U) ? n_vec : first + (I)(FLAT_THREADS * U);
  const I r0 = vpr(first), r1 = vpr(end - 1);
  const I v0 = first + threadIdx.x;
  V r[U];
  if (!ZERO) {  // x's loads go out first and overlap the map's construction
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const I v = v0 + (I)(u * FLAT_THREADS);
      if (v < n_vec) r[u] = __ldg(xs + v);
    }
  }
  for (I j = threadIdx.x; j <= r1 - r0; j += FLAT_THREADS) slot[j] = -1;
  __syncthreads();
  for (I b = S(r0); b <= S(r1); ++b) {
    const Idx* ib = idx + (unsigned long long)b * k;
    for (I i = threadIdx.x; i < k; i += FLAT_THREADS) {
      const long long s = (long long)__ldg(ib + i);
      if (s >= 0 && s < (long long)S.d) {
        const I row = b * S.d + (I)s;
        if (row >= r0 && row <= r1) slot[row - r0] = (int)i;
      }
    }
  }
  __syncthreads();
  V d[U];
  float g[U];
  int sel[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * FLAT_THREADS);
    sel[u] = -1;
    if (v < n_vec) {
      const I row = vpr(v);
      sel[u] = slot[row - r0];
      if (sel[u] >= 0) {
        const unsigned long long di = (unsigned long long)S(row) * k + sel[u];
        d[u] = __ldg(ds + di * vpr.d + (v - row * vpr.d));
        g[u] = gate ? __ldg(gate + di) : 1.0f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * FLAT_THREADS);
    if (v < n_vec) {
      if (sel[u] >= 0)
        r[u] = gated_add<T, VEC, ZERO>(ZERO ? V{} : r[u], d[u], g[u]);
      else if (ZERO)
        r[u] = V{};
      dst[v] = r[u];
    }
  }
}

template <int VEC, typename Idx>
cudaError_t launch_gather(const void* x, const void* idx, void* out, int B, int S, int k,
                          unsigned vpr, int threads, int chunks, cudaStream_t st) {
  gather_rows_kernel<VEC, Idx><<<dim3(k, chunks, B), threads, 0, st>>>(
      static_cast<const char*>(x), static_cast<const Idx*>(idx), static_cast<char*>(out), S, k,
      vpr);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t gather_vec(int idx_bytes, const void* x, const void* idx, void* out, int B, int S,
                       int k, unsigned vpr, int threads, int chunks, cudaStream_t st) {
  if (idx_bytes == 4)
    return launch_gather<VEC, int>(x, idx, out, B, S, k, vpr, threads, chunks, st);
  return launch_gather<VEC, long long>(x, idx, out, B, S, k, vpr, threads, chunks, st);
}

// the rows a block of per_block vectors spans at most: the slot map's size
inline long long map_rows(long long per_block, long long vpr) {
  return (per_block - 1) / vpr + 2;
}

struct ScatterArgs {
  const void* x;
  const void* idx;
  const void* delta;
  const float* gate;
  void* out;
  long long S, k, vpr, n_vec, blocks;
  cudaStream_t st;
};

template <typename T, int VEC, typename Idx, int U, bool ZERO>
cudaError_t launch_scatter(const ScatterArgs& a, int wide) {
  const char* xp = static_cast<const char*>(a.x);
  const Idx* ip = static_cast<const Idx*>(a.idx);
  const char* dp = static_cast<const char*>(a.delta);
  char* op = static_cast<char*>(a.out);
  const FastDiv sd((unsigned)a.S), vd((unsigned)a.vpr);
  const size_t smem = sizeof(int) * map_rows(FLAT_THREADS * U, a.vpr);
  if (wide)
    scatter_add_rows_kernel<T, VEC, Idx, unsigned long long, U, ZERO>
        <<<(unsigned)a.blocks, FLAT_THREADS, smem, a.st>>>(xp, ip, dp, a.gate, op, sd, a.k, vd,
                                                           a.n_vec);
  else
    scatter_add_rows_kernel<T, VEC, Idx, unsigned, U, ZERO>
        <<<(unsigned)a.blocks, FLAT_THREADS, smem, a.st>>>(xp, ip, dp, a.gate, op, sd,
                                                           (unsigned)a.k, vd, (unsigned)a.n_vec);
  return cudaGetLastError();
}

template <typename T, int VEC, typename Idx, bool ZERO>
cudaError_t scatter_u(int unroll, const ScatterArgs& a, int wide) {
  if (unroll == SCATTER_UNROLL) return launch_scatter<T, VEC, Idx, SCATTER_UNROLL, ZERO>(a, wide);
  return launch_scatter<T, VEC, Idx, 1, ZERO>(a, wide);
}

template <typename T, int VEC>
cudaError_t scatter_vec(int idx_bytes, int unroll, const ScatterArgs& a, int wide) {
  const bool zero = a.x == nullptr;
  if (idx_bytes == 4)
    return zero ? scatter_u<T, VEC, int, true>(unroll, a, wide)
                : scatter_u<T, VEC, int, false>(unroll, a, wide);
  return zero ? scatter_u<T, VEC, long long, true>(unroll, a, wide)
              : scatter_u<T, VEC, long long, false>(unroll, a, wide);
}

}  // namespace

// out (B, k, row_bytes) = x (B, S, row_bytes) rows idx (B, k) by the plan of
// kernels/routing.py::dispatch_plan("gather", ...): vec bytes per vector
// (16, 4 or 1, dividing the row and both bases), idx_bytes 8 (int64) or 4
// (int32), blocks of `threads` (the fewest multiple of 32 that covers a row
// in GATHER_UNROLL vectors a thread, at most FLAT_THREADS) on a grid of
// (k, chunks, B), chunks covering a row. Any other plan is refused.
extern "C" int repro_gather_rows(const void* x, const void* idx, void* out, int B, int S, int k,
                                 long long row_bytes, int idx_bytes, int vec, int threads,
                                 int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if ((vec != 16 && vec != 4 && vec != 1) || row_bytes <= 0 || row_bytes % vec || bases % vec ||
      row_bytes / vec > UINT_MAX || B < 1 || B > 65535 || S < 1 || k < 1 ||
      (idx_bytes != 4 && idx_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vpr = row_bytes / vec;
  const long long half = (vpr + GATHER_UNROLL - 1) / GATHER_UNROLL;
  const long long want = half >= FLAT_THREADS ? FLAT_THREADS : (half + 31) / 32 * 32;
  if (threads != want || chunks != (vpr + GATHER_UNROLL * want - 1) / (GATHER_UNROLL * want) ||
      chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned v = (unsigned)vpr;
  switch (vec) {
    case 16: return static_cast<int>(gather_vec<16>(idx_bytes, x, idx, out, B, S, k, v, threads,
                                                    chunks, st));
    case 4: return static_cast<int>(gather_vec<4>(idx_bytes, x, idx, out, B, S, k, v, threads,
                                                  chunks, st));
    default: return static_cast<int>(gather_vec<1>(idx_bytes, x, idx, out, B, S, k, v, threads,
                                                   chunks, st));
  }
}

// out (B, S, D) = x with row idx[b, i] of batch b replaced by
// x + cast(gate[b, i] * delta[b, i]), in one launch, by the plan of
// kernels/routing.py::dispatch_plan("scatter" / "scatter_zero", ...). x ==
// nullptr: the zero target (x read as +0); gate == nullptr: a unit gate.
// vec: 16, 4 or (bf16) 2 bytes, dividing the row and every base; unroll 1
// or SCATTER_UNROLL; idx_bytes 8 or 4. Any other plan is refused.
extern "C" int repro_scatter_add_rows(const void* x, const void* idx, const void* delta,
                                      const void* gate, void* out, int B, int S, int k, int D,
                                      int dtype, int idx_bytes, int vec, int unroll, int wide,
                                      long long blocks, void* stream) {
  const int es = dtype == REPRO_BF16 ? 2 : 4;
  const long long row_bytes = (long long)D * es;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(delta) |
                          reinterpret_cast<uintptr_t>(out);
  if ((dtype != REPRO_BF16 && dtype != REPRO_F32) || (vec != 16 && vec != 4 && vec != es) ||
      D < 1 || row_bytes % vec || bases % vec || B < 1 || S < 1 || k < 1 ||
      (idx_bytes != 4 && idx_bytes != 8) || (unroll != 1 && unroll != SCATTER_UNROLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vpr = row_bytes / vec, n_vec = (long long)B * S * vpr;
  if (!flat_grid_ok(n_vec, unroll, blocks, wide)) return static_cast<int>(cudaErrorInvalidValue);
  const ScatterArgs a{x, idx, delta, static_cast<const float*>(gate), out, S, k, vpr, n_vec,
                      blocks, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    switch (vec) {
      case 16: err = scatter_vec<__nv_bfloat16, 16>(idx_bytes, unroll, a, wide); break;
      case 4: err = scatter_vec<__nv_bfloat16, 4>(idx_bytes, unroll, a, wide); break;
      default: err = scatter_vec<__nv_bfloat16, 2>(idx_bytes, unroll, a, wide); break;
    }
  } else {
    err = vec == 16 ? scatter_vec<float, 16>(idx_bytes, unroll, a, wide)
                    : scatter_vec<float, 4>(idx_bytes, unroll, a, wide);
  }
  return static_cast<int>(err);
}
