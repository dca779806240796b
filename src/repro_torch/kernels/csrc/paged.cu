// Block-paged KV pool on Hopper: the page gather that materializes each
// slot's logical cache, the in-place decode-row scatter, and the ragged
// write-back of a mixed prefill+decode step.
//
// Replaces the Pallas TPU kernels of
//   src/repro/kernels/paged.py   paged_gather_pallas        (_gather_kernel)
//                                paged_scatter_rows_pallas  (_scatter_kernel)
//   src/repro/kernels/ragged.py  ragged_paged_scatter_rows_pallas (_ragged_ps_kernel)
// Canonical layout as there: pages (N, p, F), one row = F elements.
//
// All three are pure data movement, so each is a byte copy that ignores the
// element type: one kernel serves bf16/f32 K/V rows and the int32 position
// ring. Bound on the H100: bytes (3.35 TB/s). The gather reads and writes
// every mapped page once; the scatters touch only the rows they write.
//
// The gather runs one flat grid over the output's vectors of VEC bytes
// (16, 4 or 1: the widest that divides the page bytes and the page
// tensor's base; kernels/paged.py::gather_plan chooses it, the block shape,
// the index width and the grid before launch, and this file refuses a plan
// it cannot run). Block x covers 256 threads x unroll consecutive vectors, and
// each thread looks up the page id of each of its vectors and issues all
// their loads before its stores. So the work spreads evenly whatever the
// table's shape: a chunked prefill's (1, 62) table of 57 KB pages is 868
// blocks of one vector a thread (one block per logical page gave 62 blocks
// for 132 SMs), a decode step's (8, 62) 1736 blocks of four, and a
// position leaf's 64-byte pages share 8 blocks instead of taking one each.
//
// Both scatters run the same kind of flat grid over their rows' vectors
// (scatter_rows_kernel; kernels/ragged.py::scatter_plan and kernels/
// paged.py::scatter_rows_plan: width, unroll, index width and grid, refused
// here if they do not fit), and differ only in a target functor: each
// thread looks up its row's clamped page row, from precomputed (page id,
// offset) pairs for the ragged write-back, from the slot's position and
// page table for the decode-row scatter. A position leaf's W=7432 rows of
// 4 bytes are then 30 blocks of 256 threads, not 7432 blocks of one busy
// thread each; a decode step's B=8 rows of 4 bytes are one block whose 8
// busy threads each load pos, then the table entry, then store: a launch
// and a chain of three dependent memory accesses, whatever the grid.
//
// The TPU scatters stream every physical page through VMEM because a Pallas
// output does not alias its input. The function the engine needs is "the
// pool with these rows replaced", so here the scatters write the rows in
// place into the page tensor and leave every other page untouched. Rows
// routed to the scratch page (free slots, invalid ragged rows) may collide
// there; that page is garbage by contract and never read.
//
// Indices are clamped into range (page ids to [0, N), positions to
// [0, P*p), offsets to [0, p)), as the plain PyTorch versions beside the
// wrappers do, so no input can address memory outside the tensors.
//
// The quantized pool's gather (paged_gather_dequant, replacing
// src/repro/kernels/paged.py paged_gather_dequant_pallas /
// _gather_dequant_kernel) widens narrow pages on the way out:
//   out[b, i*p + r, f] = float(pages[t, r, f]) * scales[t, r, f / (F/G)],
//   t = clamp(table[b, i]),
// an f32 product rounded once to the output type (f32 or bf16). Bound:
// bytes, 1 narrow byte + 1 scale per F/G elements in, 2 or 4 bytes out.
// Each thread owns one 16-byte vector of narrow bytes (16 elements, one
// scale when a scale block is a multiple of 16 elements, as a head_dim is),
// so a (1, 62)-table gather of 1792-wide rows still spreads over ~430
// blocks instead of the one-block-per-logical-page of paged_gather.
// Widening int8 and e4m3 to f32 is exact; the multiply by a power-of-two
// scale is exact unless it leaves the normal range, and is the same IEEE
// product as the plain version's.

#include "common.cuh"
#include "flat.cuh"
#include "narrow.cuh"

REPRO_ERROR_STRING

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the gather's block: GATHER_THREADS threads with 1 or GATHER_UNROLL vectors
// each (kernels/paged.py: GATHER_THREADS, GATHER_UNROLL)
constexpr int GATHER_THREADS = FLAT_THREADS;
constexpr int GATHER_UNROLL = 4;

// out vector v (of n_vec, vpp per logical page) = vector v % vpp of page
// table[v / vpp] (the table flattened (B*P)). Block x covers
// GATHER_THREADS * U consecutive vectors; each thread loads its U (the page
// id of each looked up) before it stores any. I: 32- or 64-bit indices.
template <int VEC, typename I, int U>
__global__ void __launch_bounds__(GATHER_THREADS)
paged_gather_kernel(const char* __restrict__ pages, const int* __restrict__ table,
                    char* __restrict__ out, int N, I vpp, I n_vec) {
  typedef typename Vec<VEC>::type V;
  const V* src = reinterpret_cast<const V*>(pages);
  V* dst = reinterpret_cast<V*>(out);
  const I v0 = (I)blockIdx.x * (GATHER_THREADS * U) + threadIdx.x;
  V r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * GATHER_THREADS);
    if (v < n_vec) {
      const I lp = v / vpp;
      const int pid = clampi(__ldg(table + lp), 0, N - 1);
      r[u] = __ldg(src + (unsigned long long)pid * vpp + (v - lp * vpp));
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * GATHER_THREADS);
    if (v < n_vec) dst[v] = r[u];
  }
}

template <int VEC, int U>
cudaError_t launch_gather(const void* pages, const void* table, void* out, int N,
                          long long vpp, long long n_vec, long long blocks, int wide,
                          cudaStream_t st) {
  const char* pg = static_cast<const char*>(pages);
  const int* tb = static_cast<const int*>(table);
  char* o = static_cast<char*>(out);
  if (wide)
    paged_gather_kernel<VEC, unsigned long long, U><<<(unsigned)blocks, GATHER_THREADS, 0, st>>>(
        pg, tb, o, N, (unsigned long long)vpp, (unsigned long long)n_vec);
  else
    paged_gather_kernel<VEC, unsigned, U><<<(unsigned)blocks, GATHER_THREADS, 0, st>>>(
        pg, tb, o, N, (unsigned)vpp, (unsigned)n_vec);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_gather_u(int unroll, const void* pages, const void* table, void* out, int N,
                            long long vpp, long long n_vec, long long blocks, int wide,
                            cudaStream_t st) {
  if (unroll == GATHER_UNROLL)
    return launch_gather<VEC, GATHER_UNROLL>(pages, table, out, N, vpp, n_vec, blocks, wide, st);
  return launch_gather<VEC, 1>(pages, table, out, N, vpp, n_vec, blocks, wide, st);
}

// The decode-row scatter's target of write row w (slot w): page row
// clamp(table[w, t / p]) * p + t % p, t = clamp(pos[w], 0, P*p - 1).
struct PagedTarget {
  const int* table;
  const int* pos;
  int N, P, p;
  __device__ __forceinline__ long long operator()(long long w) const {
    const int t = clampi(__ldg(pos + w), 0, P * p - 1);
    return (long long)clampi(__ldg(table + w * P + t / p), 0, N - 1) * p + t % p;
  }
};

// The ragged write-back's target of write row w: page row
// clamp(pid[w]) * p + clamp(off[w]).
struct RaggedTarget {
  const int* pid;
  const int* off;
  int N, p;
  __device__ __forceinline__ long long operator()(long long w) const {
    return (long long)clampi(__ldg(pid + w), 0, N - 1) * p + clampi(__ldg(off + w), 0, p - 1);
  }
};

// Rows scattered into page rows over one flat grid of VEC-byte vectors:
// vector v (of n_vec, vpr per row) of rows goes to vector v % vpr of page
// row target(v / vpr). Block x covers GATHER_THREADS * U consecutive
// vectors; each thread loads its U (with their targets) before it stores
// any. I: 32- or 64-bit vector indices. The target functor is the only
// part that knows the kind of scatter.
template <int VEC, typename I, int U, class Target>
__global__ void __launch_bounds__(GATHER_THREADS)
scatter_rows_kernel(char* __restrict__ pages, const char* __restrict__ rows, Target target,
                    I vpr, I n_vec) {
  typedef typename Vec<VEC>::type V;
  const V* src = reinterpret_cast<const V*>(rows);
  V* dst = reinterpret_cast<V*>(pages);
  const I v0 = (I)blockIdx.x * (GATHER_THREADS * U) + threadIdx.x;
  V r[U];
  unsigned long long d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * GATHER_THREADS);
    if (v < n_vec) {
      const I w = v / vpr;
      d[u] = (unsigned long long)target(w) * vpr + (v - w * vpr);
      r[u] = __ldg(src + v);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I v = v0 + (I)(u * GATHER_THREADS);
    if (v < n_vec) dst[d[u]] = r[u];
  }
}

template <int VEC, int U, class Target>
cudaError_t launch_scatter(void* pages, const void* rows, Target target, long long vpr,
                           long long n_vec, long long blocks, int wide, cudaStream_t st) {
  char* pg = static_cast<char*>(pages);
  const char* rw = static_cast<const char*>(rows);
  if (wide)
    scatter_rows_kernel<VEC, unsigned long long, U><<<(unsigned)blocks, GATHER_THREADS, 0, st>>>(
        pg, rw, target, (unsigned long long)vpr, (unsigned long long)n_vec);
  else
    scatter_rows_kernel<VEC, unsigned, U><<<(unsigned)blocks, GATHER_THREADS, 0, st>>>(
        pg, rw, target, (unsigned)vpr, (unsigned)n_vec);
  return cudaGetLastError();
}

template <int VEC, class Target>
cudaError_t launch_scatter_u(int unroll, void* pages, const void* rows, Target target,
                             long long vpr, long long n_vec, long long blocks, int wide,
                             cudaStream_t st) {
  if (unroll == GATHER_UNROLL)
    return launch_scatter<VEC, GATHER_UNROLL>(pages, rows, target, vpr, n_vec, blocks, wide, st);
  return launch_scatter<VEC, 1>(pages, rows, target, vpr, n_vec, blocks, wide, st);
}

// 16 f32 values to 16 consecutive outputs (16-byte aligned)
__device__ __forceinline__ void store16(float* o, const float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<float4*>(o)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* o, const float* v) {
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])) << 16);
  reinterpret_cast<uint4*>(o)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(o)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One thread per 16 narrow elements of an output row, grid-stride. ``vec``:
// F and F/G multiples of 16 and both bases 16-byte aligned; otherwise each
// thread takes single elements (odd widths).
template <typename Q, typename O>
__global__ void paged_gather_dequant_kernel(const unsigned char* __restrict__ pages,
                                            const float* __restrict__ scales,
                                            const int* __restrict__ table,
                                            O* __restrict__ out, int N, int p, int F, int G,
                                            long long sstride, long long n_rows, bool vec) {
  const int gs = F / G;  // elements per scale
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const int nv = F / 16;
    for (long long v = t0; v < n_rows * nv; v += stride) {
      const long long row = v / nv;  // (b*P + i)*p + r
      const int c = (int)(v % nv) * 16;
      const long long src = (long long)clampi(table[row / p], 0, N - 1) * p + (int)(row % p);
      const float sc = scales[src * sstride + c / gs];
      const uint4 raw = *reinterpret_cast<const uint4*>(pages + src * F + c);
      const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&raw);
      float vals[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) vals[j] = __fmul_rn(widen<Q>(bytes[j]), sc);
      store16(out + row * F + c, vals);
    }
  } else {
    for (long long e = t0; e < n_rows * F; e += stride) {
      const long long row = e / F;
      const int f = (int)(e % F);
      const long long src = (long long)clampi(table[row / p], 0, N - 1) * p + (int)(row % p);
      const float v = __fmul_rn(widen<Q>(pages[src * F + f]), scales[src * sstride + f / gs]);
      out[e] = from_f32<O>(v);
    }
  }
}

template <typename Q, typename O>
int launch_dequant(const void* pages, const void* scales, const void* table, void* out, int N,
                   int B, int P, int p, int F, int G, long long sstride, cudaStream_t st) {
  const long long n_rows = (long long)B * P * p;
  const bool vec = F % 16 == 0 && (F / G) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(pages) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long work = vec ? n_rows * (F / 16) : n_rows * F;
  long long blocks = (work + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  paged_gather_dequant_kernel<Q, O><<<(int)blocks, 256, 0, st>>>(
      static_cast<const unsigned char*>(pages), static_cast<const float*>(scales),
      static_cast<const int*>(table), static_cast<O*>(out), N, p, F, G, sstride, n_rows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, P, page_bytes) = pages[clamp(table)] by the plan of kernels/
// paged.py::gather_plan: vec bytes per vector, blocks of GATHER_THREADS x
// unroll vectors, 64-bit indices when wide. A plan this file would not run
// (a width that does not divide the page or a base, an unroll it has no
// kernel for, a grid that does not cover the output exactly, 32-bit
// indices that overflow) is refused.
extern "C" int repro_paged_gather(const void* pages, const void* table, void* out, int N,
                                  int B, int P, long long page_bytes, int vec, int unroll,
                                  int wide, long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(pages) | reinterpret_cast<uintptr_t>(out);
  if ((vec != 16 && vec != 4 && vec != 1) || page_bytes <= 0 || page_bytes % vec ||
      bases % vec || N < 1 || (unroll != 1 && unroll != GATHER_UNROLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vpp = page_bytes / vec, n_vec = (long long)B * P * vpp;
  if (!flat_grid_ok(n_vec, unroll, blocks, wide)) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 16: return static_cast<int>(launch_gather_u<16>(unroll, pages, table, out, N, vpp,
                                                         n_vec, blocks, wide, st));
    case 4: return static_cast<int>(launch_gather_u<4>(unroll, pages, table, out, N, vpp, n_vec,
                                                       blocks, wide, st));
    default: return static_cast<int>(launch_gather_u<1>(unroll, pages, table, out, N, vpp,
                                                        n_vec, blocks, wide, st));
  }
}

// pages[clamp(table[b, t / p]), t % p] = rows[b], t = clamp(pos[b]), for B
// rows of row_bytes, by the plan of kernels/paged.py::scatter_rows_plan (the
// write-back's flat grid with PagedTarget); any other plan is refused.
extern "C" int repro_paged_scatter_rows(void* pages, const void* table, const void* rows,
                                        const void* pos, int N, int B, int P, int p,
                                        long long row_bytes, int vec, int unroll, int wide,
                                        long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(pages) | reinterpret_cast<uintptr_t>(rows);
  if ((vec != 16 && vec != 4 && vec != 1) || row_bytes <= 0 || row_bytes % vec || bases % vec ||
      N < 1 || P < 1 || p < 1 || B < 1 || (unroll != 1 && unroll != GATHER_UNROLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vpr = row_bytes / vec, n_vec = (long long)B * vpr;
  if (!flat_grid_ok(n_vec, unroll, blocks, wide)) return static_cast<int>(cudaErrorInvalidValue);
  const PagedTarget target{static_cast<const int*>(table), static_cast<const int*>(pos), N, P, p};
  switch (vec) {
    case 16: return static_cast<int>(launch_scatter_u<16>(unroll, pages, rows, target, vpr,
                                                          n_vec, blocks, wide, st));
    case 4: return static_cast<int>(launch_scatter_u<4>(unroll, pages, rows, target, vpr, n_vec,
                                                        blocks, wide, st));
    default: return static_cast<int>(launch_scatter_u<1>(unroll, pages, rows, target, vpr,
                                                         n_vec, blocks, wide, st));
  }
}

// pages[clamp(pid[w]), clamp(off[w])] = rows[w] for W rows of row_bytes,
// by the plan of kernels/ragged.py::scatter_plan: vec bytes per vector (it
// divides the row and both bases), blocks of GATHER_THREADS x unroll
// vectors, 64-bit indices when wide. Any other plan is refused.
extern "C" int repro_ragged_paged_scatter_rows(void* pages, const void* pid, const void* off,
                                               const void* rows, int N, int W, int p,
                                               long long row_bytes, int vec, int unroll,
                                               int wide, long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(pages) | reinterpret_cast<uintptr_t>(rows);
  if ((vec != 16 && vec != 4 && vec != 1) || row_bytes <= 0 || row_bytes % vec || bases % vec ||
      N < 1 || p < 1 || W < 1 || (unroll != 1 && unroll != GATHER_UNROLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vpr = row_bytes / vec, n_vec = (long long)W * vpr;
  if (!flat_grid_ok(n_vec, unroll, blocks, wide)) return static_cast<int>(cudaErrorInvalidValue);
  const RaggedTarget target{static_cast<const int*>(pid), static_cast<const int*>(off), N, p};
  switch (vec) {
    case 16: return static_cast<int>(launch_scatter_u<16>(unroll, pages, rows, target, vpr,
                                                          n_vec, blocks, wide, st));
    case 4: return static_cast<int>(launch_scatter_u<4>(unroll, pages, rows, target, vpr, n_vec,
                                                        blocks, wide, st));
    default: return static_cast<int>(launch_scatter_u<1>(unroll, pages, rows, target, vpr,
                                                         n_vec, blocks, wide, st));
  }
}

// narrow: 0 int8, 1 e4m3; out_dtype: REPRO_F32 / REPRO_BF16. The G scales
// of page row n*p + r start at scales[(n*p + r) * sstride] (sstride >= G:
// a layer's columns of a scale tensor shared by several layers).
extern "C" int repro_paged_gather_dequant(const void* pages, const void* scales,
                                          const void* table, void* out, int N, int B, int P,
                                          int p, int F, int G, long long sstride, int narrow,
                                          int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow == 0) {
    return out_dtype == REPRO_BF16
               ? launch_dequant<int8_t, __nv_bfloat16>(pages, scales, table, out, N, B, P, p, F,
                                                       G, sstride, st)
               : launch_dequant<int8_t, float>(pages, scales, table, out, N, B, P, p, F, G,
                                               sstride, st);
  }
  return out_dtype == REPRO_BF16
             ? launch_dequant<__nv_fp8_e4m3, __nv_bfloat16>(pages, scales, table, out, N, B, P,
                                                            p, F, G, sstride, st)
             : launch_dequant<__nv_fp8_e4m3, float>(pages, scales, table, out, N, B, P, p, F, G,
                                                    sstride, st);
}
