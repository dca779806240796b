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
// The TPU versions express the row permutation as a one-hot f32 matmul per
// S-block so the inner loop is MXU work. With unique indices each output
// row receives exactly one term, so that matmul is a copy; here it is
// written as one: no matmul, no f32 round trip, bit-exact by construction.
//
// Bound on the H100: bytes. gather moves k rows in and k rows out; the
// scatter-add copies x (B*S rows) and rewrites k of them. Neither does
// arithmetic worth counting (one multiply and one add per routed element).
// The design keeps every access a coalesced 16-byte vector where the row
// allows it (D * elem_size % 16 == 0, true at every model width), with one
// block per row so the card has B*k (or B*S) independent rows in flight.
#include "common.cuh"

REPRO_ERROR_STRING

namespace {

// One block per output row (b, i): out[b, i, :] = x[b, idx[b, i], :].
// An index outside [0, S) yields a zero row, as the one-hot formulation
// does (it matches no row of x).
template <typename Idx>
__global__ void gather_rows_kernel(const char* __restrict__ x,
                                   const Idx* __restrict__ idx,
                                   char* __restrict__ out, int S, int k,
                                   long long row_bytes) {
  const int i = blockIdx.x, b = blockIdx.y;
  const long long s = idx[(long long)b * k + i];
  char* dst = out + ((long long)b * k + i) * row_bytes;
  const bool vec = (row_bytes % 16 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (s < 0 || s >= S) {
    if (vec) {
      for (long long e = threadIdx.x; e < row_bytes / 16; e += blockDim.x)
        reinterpret_cast<uint4*>(dst)[e] = make_uint4(0, 0, 0, 0);
    } else {
      for (long long e = threadIdx.x; e < row_bytes; e += blockDim.x) dst[e] = 0;
    }
    return;
  }
  const char* src = x + ((long long)b * S + s) * row_bytes;
  if (vec) {
    for (long long e = threadIdx.x; e < row_bytes / 16; e += blockDim.x)
      reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
  } else {
    for (long long e = threadIdx.x; e < row_bytes; e += blockDim.x) dst[e] = src[e];
  }
}

// Grid-stride copy of n bytes (out = x before the routed rows are updated).
__global__ void copy_bytes_kernel(const char* __restrict__ x, char* __restrict__ out,
                                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0)) {
    const uint4* s = reinterpret_cast<const uint4*>(x);
    uint4* d = reinterpret_cast<uint4*>(out);
    for (long long e = t; e < n / 16; e += stride) d[e] = s[e];
  } else {
    for (long long e = t; e < n; e += stride) out[e] = x[e];
  }
}

// One block per routed row (i, b):
//   out[b, s, :] = x[b, s, :] + cast(gate[b, i] * f32(delta[b, i, :])),
// s = idx[b, i]. The gate multiply is f32 and the cast to x's type comes
// before the add, exactly as the TPU kernel and the XLA formulation do.
template <typename T, typename Idx>
__global__ void scatter_update_kernel(const T* __restrict__ x,
                                      const Idx* __restrict__ idx,
                                      const T* __restrict__ delta,
                                      const float* __restrict__ gate,
                                      T* __restrict__ out, int S, int k, int D) {
  const int i = blockIdx.x, b = blockIdx.y;
  const long long s = idx[(long long)b * k + i];
  if (s < 0 || s >= S) return;
  const float g = gate[(long long)b * k + i];
  const T* xr = x + ((long long)b * S + s) * D;
  const T* dr = delta + ((long long)b * k + i) * D;
  T* orow = out + ((long long)b * S + s) * D;
  // __fmul_rn / __fadd_rn: no contraction into an FMA, so the f32 case
  // rounds the product before the add, as the reference does
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const T upd = from_f32<T>(__fmul_rn(g, to_f32(dr[d])));
    orow[d] = from_f32<T>(__fadd_rn(to_f32(xr[d]), to_f32(upd)));
  }
}

template <typename Idx>
void launch_gather(const void* x, const void* idx, void* out, int B, int S, int k,
                   long long row_bytes, cudaStream_t st) {
  gather_rows_kernel<Idx><<<dim3(k, B), 128, 0, st>>>(
      static_cast<const char*>(x), static_cast<const Idx*>(idx), static_cast<char*>(out), S, k,
      row_bytes);
}

template <typename T, typename Idx>
void launch_scatter_update(const void* x, const void* idx, const void* delta, const void* gate,
                           void* out, int B, int S, int k, int D, cudaStream_t st) {
  const int threads = D >= 256 ? 256 : 128;
  scatter_update_kernel<T, Idx><<<dim3(k, B), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const Idx*>(idx), static_cast<const T*>(delta),
      static_cast<const float*>(gate), static_cast<T*>(out), S, k, D);
}

}  // namespace

// idx_bytes: 8 (int64 indices) or 4 (int32).
extern "C" int repro_gather_rows(const void* x, const void* idx, void* out, int B, int S,
                                 int k, int D, int elem_bytes, int idx_bytes, void* stream) {
  const long long row_bytes = (long long)D * elem_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    launch_gather<int>(x, idx, out, B, S, k, row_bytes, st);
  } else {
    launch_gather<long long>(x, idx, out, B, S, k, row_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_scatter_add_rows(const void* x, const void* idx, const void* delta,
                                      const void* gate, void* out, int B, int S, int k,
                                      int D, int dtype, int idx_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem_bytes = dtype == REPRO_BF16 ? 2 : 4;
  const long long n = (long long)B * S * D * elem_bytes;
  long long blocks = (n / 16 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  copy_bytes_kernel<<<(int)blocks, 256, 0, st>>>(static_cast<const char*>(x),
                                                  static_cast<char*>(out), n);
  if (dtype == REPRO_BF16 && idx_bytes == 4) {
    launch_scatter_update<__nv_bfloat16, int>(x, idx, delta, gate, out, B, S, k, D, st);
  } else if (dtype == REPRO_BF16) {
    launch_scatter_update<__nv_bfloat16, long long>(x, idx, delta, gate, out, B, S, k, D, st);
  } else if (idx_bytes == 4) {
    launch_scatter_update<float, int>(x, idx, delta, gate, out, B, S, k, D, st);
  } else {
    launch_scatter_update<float, long long>(x, idx, delta, gate, out, B, S, k, D, st);
  }
  return static_cast<int>(cudaGetLastError());
}
