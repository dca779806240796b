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
#include "common.cuh"

REPRO_ERROR_STRING

namespace {

// dst[0:n) = src[0:n) by the threads of one block: 16-byte vectors when
// both ends are 16-byte aligned, else 4-byte words when 4-byte aligned,
// and single bytes for the tail.
__device__ __forceinline__ void block_copy(const char* __restrict__ src,
                                           char* __restrict__ dst, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  long long done = 0;
  if (a % 16 == 0) {
    const long long nv = n / 16;
    for (long long e = threadIdx.x; e < nv; e += blockDim.x)
      reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
    done = nv * 16;
  } else if (a % 4 == 0) {
    const long long nw = n / 4;
    for (long long e = threadIdx.x; e < nw; e += blockDim.x)
      reinterpret_cast<uint32_t*>(dst)[e] = reinterpret_cast<const uint32_t*>(src)[e];
    done = nw * 4;
  }
  for (long long e = done + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One block per logical page (i, b): out[b, i*p:(i+1)*p] = pages[table[b, i]].
__global__ void paged_gather_kernel(const char* __restrict__ pages,
                                    const int* __restrict__ table,
                                    char* __restrict__ out, int N, int P,
                                    long long page_bytes) {
  const int i = blockIdx.x, b = blockIdx.y;
  const int pid = clampi(table[(long long)b * P + i], 0, N - 1);
  block_copy(pages + (long long)pid * page_bytes,
             out + ((long long)b * P + i) * page_bytes, page_bytes);
}

// One block per slot b: pages[table[b, t / p], t % p] = rows[b], t = pos[b].
__global__ void paged_scatter_rows_kernel(char* __restrict__ pages,
                                          const int* __restrict__ table,
                                          const char* __restrict__ rows,
                                          const int* __restrict__ pos, int N, int P,
                                          int p, long long row_bytes) {
  const int b = blockIdx.x;
  const int t = clampi(pos[b], 0, P * p - 1);
  const int pid = clampi(table[(long long)b * P + t / p], 0, N - 1);
  block_copy(rows + (long long)b * row_bytes,
             pages + ((long long)pid * p + t % p) * row_bytes, row_bytes);
}

// One block per write row w: pages[pid[w], off[w]] = rows[w].
__global__ void ragged_paged_scatter_rows_kernel(char* __restrict__ pages,
                                                 const int* __restrict__ pid,
                                                 const int* __restrict__ off,
                                                 const char* __restrict__ rows, int N,
                                                 int p, long long row_bytes) {
  const int w = blockIdx.x;
  const int pg = clampi(pid[w], 0, N - 1);
  const int o = clampi(off[w], 0, p - 1);
  block_copy(rows + (long long)w * row_bytes,
             pages + ((long long)pg * p + o) * row_bytes, row_bytes);
}

int threads_for(long long bytes) {
  // one 16-byte vector per thread and pass, at least one warp
  long long t = (bytes / 16 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : (int)t);
}

}  // namespace

extern "C" int repro_paged_gather(const void* pages, const void* table, void* out, int N,
                                  int B, int P, long long page_bytes, void* stream) {
  dim3 grid(P, B);
  paged_gather_kernel<<<grid, threads_for(page_bytes), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pages), static_cast<const int*>(table),
      static_cast<char*>(out), N, P, page_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_paged_scatter_rows(void* pages, const void* table, const void* rows,
                                        const void* pos, int N, int B, int P, int p,
                                        long long row_bytes, void* stream) {
  paged_scatter_rows_kernel<<<B, threads_for(row_bytes), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pages), static_cast<const int*>(table),
      static_cast<const char*>(rows), static_cast<const int*>(pos), N, P, p, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_ragged_paged_scatter_rows(void* pages, const void* pid, const void* off,
                                               const void* rows, int N, int W, int p,
                                               long long row_bytes, void* stream) {
  ragged_paged_scatter_rows_kernel<<<W, threads_for(row_bytes), 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pages), static_cast<const int*>(pid), static_cast<const int*>(off),
      static_cast<const char*>(rows), N, p, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
