// SwiGLU MLP: y = T(sum_F f32(T(silu(f32(x @ Wg)) * f32(x @ Wu)) @ Wd)).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::swiglu
// (_swiglu_kernel). Same function and rounding points: the gate and up
// products are f32 sums, the hidden h = silu(g) * u is rounded once to x's
// type, the down product sums over F in f32 and is rounded once at the end.
//
// Design: two launches of a hand-written GEMM of gemm.cuh on the caller's
// stream, both on the path the wrapper chose (kernels/swiglu.py::
// gemm_path): for bf16 with D and F multiples of 8 and aligned bases the
// Hopper GEMM (TMA + wgmma, f32 sums), else the CUDA-core GEMM (f32
// throughout). The TPU kernel keeps a (bm, D) f32 accumulator in VMEM
// across its sequential F blocks so h never reaches HBM; at mod-paper-1b's
// D = 1792 that accumulator is 1.8 MB for bm = 256, which no SM holds, and
// CUDA blocks cannot carry a sum from one grid step to the next. So:
//   1. the gate and up products in one GEMM that reads x once and keeps two
//      accumulators, with silu(g) * u as its epilogue, into h (M, F) in x's
//      type (a buffer the wrapper allocates);
//   2. the down product h @ Wd with the f32 sum over all of F in registers
//      and the cast as its epilogue.
// h makes one round trip through HBM (2 * M * F * sizeof(T) bytes).
//
// Bound on the H100: operations, 6 * M * D * F (at M = 8192, D = 1792,
// F = 7168: 631 GFLOP, 0.64 ms at the bf16 tensor-core peak, 9.4 ms at the
// f32 CUDA-core peak).
#include "gemm.cuh"

REPRO_ERROR_STRING

namespace {

template <typename T>
int run(const void* x_, const void* wg_, const void* wu_, const void* wd_, void* h_, void* y_,
        int M, int D, int F, int path, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* h = static_cast<T*>(h_);
  FUSED_TRY((fused::gemm_on<T, 2>(path, x, static_cast<const T*>(wg_),
                                  static_cast<const T*>(wu_), M, F, D,
                                  fused::EpiSwiglu<T>{h, F}, st)));
  FUSED_TRY((fused::gemm_on<T, 1>(path, h, static_cast<const T*>(wd_), nullptr, M, D, F,
                                  fused::EpiStore<T>{static_cast<T*>(y_), nullptr, D}, st)));
  return 0;
}

}  // namespace

// x (M, D), w_gate / w_up (D, F), w_down (F, D), h (M, F) scratch, y (M, D),
// all row-major of one dtype (REPRO_F32 / REPRO_BF16); path is the GEMM of
// both products (REPRO_GEMM_CUDA_CORES / REPRO_GEMM_WGMMA, bf16 only).
extern "C" int repro_swiglu(const void* x, const void* wg, const void* wu, const void* wd,
                            void* h, void* y, int M, int D, int F, int dtype, int path,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return run<__nv_bfloat16>(x, wg, wu, wd, h, y, M, D, F, path, st);
  return run<float>(x, wg, wu, wd, h, y, M, D, F, path, st);
}
