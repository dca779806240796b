// SwiGLU MLP: y = T(sum_F f32(T(silu(f32(x @ Wg)) * f32(x @ Wu)) @ Wd)).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::swiglu
// (_swiglu_kernel). Same function and rounding points: the gate and up
// products are f32 sums, the hidden h = silu(g) * u is rounded once to x's
// type, the down product sums over F in f32 and is rounded once at the end.
//
// Design: two launches of a hand-written tiled GEMM of gemm.cuh on the
// caller's stream: for bf16 the tensor-core GEMM (mma.sync, f32 sums) when
// D and F are multiples of 8, else the CUDA-core GEMM (f32 throughout).
// The TPU kernel keeps a (bm, D) f32 accumulator in VMEM across its
// sequential F blocks so h never reaches HBM; at mod-paper-1b's D = 1792
// that accumulator is 1.8 MB for bm = 256, which no SM holds, and CUDA
// blocks cannot carry a sum from one grid step to the next. So:
//   1. the gate and up products in one GEMM that reads x once and keeps two
//      accumulators, with silu(g) * u as its epilogue, into h (M, F) in x's
//      type (a buffer the wrapper allocates);
//   2. the down product h @ Wd with the f32 sum over all of F in registers
//      and the cast as its epilogue.
// h makes one round trip through HBM (2 * M * F * sizeof(T) bytes).
//
// Bound on the H100: operations, 6 * M * D * F (at M = 8192, D = 1792,
// F = 7168: 631 GFLOP, 0.64 ms at the bf16 tensor-core peak, 9.4 ms at the
// f32 CUDA-core peak). The bf16 path uses mma.sync without wgmma or TMA, so
// it stays well below the tensor-core peak; f32 runs on CUDA cores.
#include "gemm.cuh"

REPRO_ERROR_STRING

namespace {

template <typename T>
int run(const void* x_, const void* wg_, const void* wu_, const void* wd_, void* h_, void* y_,
        int M, int D, int F, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* h = static_cast<T*>(h_);
  FUSED_TRY((fused::gemm<T, 2>(x, static_cast<const T*>(wg_), static_cast<const T*>(wu_), M, F,
                               D, fused::EpiSwiglu<T>{h, F}, st)));
  FUSED_TRY((fused::gemm<T, 1>(h, static_cast<const T*>(wd_), nullptr, M, D, F,
                               fused::EpiStore<T>{static_cast<T*>(y_), nullptr, D}, st)));
  return 0;
}

using bf16 = __nv_bfloat16;

int run_tc(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd, bf16* h, bf16* y,
           int M, int D, int F, cudaStream_t st) {
  FUSED_TRY((fused::gemm_bf16_tc<2>(x, wg, wu, M, F, D, fused::EpiSwiglu<bf16>{h, F}, st)));
  FUSED_TRY((fused::gemm_bf16_tc<1>(h, wd, wd, M, D, F, fused::EpiStore<bf16>{y, nullptr, D},
                                    st)));
  return 0;
}

}  // namespace

// x (M, D), w_gate / w_up (D, F), w_down (F, D), h (M, F) scratch, y (M, D),
// all row-major of one dtype (REPRO_F32 / REPRO_BF16).
extern "C" int repro_swiglu(const void* x, const void* wg, const void* wu, const void* wd,
                            void* h, void* y, int M, int D, int F, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != REPRO_BF16) return run<float>(x, wg, wu, wd, h, y, M, D, F, st);
  if (fused::tc_ok(x, wg, wu, F, D) && fused::tc_ok(h, wd, wd, D, F))
    return run_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                  static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
                  static_cast<bf16*>(h), static_cast<bf16*>(y), M, D, F, st);
  return run<bf16>(x, wg, wu, wd, h, y, M, D, F, st);
}
