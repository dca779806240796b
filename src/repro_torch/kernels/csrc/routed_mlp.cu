// Fused routed MLP with the gated scatter-add of paper Eq. 1 as its
// epilogue: the MLP half of the pallas_fused MoD backend, forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::
// routed_mlp_scatter (_routed_mlp_call / _routed_mlp_kernel). Same
// function: hn = RMSNorm(ln2)(h_sub); m = (act(hn @ w_gate) * (hn @ w_up))
// @ w_down (or act(hn @ w_up) @ w_down without a gate projection);
// delta = a_sub + m; out = x, and on the routed rows
// out[b, idx[b, i]] = x + T(gate[b, i] * f32(delta)). Rounding points are
// the JAX mirror's (_gated_delta, _mirror_mlp): the working type after each
// projection, after the activation and the GLU product, for m, for a + m,
// and for the f32 gate product before the add.
//
// Design: one C entry point, four steps on the caller's stream:
//   1. out = x (a device-to-device copy: the rows that are not routed);
//   2. RMSNorm of the k routed rows, one block per row (gemm.cuh);
//   3. the gate and up projections in one GEMM that reads hn once and
//      keeps two accumulators, with the activation and the GLU product as
//      its epilogue, into a (B*k, F) hidden buffer;
//   4. the down projection, whose epilogue forms delta, applies the gate
//      and adds the result into the routed rows of out. The TPU kernel's
//      one-hot P @ update becomes a direct store: idx is unique per row,
//      so each routed element gets exactly one term.
// The delta never goes back to device memory and there is no separate
// scatter pass. Both GEMMs run on the path the wrapper chose (kernels/
// swiglu.py::gemm_path): in bf16 with D and F multiples of 8 and aligned
// weights the Hopper GEMM of gemm.cuh (TMA + wgmma, f32 sums), else the
// CUDA-core GEMM; the epilogues are the same functors on either.
//
// Bound on the H100 at the 1b training shape (B=4, S=2048, k=256, D=1792,
// F=7168): operations. Three (1024 x 1792 x 7168) products are 79 GFLOP
// (0.080 ms at the bf16 tensor-core peak), against about 160 MB of bytes
// (x in and out, the three weights). At M = 1024 the tiles fill the SMs
// unevenly (gemm.cuh's note on wave quantization).
#include "gemm.cuh"

REPRO_ERROR_STRING

namespace {

template <typename T>
int run(const void* x_, const void* h_, const void* a_, const void* idx_, const void* gate_,
        const void* ln_, const void* wu_, const void* wd_, const void* wg_, void* hn_,
        void* hid_, void* out_, int B, int S, int k, int D, int F, int act, int path, float eps,
        cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* hn = static_cast<T*>(hn_);
  T* hid = static_cast<T*>(hid_);
  T* out = static_cast<T*>(out_);
  const int M = B * k;
  FUSED_TRY(cudaMemcpyAsync(out, x, (size_t)B * S * D * sizeof(T), cudaMemcpyDeviceToDevice, st));
  FUSED_TRY(fused::rmsnorm_rows<T>(static_cast<const T*>(h_), nullptr,
                                   static_cast<const T*>(ln_), nullptr, hn, M, k, S, D, eps, st));
  if (wg_ != nullptr) {
    FUSED_TRY((fused::gemm_on<T, 2>(path, hn, static_cast<const T*>(wg_),
                                    static_cast<const T*>(wu_), M, F, D,
                                    fused::EpiGlu<T>{hid, F, act}, st)));
  } else {
    FUSED_TRY((fused::gemm_on<T, 1>(path, hn, static_cast<const T*>(wu_), nullptr, M, F, D,
                                    fused::EpiAct<T>{hid, F, act}, st)));
  }
  const fused::EpiScatter<T> epi{static_cast<const T*>(a_),
                                 static_cast<const long long*>(idx_),
                                 static_cast<const float*>(gate_),
                                 x,
                                 out,
                                 k,
                                 S,
                                 D};
  FUSED_TRY((fused::gemm_on<T, 1>(path, hid, static_cast<const T*>(wd_), nullptr, M, D, F, epi,
                                  st)));
  return 0;
}

}  // namespace

extern "C" int repro_routed_mlp(const void* x, const void* h, const void* a, const void* idx,
                                const void* gate, const void* ln, const void* wu, const void* wd,
                                const void* wg, void* hn, void* hid, void* out, int B, int S,
                                int k, int D, int F, int dtype, int act, int path, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return run<__nv_bfloat16>(x, h, a, idx, gate, ln, wu, wd, wg, hn, hid, out, B, S, k, D, F,
                              act, path, eps, st);
  return run<float>(x, h, a, idx, gate, ln, wu, wd, wg, hn, hid, out, B, S, k, D, F, act, path,
                    eps, st);
}
