// Shared helpers of the port's CUDA sources: element conversions and the
// error string every library exports. Each source compiles to its own
// shared library with a plain C interface (kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
#define REPRO_F32 0
#define REPRO_BF16 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

#define REPRO_ERROR_STRING                                              \
  extern "C" const char* repro_error_string(int err) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(err));           \
  }
