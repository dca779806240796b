// Narrow KV element types of the quantized pool (int8, e4m3) widened to
// f32, shared by the dequantizing page gather (paged.cu) and the ragged
// paged attention (ragged_attention.cu). Both conversions are exact.
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

// narrow byte -> f32
template <typename Q>
__device__ __forceinline__ float widen(unsigned char byte);
template <>
__device__ __forceinline__ float widen<int8_t>(unsigned char byte) {
  return static_cast<float>(static_cast<signed char>(byte));
}
template <>
__device__ __forceinline__ float widen<__nv_fp8_e4m3>(unsigned char byte) {
  __nv_fp8_e4m3 q;
  q.__x = byte;
  return static_cast<float>(q);
}
