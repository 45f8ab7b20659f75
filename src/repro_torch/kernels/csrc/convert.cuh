// Conversions between the kernels' storage types and f32, shared by every
// source in this directory (each includes it; kernels/_build.py hashes it
// into every library's name, so an edit here rebuilds them all).
//
// Loads widen to f32 exactly.  Stores round f32 to the output type as JAX's
// astype does: bf16 to nearest even; int8 truncated toward zero and then
// saturated to [-128, 127] (a plain (int8_t) cast would wrap instead).  The
// plain-torch twins use the same rule, kernels/ref.py `cast_like`.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(int8_t* p, float x) {
  *p = (int8_t)max(-128, min(127, __float2int_rz(x)));
}
