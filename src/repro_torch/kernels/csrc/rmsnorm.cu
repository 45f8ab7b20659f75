// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (`rmsnorm`,
// body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale over the
// last dimension, in f32, output at x's type (bf16 rounded to nearest
// even).  The reference tiles (block_rows, d) rows in VMEM so x makes one
// round trip through device memory.
//
// Work split: one warp per row, 8 rows per 256-thread CTA.  Each lane sums
// the squares of columns lane, lane + 32, ... in f32; a butterfly of
// shuffles reduces the warp; the lanes then read the row again (from L1 or
// L2: a row is at most a few KB), scale it and write it.
//
// What bounds it on the card: the bytes, one read of x and one write of y
// (134 MB at (8192, 4096) bf16, 0.04 ms at 3.35 TB/s); the 3 flops per
// element are nothing beside that.  The second read of each row is served
// by the cache, so device-memory traffic stays one read and one write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int ROWS_PER_CTA = NTHREADS / 32;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    rmsnorm_rows(const T* x, const float* scale, T* y, int rows, int d,
                 float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int c = lane; c < d; c += 32)
    store(yr + c, to_f32(xr[c]) * r * scale[c]);
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows,
                   int d, float eps, cudaStream_t stream) {
  const int grid = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  rmsnorm_rows<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) row-major at one type; scale: (d,) float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 on success); runs on `stream` and does not synchronise.
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* y,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(x, scale, y, rows, d, eps, s)
      : dtype == 1 ? launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
