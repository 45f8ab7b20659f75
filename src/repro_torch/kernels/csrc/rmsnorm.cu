// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (`rmsnorm`,
// body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale over the
// last dimension, in f32, output at x's type (bf16 rounded to nearest
// even).  The reference tiles (block_rows, d) rows in VMEM so x makes one
// round trip through device memory.
//
// What bounds it on the card: the bytes, one read of x and one write of y
// (134 MB at (8192, 4096) bf16, 0.04 ms at 3.35 TB/s); the 4 flops per
// element are nothing beside that.  So the kernel's whole job is to keep
// enough bytes in flight, at full load width, to cover the memory latency.
//
// Two routes; the wrapper (kernels/rmsnorm.py `rmsnorm_plan`) picks one
// before launch from the shape, the dtype and x's alignment:
//
//   vec      (`rmsnorm_vec`, the main route).  16-byte loads and stores:
//            8 bf16 or 4 f32 values a thread, neighbouring threads on
//            neighbouring addresses; x read with the streaming hint
//            (ld.global.cs), y written evict-first (st.global.cs).  A row
//            belongs to a group of TPR threads (one to eight warps, the
//            least power of two with TPR * VPT vectors >= the row), and
//            each thread owns the same VPT vectors of every row: vector
//            t + i * TPR, i < VPT.  The row stays in registers from the
//            sum of squares to the scaling, so x is read once; the
//            thread's f32 slice of `scale` is loaded once per CTA into
//            registers.  The sum is a butterfly of shuffles in each warp,
//            then the group's warps' partials through shared memory
//            (double-buffered: one __syncthreads a row).  The grid is
//            persistent, CTAS_PER_SM CTAs of CTA_THREADS on each SM; a CTA
//            walks its rows with a stride and issues the next row's loads
//            before it reduces the current one, so each thread has up to
//            2 * VPT * 16 bytes in flight (64 KB an SM at 512 threads).
//            Takes d * sizeof(T) a multiple of 16 bytes, d up to
//            MAX_TPR * VPT vectors (8192 bf16, 4096 f32), and 16-byte
//            aligned x and y; returns -1 for anything else.
//   general  (`rmsnorm_rows`): one warp per row, 8 rows per CTA, one
//            element a lane per load; the row is read a second time for
//            the scaling (from L1/L2).  Takes any d and any alignment.

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

namespace vec {

constexpr int VEC_BYTES = 16;
constexpr int VPT = 4;            // 16-byte vectors a thread owns in a row
constexpr int CTA_THREADS = 256;
constexpr int CTAS_PER_SM = 2;    // the persistent grid, and launch bounds
constexpr int MAX_TPR = 256;      // threads per row: 32, 64, 128 or 256

// The 16-byte vector's values widened to f32 (exact) and narrowed back
// (bf16 to nearest even, as convert.cuh's `store`).
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void two(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);           // low half: element 2k
    f[1] = __uint_as_float(w & 0xffff0000u);   // high half: element 2k+1
  }
  __device__ __forceinline__ static uint32_t two(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    two(v.x, f);
    two(v.y, f + 2);
    two(v.z, f + 4);
    two(v.w, f + 6);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(two(f), two(f + 2), two(f + 4), two(f + 6));
  }
};

// The tile a row of d elements of T takes: threads per row (0 if the
// route does not take d), and from it rows per CTA.
__host__ __device__ constexpr int vectors(int d, int elt) {
  return d * elt / VEC_BYTES;
}

inline int threads_per_row(int d, int elt) {
  if (d <= 0 || (d * (int64_t)elt) % VEC_BYTES) return 0;
  const int64_t dv = (int64_t)d * elt / VEC_BYTES;
  for (int tpr = 32; tpr <= MAX_TPR; tpr *= 2)
    if ((int64_t)tpr * VPT >= dv) return tpr;
  return 0;
}

template <typename T, int TPR>
__global__ void __launch_bounds__(CTA_THREADS, CTAS_PER_SM)
    rmsnorm_vec(const uint4* __restrict__ x, const float* __restrict__ scale,
                uint4* __restrict__ y, int rows, int dv, int d, float eps) {
  using P = Pack<T>;
  constexpr int GROUPS = CTA_THREADS / TPR;   // rows a CTA takes at once
  constexpr int WARPS = TPR / 32;
  __shared__ float part[2][GROUPS][WARPS];
  const int t = threadIdx.x % TPR;
  const int g = threadIdx.x / TPR;
  const int warp = t / 32;

  bool own[VPT];
  float s[VPT][P::N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    own[i] = t + i * TPR < dv;
#pragma unroll
    for (int e = 0; e < P::N; ++e)
      s[i][e] = own[i] ? scale[(t + i * TPR) * P::N + e] : 0.f;
  }

  const int64_t step = (int64_t)gridDim.x * GROUPS;
  int64_t base = (int64_t)blockIdx.x * GROUPS;
  uint4 cur[VPT], nxt[VPT];
  {
    const int64_t row = base + g;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      if (row < rows && own[i]) cur[i] = __ldcs(x + row * dv + t + i * TPR);
  }
  int buf = 0;
  // Every thread of the CTA runs the same passes (rows past the end idle
  // in them), so the __syncthreads below is uniform.
  for (; base < rows; base += step) {
    const int64_t row = base + g;
    const int64_t next = row + step;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      if (next < rows && own[i]) nxt[i] = __ldcs(x + next * dv + t + i * TPR);
    float ss = 0.f;
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (!own[i]) continue;
        float f[P::N];
        P::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < P::N; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (WARPS > 1) {
      if (threadIdx.x % 32 == 0) part[buf][g][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ss += part[buf][g][w];
      buf ^= 1;
    }
    const float r = rsqrtf(ss / (float)d + eps);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (!own[i]) continue;
        float f[P::N];
        P::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < P::N; ++e) f[e] = f[e] * r * s[i][e];
        __stcs(y + row * dv + t + i * TPR, P::pack(f));
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!count[dev])
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename T, int TPR>
cudaError_t launch_tpr(const void* x, const float* scale, void* y, int rows,
                       int d, float eps, cudaStream_t stream) {
  constexpr int GROUPS = CTA_THREADS / TPR;
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const int64_t need = ((int64_t)rows + GROUPS - 1) / GROUPS;
  const int grid = (int)(need < (int64_t)sms * CTAS_PER_SM
                             ? need : (int64_t)sms * CTAS_PER_SM);
  rmsnorm_vec<T, TPR><<<grid, CTA_THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), scale, static_cast<uint4*>(y), rows,
      vectors(d, sizeof(T)), d, eps);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* scale, void* y, int rows, int d,
           float eps, cudaStream_t stream) {
  switch (threads_per_row(d, sizeof(T))) {
    case 32: return launch_tpr<T, 32>(x, scale, y, rows, d, eps, stream);
    case 64: return launch_tpr<T, 64>(x, scale, y, rows, d, eps, stream);
    case 128: return launch_tpr<T, 128>(x, scale, y, rows, d, eps, stream);
    case 256: return launch_tpr<T, 256>(x, scale, y, rows, d, eps, stream);
    default: return -1;
  }
}

template <typename T>
int resident(int tpr) {
  int n = 0;
  const cudaError_t err =
      tpr == 32    ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, rmsnorm_vec<T, 32>, CTA_THREADS, 0)
      : tpr == 64  ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, rmsnorm_vec<T, 64>, CTA_THREADS, 0)
      : tpr == 128 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, rmsnorm_vec<T, 128>, CTA_THREADS, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, rmsnorm_vec<T, 256>, CTA_THREADS, 0);
  return err == cudaSuccess ? n : -1;
}

}  // namespace vec

// The tile each route was built with, for a row of d elements at `dtype`
// (0 = float32, 1 = bfloat16); `route` 0 = vec, 1 = general.  Writes
// threads per row, vectors per thread (16-byte loads; 0 for general's
// one-element loads), rows per CTA, CTAs per SM of the persistent grid (0
// for general, whose grid covers the rows), threads per CTA, and CTAs per
// SM the occupancy calculator finds resident (general: 0).  Returns -1
// where the vec route does not take (d, dtype).  The wrapper's
// `rmsnorm_plan` states the same numbers; chip_smoke.py holds it against
// this function.
extern "C" int rmsnorm_tile(int route, int d, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  if (route == 1) {
    const int tile[6] = {32, 0, ROWS_PER_CTA, 0, NTHREADS, 0};
    for (int i = 0; i < 6; ++i) out[i] = tile[i];
    return 0;
  }
  const int elt = dtype == 0 ? 4 : 2;
  const int tpr = vec::threads_per_row(d, elt);
  if (route != 0 || !tpr) return -1;
  out[0] = tpr;
  out[1] = vec::VPT;
  out[2] = vec::CTA_THREADS / tpr;
  out[3] = vec::CTAS_PER_SM;
  out[4] = vec::CTA_THREADS;
  out[5] = dtype == 0 ? vec::resident<float>(tpr)
                      : vec::resident<__nv_bfloat16>(tpr);
  return 0;
}

// The vec route: x, y (rows, d) row-major at one type, 16-byte aligned;
// scale (d,) float32 (any alignment).  dtype: 0 = float32, 1 = bfloat16.
// Returns -1 for what the route does not take (see above), else the
// launch's cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int rmsnorm_vec_launch(const void* x, const float* scale, void* y,
                                  int rows, int d, float eps, int dtype,
                                  void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)y) % vec::VEC_BYTES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? vec::launch<float>(x, scale, y, rows, d, eps, s)
         : dtype == 1 ? vec::launch<__nv_bfloat16>(x, scale, y, rows, d,
                                                   eps, s)
                      : -1;
}

// The general route: x, y (rows, d) row-major at one type; scale (d,)
// float32.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 on success); runs on `stream` and does not synchronise.
extern "C" int rmsnorm_general_launch(const void* x, const float* scale,
                                      void* y, int rows, int d, float eps,
                                      int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(x, scale, y, rows, d, eps, s)
      : dtype == 1 ? launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
