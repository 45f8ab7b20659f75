// Grouped and dispersed GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/dispersed_gemm.py:
//
//   K3 `matmul_grouped` (body `_grouped_kernel`): C = A @ B with the f32
//      accumulators of W row tiles kept on chip for the whole K loop; the
//      B panel is fetched once per (group, k) and applied to all W tiles;
//      C is written once, at A's type.
//   K4 `matmul_dispersed` (body `_dispersed_kernel`): the W = 0 extreme;
//      the f32 C tile is read from and written back to device memory on
//      every k step.
//
// One kernel, `gemm_rows`, serves both.  A CTA owns `rows` consecutive rows
// of C and a slice of `cols` = 16384 / rows columns, i.e. 16384 f32
// accumulators in registers (8 x 8 per thread, 256 threads).  It walks
// k in [k_begin, k_end) in chunks of KC: each chunk of A (rows x KC) and of
// B (KC x cols) is staged once in shared memory as f32 and every thread
// applies it to its 8 x 8 accumulators.
//
//   K3: one launch, rows = W * block_m (the group's W row tiles), k over
//       the whole of K.  The reference keeps the whole width n of each row
//       tile on chip, (W, block_m, n) f32; a Hopper CTA cannot hold that
//       (256 KB at W=4, block_m=64, n=256; 7.3 MB per row tile at n=14336),
//       so N is split across CTAs.  Each CTA still stages its B slice once
//       per k step and applies it to all W row tiles, so B is read once per
//       (group, k) in aggregate; A is read again by every N slice, which
//       the card's L2 may absorb.
//   K4: one launch per k step (block_k), rows = block_m.  Blocks of one
//       launch run in no fixed order, so the reference's k-outermost grid
//       becomes a sequence of launches; C lives in an f32 buffer in device
//       memory, read at the start of every step but the first and written
//       at its end.  Nothing keeps C on chip across k: the spill/fill
//       traffic the kernel exists to show is real.  The last step writes
//       A's type directly (for f32 that is the buffer itself).
//
// Summation order: every element of C is one chain of f32 FMAs over
// k = 0, 1, ..., K-1, whatever W, block_m or block_k, so K3's output is
// bitwise independent of W (the reference pins that too) and K4 follows
// the same chain.  f32 inputs use FP32 FMAs (no TF32); bf16 and int8
// products are exact in f32, and int8 sums are exact while |sum| < 2^24.
// The output is rounded to nearest even for bf16 and, for int8, truncated
// toward zero and saturated to [-128, 127], as JAX's f32 -> int8 does.
//
// What bounds it on the card: at granite-8b's MLP shape (8192 x 4096 x
// 14336, bf16) the product is 0.96 TFLOP, about 0.97 ms at the 989 TFLOP/s
// bf16 tensor-core peak; the bytes, each input read once and C written
// once (0.42 GB), take 0.13 ms at 3.35 TB/s.  This first version does its FMAs on the CUDA
// cores (67 TFLOP/s FP32 peak, so at least 14 ms) with two shared-memory
// float4 loads of A and two of B per 64 FMAs.  Tensor-core tiles (wgmma)
// fed by TMA are the route to the bound and are later work; the design
// keeps the per-CTA accumulator set that those need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int ACC_PER_CTA = 16384;  // rows * cols, 64 per thread
constexpr int KC = 16;              // k per shared-memory chunk
constexpr int PAD = 4;              // A rows padded: fewer bank conflicts

struct Params {
  const void* a;
  const void* b;
  float* acc;   // f32 C buffer (K4), read when load_acc, written otherwise
  void* out;    // C at A's type, written when store_out
  int m, n, k, k_begin, k_end, rows, cols, load_acc, store_out;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) gemm_rows(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = p.rows, NS = p.cols, AS = R + PAD;
  float* As = smem;            // [KC][R + PAD], A chunk transposed
  float* Bs = smem + KC * AS;  // [KC][NS]

  const int tid = threadIdx.x;
  const int tc = NS / 8;       // threads along n
  const int ty = tid / tc, tx = tid % tc;
  const int row0 = blockIdx.y * R, col0 = blockIdx.x * NS;
  // This thread's rows: ty*4 + i and R/2 + ty*4 + i (i < 4); its columns:
  // tx*4 + j and NS/2 + tx*4 + j (j < 4): float4 loads, no bank conflict.
  int rr[8], cc[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = row0 + ty * 4 + i;
    rr[i + 4] = row0 + R / 2 + ty * 4 + i;
    cc[i] = col0 + tx * 4 + i;
    cc[i + 4] = col0 + NS / 2 + tx * 4 + i;
  }

  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = (p.load_acc && cc[j] < p.n)
                      ? p.acc[(size_t)rr[i] * p.n + cc[j]] : 0.f;

  for (int kc = p.k_begin; kc < p.k_end; kc += KC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < R * KC; i += NTHREADS) {
      const int r = i / KC, kk = i % KC, kg = kc + kk;
      As[kk * AS + r] =
          kg < p.k_end ? to_f32(A[(size_t)(row0 + r) * p.k + kg]) : 0.f;
    }
    for (int i = tid; i < KC * NS; i += NTHREADS) {
      const int kk = i / NS, c = i % NS, kg = kc + kk, cg = col0 + c;
      Bs[kk * NS + c] = (kg < p.k_end && cg < p.n)
                            ? to_f32(B[(size_t)kg * p.n + cg]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float* ar = As + kk * AS;
      const float* br = Bs + kk * NS;
      const float4 a0 = *reinterpret_cast<const float4*>(ar + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + R / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(br + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(br + NS / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cc[j] >= p.n) continue;
      const size_t idx = (size_t)rr[i] * p.n + cc[j];
      if (p.store_out)
        store(out + idx, acc[i][j]);
      else
        p.acc[idx] = acc[i][j];
    }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * KC * (p.rows + PAD + p.cols);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + p.cols - 1) / p.cols, p.m / p.rows);
  gemm_rows<T><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C rows [0, m) of A (m, k) @ B (k, n), both row-major, over
// k in [k_begin, k_end).  `rows` (a power of two in [8, 2048] dividing m)
// is the CTA's row count.  load_acc: start from `acc` (f32, (m, n)) instead
// of 0.  store_out: write `out` at the input type, else write `acc`.
// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  Returns -1 for arguments
// the kernel does not take (the wrapper raises ValueError), else the
// launch's cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int gemm_rows_launch(const void* a, const void* b, float* acc,
                                void* out, int m, int n, int k, int k_begin,
                                int k_end, int rows, int load_acc,
                                int store_out, int dtype, void* stream) {
  if (rows < 8 || rows > 2048 || (rows & (rows - 1)) || m % rows ||
      k_begin < 0 || k_begin >= k_end || k_end > k || n <= 0)
    return -1;
  Params p{a, b, acc, out, m, n, k, k_begin, k_end, rows,
           ACC_PER_CTA / rows, load_acc, store_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float>(p, s)
                  : dtype == 1 ? launch<__nv_bfloat16>(p, s)
                  : dtype == 2 ? launch<int8_t>(p, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
