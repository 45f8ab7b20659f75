// FlashAttention-2 forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`) together with the GQA head
// repeat of src/repro/kernels/ops.py (`flash_attention`).
//
// What it computes, as the reference does: for every (batch, query head)
// the online-softmax attention of q against k/v, with an f32 running max,
// normaliser and (rows, D) accumulator; a finite NEG_INF = -1e30 for masked
// scores (so -inf - -inf never makes a NaN); the causal rule aligned
// top-left (row i sees columns j <= i) with whole KV tiles above the
// diagonal skipped; a normaliser of 0 replaced by 1; f32 inputs multiplied
// in full f32 (no TF32), bf16 inputs accumulated in f32 and the output
// rounded to nearest even.
//
// Layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o like q, each with its
// own batch/head/sequence strides in elements and a unit stride along D, so
// the model's (B, S, H, D) projections are read in place without a
// transpose copy.  GQA reads KV head h / (Hq / Hkv) directly: the mapping
// of the reference's jnp.repeat, without the repeated copy.
//
// Work split: one CTA of 256 threads per (b*h, 64-row query tile); the
// reference's sequential kv grid axis becomes a loop over 64-row KV tiles
// inside the CTA.  Q, K, V and the probability tile are staged in shared
// memory as f32; thread t owns rows 4*(t/16)..+3 and columns t%16 + 16*j
// of both the score tile and the output accumulator, so a row's max and
// sum reduce over one half-warp with shuffles.
//
// What bounds it on the card: at the prefill shape (4, 32, 512, 96) bf16
// the function moves ~50 MB (15 us at 3.35 TB/s) and needs ~6.4 GFLOP
// (6.5 us at 989 TFLOP/s), so the bound is the bytes.  This first version
// does its products on the CUDA cores from shared memory (two shared loads
// per two FMAs), so it is bound by shared-memory bandwidth and the FP32
// pipe, far above either bound.  Tensor-core tiles (mma/wgmma for bf16)
// fed by TMA are the route to the bound and are later work; the design
// keeps the tile loop and the per-row state those need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int NTHREADS = 256;
constexpr int ROWS = 4;         // query rows per thread
constexpr int KCOLS = BK / 16;  // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, group, sq, sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK: (64, D+1) padded rows; sV: (64, D); sP: (64, 65)
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd(Params p) {
  constexpr int DP = D + 1;      // padding: column reads hit distinct banks
  constexpr int OCOLS = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows ROWS*rg .. ROWS*rg + ROWS-1
  const int cg = tid % 16;  // columns cg + 16*j
  const int b = blockIdx.y / p.hq;
  const int h = blockIdx.y % p.hq;
  const int hk = h / p.group;
  const int q_start = blockIdx.x * BQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D, qi = q_start + r;
    sQ[r * DP + c] = qi < p.sq ? to_f32(q[qi * p.q_ss + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OCOLS; ++j) acc[i][j] = 0.f;
  }

  // Causal: tiles starting at or past q_start + BQ are fully masked for
  // every row of this CTA and are skipped (the reference's block skip).
  const int kv_end = p.causal ? min(p.sk, q_start + BQ) : p.sk;
  for (int k_start = 0; k_start < kv_end; k_start += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D, kj = k_start + r;
      const bool in = kj < p.sk;
      sK[r * DP + c] = in ? to_f32(k[kj * p.k_ss + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(v[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(ROWS * rg + i) * DP + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = sK[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q_start + ROWS * rg + i;
      // Columns past sk (a ragged last tile) take no part at all; causally
      // masked ones score NEG_INF and enter the max, as in the reference.
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k_start + cg + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.causal && qi < kj) x = NEG_INF;
        s[i][j] = x;
        if (kj < p.sk) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k_start + cg + 16 * j;
        const float pij = kj < p.sk ? expf(s[i][j] - m_new) : 0.f;
        rs += pij;
        sP[(ROWS * rg + i) * (BK + 1) + cg + 16 * j] = pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OCOLS; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS], vv[OCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(ROWS * rg + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < OCOLS; ++j) vv[j] = sV[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < OCOLS; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q_start + ROWS * rg + i;
    if (qi >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked rows
#pragma unroll
    for (int j = 0; j < OCOLS; ++j)
      store(o + qi * p.o_ss + cg + 16 * j, acc[i][j] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, bh);
  flash_fwd<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, bh, stream);
    case 64: return launch<T, 64>(p, bh, stream);
    case 96: return launch<T, 96>(p, bh, stream);
    case 128: return launch<T, 128>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream` and the
// call does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int b, int hq, int hkv, int sq, int sk, int d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale, int causal, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, hq, hq / hkv, sq, sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_d<float>(p, b * hq, d, s)
                  : dtype == 1 ? launch_d<__nv_bfloat16>(p, b * hq, d, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
