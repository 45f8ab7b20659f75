// FlashAttention-2 forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention` :118, body `_flash_kernel` :62, pallas_call :143)
// together with the GQA head repeat of src/repro/kernels/ops.py
// (`flash_attention` :22).
//
// What it computes, as the reference does: for every (batch, query head)
// the online-softmax attention of q against k/v, with an f32 running max,
// normaliser and (rows, D) accumulator; a finite NEG_INF = -1e30 for masked
// scores (so -inf - -inf never makes a NaN); the causal rule aligned
// top-left (row i sees columns j <= i) with whole KV tiles above the
// diagonal skipped; a normaliser of 0 replaced by 1; the output rounded to
// nearest even for bf16, and for int8 truncated toward zero and saturated
// to [-128, 127] (JAX's f32 -> int8, which the reference applies when it
// casts back to the input type).
//
// Layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o like q, each with its
// own batch/head/sequence strides in elements and a unit stride along D, so
// the model's (B, S, H, D) projections are read in place without a
// transpose copy.  GQA reads KV head h / (Hq / Hkv) directly: the mapping
// of the reference's jnp.repeat, without the repeated copy.
//
// What bounds it on the card: at the prefill shape (4, 32, 512, 96) bf16
// causal the function moves ~50 MB (15 us at 3.35 TB/s) and needs ~6.4
// GFLOP (6.5 us at 989 TFLOP/s), so the bound is the bytes.
//
// Two routes, chosen by the inputs' dtype alone (the wrapper,
// kernels/flash_attention.py `flash_plan`, states and counts them):
//
//   bf16        `flash_tc`: tensor cores (wgmma), Q/K/V tiles brought into
//               shared memory by TMA, warp-specialised (below).
//   f32, int8   `flash_fwd`: FP32 FMAs on the CUDA cores.  f32 stays there
//               because TF32 keeps about three decimal digits, against the
//               f32 tolerance of 1e-4.  int8 stays there because its output
//               is truncated to an integer: P rounded to bf16 for the
//               tensor cores puts errors near 1e-2 on values of size ~8,
//               which would move outputs across integers where the f32
//               route is exact.
//
// ---- flash_tc (bf16) -----------------------------------------------------
//
// A persistent grid, one CTA per SM, walks the work items (b*h, 128-row
// query tile); in causal runs the items with the most KV tiles come first,
// so the last wave holds the shortest ones.  A CTA has three warpgroups:
// warpgroup 2 is the producer (setmaxnreg 40), one thread of which issues
// every TMA load; warpgroups 0 and 1 are the consumers (setmaxnreg 232),
// each owning 64 query rows.  Q (128 rows) has one buffer, released by the
// consumers after their last S = Q K^T of an item, so the next item's Q
// loads during the last P V and the epilogue.  K and V tiles of BK = 128
// keys go through a 2-stage ring each, with full/empty mbarriers.
//
// Per KV tile a consumer warpgroup computes S (64 x 128, f32) with
// wgmma m64n128k16, Q and K both K-major in shared memory (D / 16 steps);
// masks it (columns >= sk take no part; causally masked ones score NEG_INF
// and enter the max, as flash_fwd does); runs the online softmax on the
// accumulator fragment in registers (a row's max over its quad by
// shuffles; the sum kept per thread and reduced once at the end; scale
// folded with log2(e) into exp2); rounds P to bf16 in registers, where
// wgmma's f32 accumulator layout is its A-operand layout; and adds P V
// with wgmma m64n{D}k16, P from registers and V read N-major through the
// descriptor's transpose bit, so V is never transposed in memory.  P is
// rounded to bf16 as FlashAttention-2/3 do, while the normaliser l sums the
// f32 P.  Tiles wholly above the diagonal are skipped per CTA by the
// producer and per warpgroup by the consumers.
//
// Shared-memory layout: a tile row of D bf16 does not fit one 128-byte
// swizzle row at D = 96 (192 bytes), so each tile is kept as D / C boxes of
// C columns, C = 64 with the 128-byte swizzle at D = 64 and 128, C = 32
// with the 64-byte swizzle at D = 32 and 96 (CUTLASS's choice for such a
// K).  TMA writes one box per load, the tensor maps are 4-D over
// (D, S, H, B) with the caller's strides, and rows past sq / sk are filled
// with zeros.
//
// ---- flash_fwd (f32, int8) -----------------------------------------------
//
// One CTA of 256 threads per (b*h, 64-row query tile); the reference's
// sequential kv grid axis becomes a loop over 64-row KV tiles inside the
// CTA.  Q, K, V and the probability tile are staged in shared memory as
// f32; thread t owns rows 4*(t/16)..+3 and columns t%16 + 16*j of both the
// score tile and the output accumulator, so a row's max and sum reduce over
// one half-warp with shuffles.  Its products run from shared memory (two
// shared loads per two FMAs), so shared-memory bandwidth and the FP32 pipe
// bound it, far above the bytes bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"
#include "sm90.cuh"

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

// The CUDA-core route.  dtype: 0 = float32, 2 = int8 (bfloat16 takes
// flash_tc_launch).  Strides are in elements.  Returns -1 for arguments the
// route does not take (the wrapper raises ValueError first), else the
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
  if (hkv <= 0 || hq % hkv != 0 || (dtype != 0 && dtype != 2)) return -1;
  Params p{q, k, v, o, hq, hq / hkv, sq, sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_d<float>(p, b * hq, d, s)
                          : launch_d<int8_t>(p, b * hq, d, s));
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;             // query rows per CTA: 2 warpgroups x 64
constexpr int BK = 128;             // keys per KV tile (wgmma's N for S)
constexpr int STAGES = 2;           // K and V ring depth
constexpr int NTHREADS = 384;       // consumer WG 0, 1; producer WG 2
constexpr int SMEM_ALIGN = 1024;    // the 128-byte swizzle's period
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The CTA's tiles at head dim D.  kernels/flash_attention.py `flash_plan`
// states the same numbers; chip_smoke.py holds it against `flash_tc_tile`.
template <int D>
struct Tile {
  static constexpr int SW = D % 64 == 0 ? 128 : 64;  // swizzle = box row bytes
  static constexpr int COLS = SW / 2;                 // bf16 columns per box
  static constexpr int BOXES = D / COLS;
  static constexpr int KSTEPS = COLS / 16;            // k16 steps per box
  static constexpr uint64_t DESC = SW == 128 ? DESC_SW128 : DESC_SW64;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BARS = 8 * (2 + 4 * STAGES);
  static constexpr int SMEM =
      SMEM_ALIGN + Q_BYTES + 2 * STAGES * KV_BYTES + BARS;
};

struct Params {
  void* o;
  int bh, hq, group, sq, sk, nq, items;
  int64_t o_sb, o_sh, o_ss;
  float scale_log2;   // softmax scale * log2(e): scores go through exp2
  int causal;
};

struct Item {
  int b, h, q0;
};

// Work item w.  Causal: all heads' last query tiles first (the most KV
// tiles), then the tiles before them; otherwise a head's tiles in a row.
__device__ __forceinline__ Item item_of(const Params& p, int w) {
  int qt, bh;
  if (p.causal) {
    qt = p.nq - 1 - w / p.bh;
    bh = w % p.bh;
  } else {
    qt = w % p.nq;
    bh = w / p.nq;
  }
  return Item{bh / p.hq, bh % p.hq, qt * BQ};
}

// KV tiles that query rows [.., row_end) see.
__device__ __forceinline__ int kv_tiles(const Params& p, int row_end) {
  const int n = p.causal ? min(p.sk, row_end) : p.sk;
  return (n + BK - 1) / BK;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// m64nNk16, f32 += bf16 x bf16.  ss: A and B from shared memory, both
// K-major (S = Q K^T, N = BK).  rs: A from registers, B N-major
// (O += P V, N = D).

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  if constexpr (D == 96) wgmma_rs_n96(o, a, db);
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_tc(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const Params p) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  // Q: box j at sQ + j * BQ * SW; K/V stage s: box j at + s * KV_BYTES +
  // j * BK * SW.  Each box is a block of rows of SW bytes.
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;
  const uint32_t sV = sK + STAGES * T::KV_BYTES;
  const uint32_t bars = sV + STAGES * T::KV_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const auto k_full = [&](int s) { return bars + 16 + 8 * s; };
  const auto k_empty = [&](int s) { return bars + 16 + 8 * (STAGES + s); };
  const auto v_full = [&](int s) { return bars + 16 + 8 * (2 * STAGES + s); };
  const auto v_empty = [&](int s) {
    return bars + 16 + 8 * (3 * STAGES + s);
  };

  if (threadIdx.x == 0) {
    // every empty barrier takes one arrive from each of the 8 consumer warps
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int it = 0, n = 0;  // KV tiles and items loaded so far
      for (int w = blockIdx.x; w < p.items; w += gridDim.x, ++n) {
        const Item item = item_of(p, w);
        const int hk = item.h / p.group;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int j = 0; j < T::BOXES; ++j)
          tma_load_4d(sQ + j * BQ * T::SW, &map_q, j * T::COLS, item.q0,
                      item.h, item.b, q_full);
        const int nkv = kv_tiles(p, min(item.q0 + BQ, p.sq));
        for (int t = 0; t < nkv; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;
          const uint32_t off = s * T::KV_BYTES;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), T::KV_BYTES);
          for (int j = 0; j < T::BOXES; ++j)
            tma_load_4d(sK + off + j * BK * T::SW, &map_k, j * T::COLS,
                        t * BK, hk, item.b, k_full(s));
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
          for (int j = 0; j < T::BOXES; ++j)
            tma_load_4d(sV + off + j * BK * T::SW, &map_v, j * T::COLS,
                        t * BK, hk, item.b, v_full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // Accumulator element i of this thread (S and O alike) is row
    // r_lo + 8 ((i / 2) % 2) of the warpgroup's 64, column
    // c_lo + 8 (i / 4) + i % 2 (wgmma's f32 accumulator layout).
    const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < p.items; w += gridDim.x, ++n) {
      const Item item = item_of(p, w);
      const int row0 = item.q0 + 64 * wg;   // the warpgroup's first row
      const int nkv = kv_tiles(p, min(item.q0 + BQ, p.sq));
      // KV tiles this warpgroup computes: those below its diagonal
      const int nw = row0 >= p.sq ? 0 : kv_tiles(p, min(row0 + 64, p.sq));
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      mbar_wait(q_full, n & 1);
      for (int j = 0; j < nkv; ++j, ++it) {
        const int s = it % STAGES;
        const uint32_t parity = (it / STAGES) & 1;
        const bool compute = j < nw;
        float sc[BK / 2];
        mbar_wait(k_full(s), parity);
        if (compute) {
          // S = Q K^T over D / 16 k16 steps
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int box = kk / T::KSTEPS, step = kk % T::KSTEPS;
            const uint64_t da = smem_desc(
                sQ + box * BQ * T::SW + wg * 64 * T::SW + step * 32, 16,
                8 * T::SW, T::DESC);
            const uint64_t db = smem_desc(
                sK + s * T::KV_BYTES + box * BK * T::SW + step * 32, 16,
                8 * T::SW, T::DESC);
            wgmma_ss_n128(sc, da, db, kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
        }
        __syncwarp();
        if (lane == 0) {
          // Q is free once this warpgroup's last S is done
          if (j == max(nw, 1) - 1) mbar_arrive(q_empty);
          mbar_arrive(k_empty(s));
        }

        uint32_t pa[BK / 4];   // P as bf16 pairs: wgmma's A fragment
        if (compute) {
          const int k0 = j * BK;
          const bool ragged = k0 + BK > p.sk;
          const bool diag = p.causal && k0 + BK - 1 > row0;
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            float x = sc[i] * p.scale_log2;
            if (ragged || diag) {
              const int qi = row0 + r_lo + 8 * ((i / 2) % 2);
              const int kj = k0 + c_lo + 8 * (i / 4) + i % 2;
              if (p.causal && qi < kj) x = NEG_INF;
              if (kj >= p.sk) x = -INFINITY;   // takes no part
            }
            sc[i] = x;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int i = 2 * r; i < BK / 2; i += 4)
              mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            const float corr = fast_exp2(m[r] - m_new);
            m[r] = m_new;
            float rs = 0.f;
#pragma unroll
            for (int i = 2 * r; i < BK / 2; i += 4) {
              sc[i] = fast_exp2(sc[i] - m_new);
              sc[i + 1] = fast_exp2(sc[i + 1] - m_new);
              rs += sc[i] + sc[i + 1];
            }
            l[r] = l[r] * corr + rs;   // this thread's columns only
#pragma unroll
            for (int i = 2 * r; i < D / 2; i += 4) {
              o[i] *= corr;
              o[i + 1] *= corr;
            }
          }
#pragma unroll
          for (int i = 0; i < BK / 4; ++i)
            pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        }

        mbar_wait(v_full(s), parity);
        if (compute) {
          // O += P V over BK / 16 k16 steps
#pragma unroll
          for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
          for (int i = 0; i < BK / 4; ++i) fence_operand(pa[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t db =
                smem_desc(sV + s * T::KV_BYTES + kk * 16 * T::SW,
                          BK * T::SW, 8 * T::SW, T::DESC);
            wgmma_pv<D>(o, &pa[4 * kk], db);
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
          for (int i = 0; i < BK / 4; ++i) fence_operand(pa[i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(s));
      }

      // Epilogue: the row sums over the quad, O / l rounded to bf16 and
      // stored in q's layout; rows past sq are not stored.
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                           item.b * p.o_sb + item.h * p.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float li = lr == 0.f ? 1.f : lr;   // fully-masked rows
        const int qi = row0 + r_lo + 8 * r;
        if (qi >= p.sq) continue;
        __nv_bfloat16* orow = out + qi * p.o_ss + c_lo;
#pragma unroll
        for (int i = 2 * r; i < D / 2; i += 4) {
          const uint32_t v = pack_bf16(o[i] / li, o[i + 1] / li);
          *reinterpret_cast<uint32_t*>(orow + 8 * (i / 4)) = v;
        }
      }
    }
  }
}

// A (B, H, S, D) bf16 tensor with element strides (sb, sh, ss, 1) as a 4-D
// map over (D, S, H, B), read in boxes of (cols, rows, 1, 1) with the
// swizzle of `sw` bytes; rows past S are filled with zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int h,
                int b, int64_t sb, int64_t sh, int64_t ss, int cols,
                int rows, int sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  int b, hq, hkv, sq, sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// One launch: one CTA per SM (at most one per item), each walking items
// blockIdx.x, + gridDim.x, ...
template <int D>
int launch(const Args& a, const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (!(tensor_map(&map_q, a.q, D, a.sq, a.hq, a.b, a.q_sb, a.q_sh, a.q_ss,
                   T::COLS, BQ, T::SW) &&
        tensor_map(&map_k, a.k, D, a.sk, a.hkv, a.b, a.k_sb, a.k_sh, a.k_ss,
                   T::COLS, BK, T::SW) &&
        tensor_map(&map_v, a.v, D, a.sk, a.hkv, a.b, a.v_sb, a.v_sh, a.v_ss,
                   T::COLS, BK, T::SW)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = p.items < sms ? p.items : sms;
  flash_tc<D><<<grid, NTHREADS, T::SMEM, stream>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }
bool stride16(int64_t s) { return s > 0 && s % 8 == 0; }   // 16 bytes

template <int D>
int tile(int* out) {
  using T = Tile<D>;
  const int got[4] = {BQ, BK, STAGES, T::SMEM};
  for (int i = 0; i < 4; ++i) out[i] = got[i];
  return 0;
}

}  // namespace tc

// The tensor-core route's CTA tile at head dim d: BQ, BK, stages and
// dynamic shared-memory bytes, written to out[0..3].  Returns -1 for a
// head dim the route does not take, else 0.  The wrapper's `flash_plan`
// must state the same numbers.
extern "C" int flash_tc_tile(int d, int* out) {
  return d == 32    ? tc::tile<32>(out)
         : d == 64  ? tc::tile<64>(out)
         : d == 96  ? tc::tile<96>(out)
         : d == 128 ? tc::tile<128>(out)
                    : -1;
}

// The tensor-core route (bfloat16): attention of q (b, hq, sq, d) against
// k/v (b, hkv, sk, d) into o, all bf16 with element strides (sb, sh, ss)
// and a unit stride along d.  Returns -1 for arguments the route does not
// take (the rules of the wrapper's `flash_plan`; it raises ValueError
// first): d not in {32, 64, 96, 128}, a base address or a stride that is
// not a multiple of 16 bytes, an empty or oversized grid, hq not a
// multiple of hkv.  Else the launch's cudaError_t (0 on success); runs on
// `stream` and does not synchronise.
extern "C" int flash_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    int b, int hq, int hkv, int sq, int sk, int d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale, int causal, void* stream) {
  const int64_t nq = ((int64_t)sq + tc::BQ - 1) / tc::BQ;
  const int64_t items = (int64_t)b * hq * nq;
  const bool ok =
      (d == 32 || d == 64 || d == 96 || d == 128) && b > 0 && hq > 0 &&
      hkv > 0 && hq % hkv == 0 && sq > 0 && sk > 0 && items < (1ll << 31) &&
      tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
      tc::aligned16(o) && tc::stride16(q_sb) && tc::stride16(q_sh) &&
      tc::stride16(q_ss) && tc::stride16(k_sb) && tc::stride16(k_sh) &&
      tc::stride16(k_ss) && tc::stride16(v_sb) && tc::stride16(v_sh) &&
      tc::stride16(v_ss) && o_ss % 2 == 0;
  if (!ok) return -1;
  const tc::Args a{q, k, v, b, hq, hkv, sq, sk, q_sb, q_sh, q_ss,
                   k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const tc::Params p{o, b * hq, hq, hq / hkv, sq, sk, (int)nq, (int)items,
                     o_sb, o_sh, o_ss, scale * tc::LOG2E, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 32   ? tc::launch<32>(a, p, s)
         : d == 64 ? tc::launch<64>(a, p, s)
         : d == 96 ? tc::launch<96>(a, p, s)
                   : tc::launch<128>(a, p, s);
}
