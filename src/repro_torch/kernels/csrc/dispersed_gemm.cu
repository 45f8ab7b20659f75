// Grouped and dispersed GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/dispersed_gemm.py:
//
//   K3 `matmul_grouped` (:117, body `_grouped_kernel` :98, pallas_call
//      :133): C = A @ B with the f32 accumulators of W row tiles kept on
//      chip for the whole K loop; the B panel is fetched once per
//      (group, k) and applied to all W tiles; C is written once, at A's
//      type.
//   K4 `matmul_dispersed` (:164, body `_dispersed_kernel` :148,
//      pallas_call :178): the W = 0 extreme; the f32 C tile is read from
//      and written back to device memory on every k step.
//
// Two routes, chosen by the inputs' dtype alone (the wrapper,
// kernels/dispersed_gemm.py, states and counts them):
//
//   bf16, int8  `gemm_tc`: tensor cores (wgmma), A and B staged through a
//               ring of shared-memory stages by a producer warpgroup.
//   f32         `gemm_rows`: FP32 FMAs on the CUDA cores.  TF32 would keep
//               about three decimal digits, too few for the f32 tolerance.
//
// What bounds them on this card, at granite-8b's MLP GEMM (8192 x 4096 x
// 14336, bf16, block_m 128, block_k 512): 0.96 TFLOP, 0.97 ms at the
// 989 TFLOP/s bf16 tensor-core peak, while the bytes (each input read
// once, C written once: 0.42 GB) take 0.13 ms at 3.35 TB/s.  So K3 is
// bound by operations, 0.97 ms.  K4 is bound by its schedule's bytes: the
// f32 C tile round-trips through device memory on each of nk = 8 steps,
// 7.70 GB in all, 2.30 ms.
//
// ---- gemm_tc -------------------------------------------------------------
//
// A CTA owns a block_m x n_tile tile of C (n_tile = 256 at block_m 64 or
// 128, 128 at block_m 256; it never depends on W) and keeps its f32
// accumulators in the registers of two consumer warpgroups, at most 128 a
// thread.  K runs in chunks of 64 (one 128-byte swizzle row of bf16).  A
// ring of 4-5 stages (2-4 in FILL launches) holds each chunk's A (block_m
// x 64, K-major) and B (64 x n_tile, N-major, as 64-column boxes); wgmma
// reads B N-major through the descriptor's transpose bit, so B is never
// copied.  Warpgroup 2 is the producer (setmaxnreg 56), warpgroups 0 and 1
// the consumers (setmaxnreg 224); full/empty mbarriers hand the stages
// over.
//
//   K3: one launch.  The W row tiles of a group are the W CTAs of one
//       thread-block cluster (W <= 8).  bf16: each CTA's producer loads
//       its own A by TMA and 1/W of the B chunk (whole 64-column boxes) by
//       a TMA multicast to all W CTAs, so each (64, n_tile) B chunk leaves
//       device memory once per (group, k): the reference's "B panel
//       fetched once per (group, k), reused W times" in the card's own
//       hardware.  A stage is free again only when the consumers of every
//       CTA of the cluster have released it: each consumer warp arrives on
//       the `empty` barrier of every CTA (mapa + a remote arrive).  With
//       W > 1 the clusters are persistent (see `launch`).
//   K4: one launch per k step (block_k), cluster of 1.  Blocks of a launch
//       run in no order, so the reference's k-outermost grid becomes a
//       sequence of launches.  The step's tiles start from the f32 C
//       buffer in device memory (except on step 0), run the same main loop
//       over the step's k range, then spill the tile back as f32, or on
//       the last step write A's type.  After step 0 the fill goes through
//       shared memory (FILL below), loaded while the previous tile
//       computes.  No register holds C across launches: the spill/fill
//       traffic is real.
//
// int8: wgmma's integer form takes B only K-major, and TMA cannot read a
// (k, n) int8 B whose row stride (n bytes) is not a multiple of 16 (n = 200
// is such a case).  So for int8 the producer warpgroup loads A and B with
// ordinary loads and converts them to bf16 on staging, writing the same
// swizzled layout TMA would; the consumers are the bf16 ones.  bf16 holds
// -128..127 exactly, every product is exact, and the sums are integers
// below 2^24, exact in f32, so the int8 result is bit-exact.  The int8
// route does not multicast: each CTA stages its own B (the L2 serves the
// W - 1 repeats).
//
// Summation order: every element of C is the same sequence of wgmmas
// (k16 steps over k = 0, 16, ..., K-16) whatever W or block_k, and a fill
// restores the accumulators exactly, so K3's output is bitwise independent
// of W and K4's output bitwise equal to K3's at the same block_m.  It
// differs from an f32 FMA chain (the plain twin's order) by f32 rounding.
// The output is rounded to nearest even for bf16 and, for int8, truncated
// toward zero and saturated to [-128, 127], as JAX's f32 -> int8 does.
//
// ---- gemm_rows (f32) -----------------------------------------------------
//
// A CTA owns `rows` consecutive rows of C and a slice of `cols` = 16384 /
// rows columns, i.e. 16384 f32 accumulators in registers (8 x 8 per
// thread, 256 threads).  It walks k in [k_begin, k_end) in chunks of KC:
// each chunk of A (rows x KC) and of B (KC x cols) is staged once in shared
// memory and every thread applies it to its 8 x 8 accumulators.
// K3 is one launch with rows = W * block_m; K4 one launch per k step with
// rows = block_m, C in an f32 buffer read and written each step.  Every
// element of C is one chain of f32 FMAs over k = 0, 1, ..., K-1, so K3 is
// bitwise independent of W here too.  Its CTA re-reads A once per N slice
// (448 slices at W = 4, block_m 128, n = 14336), which the L2 may absorb;
// FP32 FMAs peak at 67 TFLOP/s, so this route cannot come near the
// tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"
#include "sm90.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int ACC_PER_CTA = 16384;  // rows * cols, 64 per thread
constexpr int KC = 16;              // k per shared-memory chunk
constexpr int PAD = 4;              // A rows padded: fewer bank conflicts

struct Params {
  const float* a;
  const float* b;
  float* acc;   // C buffer (K4), read when load_acc, written otherwise
  float* out;   // C, written when store_out
  int m, n, k, k_begin, k_end, rows, cols, load_acc, store_out;
};

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
      As[kk * AS + r] = kg < p.k_end ? p.a[(size_t)(row0 + r) * p.k + kg]
                                     : 0.f;
    }
    for (int i = tid; i < KC * NS; i += NTHREADS) {
      const int kk = i / NS, c = i % NS, kg = kc + kk, cg = col0 + c;
      Bs[kk * NS + c] =
          (kg < p.k_end && cg < p.n) ? p.b[(size_t)kg * p.n + cg] : 0.f;
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

  float* out = p.store_out ? p.out : p.acc;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (cc[j] < p.n) out[(size_t)rr[i] * p.n + cc[j]] = acc[i][j];
}

}  // namespace

// f32 C rows [0, m) of A (m, k) @ B (k, n), both row-major, over
// k in [k_begin, k_end).  `rows` (a power of two in [8, 2048] dividing m)
// is the CTA's row count.  load_acc: start from `acc` ((m, n)) instead of
// 0.  store_out: write `out`, else write `acc`.  dtype must be 0 (float32:
// bf16 and int8 take gemm_tc_launch).  Returns -1 for arguments the kernel
// does not take (the wrapper raises ValueError), else the launch's
// cudaError_t (0 on success); runs on `stream` and does not synchronise.
extern "C" int gemm_rows_launch(const void* a, const void* b, float* acc,
                                void* out, int m, int n, int k, int k_begin,
                                int k_end, int rows, int load_acc,
                                int store_out, int dtype, void* stream) {
  if (dtype != 0 || rows < 8 || rows > 2048 || (rows & (rows - 1)) ||
      m % rows || k_begin < 0 || k_begin >= k_end || k_end > k || n <= 0)
    return -1;
  const Params p{static_cast<const float*>(a), static_cast<const float*>(b),
                 acc, static_cast<float*>(out), m, n, k, k_begin, k_end,
                 rows, ACC_PER_CTA / rows, load_acc, store_out};
  const size_t smem = sizeof(float) * KC * (p.rows + PAD + p.cols);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + p.cols - 1) / p.cols, p.m / p.rows);
  gemm_rows<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, int8).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int KCHUNK = 64;              // k per stage: 128 bytes of bf16
constexpr int ROW_BYTES = KCHUNK * 2;   // one swizzled smem row
constexpr int BOX_BYTES = 64 * ROW_BYTES;  // a 64 x 64 bf16 TMA box
constexpr int NTHREADS = 384;           // consumer WG 0, 1; producer WG 2
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT = 232448;      // a block's shared memory on sm_90
constexpr int SMEM_ALIGN = 1024;        // the 128-byte swizzle's period
constexpr int MAX_STAGES = 5;
constexpr int BAND_ROWS = 2048;         // rows of C per rasterisation band

// The CTA tile and how the two consumer warpgroups split it.  n_tile
// depends on block_m only, never on W.  FILL: K4's launches that start
// from the f32 C buffer keep a block_m x n_tile f32 C tile in shared
// memory beside fewer stages.  kernels/dispersed_gemm.py `tc_plan` states
// the same numbers; chip_smoke.py holds it against `gemm_tc_tile`.
template <int BM, bool FILL = false>
struct Tile {
  static constexpr int BN = BM == 256 ? 128 : 256;
  static constexpr int WG_M = BM == 64 ? 64 : BM / 2;   // rows per WG
  static constexpr int WG_N = BM == 64 ? BN / 2 : BN;   // columns per WG
  static constexpr int MT = WG_M / 64;                  // m64 tiles per WG
  static constexpr int ACC = WG_N / 2;                  // f32 per m64 tile
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_BYTES = FILL ? BM * BN * 4 : 0;
  static constexpr int C_BOX = 32;   // f32 C box: 32 x 32, 128-byte rows
  static constexpr int BARS = 16;                       // two mbarriers
  static constexpr int FIT =
      (SMEM_LIMIT - SMEM_ALIGN - C_BYTES - (FILL ? BARS : 0)) /
      (STAGE_BYTES + BARS);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = SMEM_ALIGN + STAGES * (STAGE_BYTES + BARS) +
                              C_BYTES + (FILL ? BARS : 0);
};

struct Params {
  const void* a;   // read directly by the int8 producer
  const void* b;
  float* acc;      // f32 C buffer (K4): read when load_acc, written unless
                   // store_out
  void* out;       // C at A's type, written when store_out
  int m, n, k, k_begin, k_end, load_acc, store_out;
  int cluster;     // W: CTAs of a cluster, the row tiles of a group
  int nb;          // n tiles
  int band;        // groups per rasterisation band
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// Arrive on the barrier at the same offset in CTA `rank` of the cluster.
// The arrive has the default .release.cta semantics: what it orders is the
// wgmma's reads of the stage, complete by then; .release.cluster made K3's
// clustered main loop markedly slower on an H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
               :: "r"(remote) : "memory");
}

// The same box written to `dst` and signalled on `bar` in every CTA of
// `mask`.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// m64nNk16, f32 += bf16 x bf16; A K-major, B N-major (transpose bit set).

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                  uint64_t db) {
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
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_from_int8(uint32_t w, int shift) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)(int8_t)(w >> shift), (float)(int8_t)(w >> (shift + 8)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight int8 values as eight bf16 (exact), one 16-byte chunk.
__device__ __forceinline__ uint4 bf16x8_from_int8(uint2 v) {
  return make_uint4(bf16x2_from_int8(v.x, 0), bf16x2_from_int8(v.x, 16),
                    bf16x2_from_int8(v.y, 0), bf16x2_from_int8(v.y, 16));
}

// The int8 producer: one stage's A (BM x 64) and B (64 x BN) read with
// ordinary loads, widened to bf16 and written in the layout a 128-byte-
// swizzled TMA load gives (16-byte chunk c of row r at chunk c ^ (r % 8)).
// NT producer threads share the work; loads go in batches so that
// several are in flight per thread.
template <int BM, int NT>
__device__ __forceinline__ void stage_int8(const Params& p, uint32_t sa,
                                           uint32_t sb, int row0, int col0,
                                           int kc, int pt) {
  using T = Tile<BM>;
  constexpr int BATCH = 4;
  constexpr int A_CHUNKS = BM * KCHUNK / 8;
  constexpr int B_ROW_CHUNKS = T::BN / 8;
  constexpr int B_CHUNKS = KCHUNK * B_ROW_CHUNKS;
  const int8_t* A = static_cast<const int8_t*>(p.a);
  const int8_t* B = static_cast<const int8_t*>(p.b);
  for (int i0 = pt; i0 < A_CHUNKS; i0 += NT * BATCH) {
    uint2 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * NT, r = i >> 3, c = i & 7;
      if (i < A_CHUNKS)
        v[j] = *reinterpret_cast<const uint2*>(
            A + (size_t)(row0 + r) * p.k + kc + c * 8);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * NT, r = i >> 3, c = i & 7;
      if (i < A_CHUNKS)
        st_shared_v4(sa + r * ROW_BYTES + ((c ^ (r & 7)) << 4),
                     bf16x8_from_int8(v[j]));
    }
  }
  const bool vec = p.n % 8 == 0;
  for (int i0 = pt; i0 < B_CHUNKS; i0 += NT * BATCH) {
    uint2 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * NT, kr = i / B_ROW_CHUNKS;
      const int col = col0 + (i % B_ROW_CHUNKS) * 8;
      const int8_t* src = B + (size_t)(kc + kr) * p.n + col;
      v[j] = make_uint2(0, 0);
      if (i >= B_CHUNKS || col >= p.n) continue;
      if (vec) {
        v[j] = *reinterpret_cast<const uint2*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < p.n) {
            const uint32_t byte = (uint8_t)src[e];
            if (e < 4) v[j].x |= byte << (8 * e);
            else v[j].y |= byte << (8 * (e - 4));
          }
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * NT, kr = i / B_ROW_CHUNKS;
      const int cc = i % B_ROW_CHUNKS, box = cc >> 3, c = cc & 7;
      if (i < B_CHUNKS)
        st_shared_v4(sb + box * BOX_BYTES + kr * ROW_BYTES +
                         ((c ^ (kr & 7)) << 4),
                     bf16x8_from_int8(v[j]));
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, int n, int r, int c,
                                           float x, float y) {
  T* q = out + (size_t)r * n + c;
  if (c < n) store(q, x);
  if (c + 1 < n) store(q + 1, y);
}

// K4's f32 spill: n is a multiple of 4 (the C buffer's rows are read by
// TMA), so a pair is all in or all out.
__device__ __forceinline__ void store_pair(float* out, int n, int r, int c,
                                           float x, float y) {
  if (c < n)
    *reinterpret_cast<float2*>(out + (size_t)r * n + c) = make_float2(x, y);
}

// The origin (row, column) in C of cluster tile `ct` for the CTA of
// cluster rank `rank`.  Cluster tile ct is group g's W row tiles x n tile
// j; the cluster tiles are rasterised in bands of p.band groups along M, so
// that the tiles in flight at one time share A rows and B columns in L2.
template <int BM>
__device__ __forceinline__ int2 tile_origin(const Params& p, int ct,
                                            int rank) {
  const int groups = p.m / BM / p.cluster;
  const int band = ct / (p.band * p.nb), idx = ct % (p.band * p.nb);
  const int band_groups = min(p.band, groups - band * p.band);
  return make_int2(
      ((band * p.band + idx % band_groups) * p.cluster + rank) * BM,
      (idx / band_groups) * Tile<BM>::BN);
}

// Each cluster walks the cluster tiles ct = its index, + the number of
// clusters, ... (one tile when the grid has a cluster per tile); the
// producer's stage ring runs on across tiles, so it loads the next tile
// while the consumers store the last one.
//
// FILL (K4 after its first k step): the producer also loads each tile's
// f32 C by TMA into shared memory (`map_c`: 32 x 32 boxes, 128-byte
// swizzle), so that the fill of tile t + 1 overlaps the wgmmas of tile t;
// the consumers copy it into their accumulators.  The next tile's C goes
// out in 32-row pieces spread over the current tile's chunks: loaded at
// once, its 128 KB held up the A and B chunks queued behind it.  The fill
// is still a read of the whole f32 tile from device memory on every k
// step.
template <int BM, bool INT8, bool FILL>
__global__ void __launch_bounds__(NTHREADS, 1)
    gemm_tc(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_c, const Params p) {
  using T = Tile<BM, FILL>;
  using OutT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  constexpr int S = T::STAGES;
  constexpr int STAGERS = INT8 ? 128 : 1;  // producer threads staging A, B
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const uint32_t cbuf = base + S * T::STAGE_BYTES;  // the f32 C tile (FILL)
  // full[S], empty[S], then (FILL) c_full, c_empty
  const uint32_t bars = cbuf + T::C_BYTES;
  const uint32_t c_full = bars + 16 * S, c_empty = c_full + 8;
  const int W = p.cluster;
  const int rank = W > 1 ? (int)cluster_rank() : 0;
  const int tiles = (p.m / BM / W) * p.nb, clusters = gridDim.x / W;
  const int nchunks = (p.k_end - p.k_begin) / KCHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, STAGERS);
      mbar_init(bars + 8 * (S + s), 8 * W);  // 8 consumer warps per CTA
    }
    if (FILL) {
      mbar_init(c_full, 1);
      mbar_init(c_empty, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (W > 1)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    const int pt = threadIdx.x - 256;
    if (pt < STAGERS) {
      // FILL: rows [32 g, 32 g + 32) of a tile's C, box column j at
      // cbuf + j * BM * 128 + g * 32 * 128 (the layout of one BM-row box);
      // the pieces of fill n wait for the consumers to have copied fill
      // n - 1.
      const auto load_c = [&](int2 o, int g) {
        for (int j = 0; j < T::BN / T::C_BOX; ++j)
          tma_load(cbuf + (j * BM + g * T::C_BOX) * ROW_BYTES, &map_c,
                   o.y + j * T::C_BOX, o.x + g * T::C_BOX, c_full);
      };
      const auto wait_c = [&](int n) {
        mbar_wait(c_empty, (n & 1) ^ 1);
        mbar_expect_tx(c_full, T::C_BYTES);
      };
      constexpr int GROUPS = BM / T::C_BOX;
      const int first = nchunks > 1 ? 1 : 0;   // chunk of the first piece
      const int step = nchunks - first;
      int it = 0;  // chunks loaded so far: stage it % S, round it / S
      int tcount = 0;
      for (int ct = blockIdx.x / W; ct < tiles; ct += clusters, ++tcount) {
        const int2 o = tile_origin<BM>(p, ct, rank);
        const bool next = FILL && pt == 0 && ct + clusters < tiles;
        const int2 on = next ? tile_origin<BM>(p, ct + clusters, rank) : o;
        for (int c = 0; c < nchunks; ++c, ++it) {
          const int s = it % S;
          const uint32_t full = bars + 8 * s, empty = bars + 8 * (S + s);
          const uint32_t sa = base + s * T::STAGE_BYTES, sb = sa + T::A_BYTES;
          const int kc = p.k_begin + c * KCHUNK;
          mbar_wait(empty, ((it / S) & 1) ^ 1);
          if constexpr (INT8) {
            stage_int8<BM, STAGERS>(p, sa, sb, o.x, o.y, kc, pt);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive(full);
          } else {
            mbar_expect_tx(full, T::STAGE_BYTES);
            tma_load(sa, &map_a, kc, o.x, full);
            for (int j = rank; j < T::BN / 64; j += W) {
              if (W == 1)
                tma_load(sb + j * BOX_BYTES, &map_b, o.y + j * 64, kc, full);
              else
                tma_load_multicast(sb + j * BOX_BYTES, &map_b, o.y + j * 64,
                                   kc, full, (uint16_t)((1u << W) - 1));
            }
          }
          if (FILL && pt == 0 && tcount == 0 && c == 0) {
            wait_c(0);  // the first tile's C, behind its first chunk
            for (int g = 0; g < GROUPS; ++g) load_c(o, g);
          }
          if (next && c >= first) {
            if (c == first) wait_c(tcount + 1);
            for (int g = c - first; g < GROUPS; g += step) load_c(on, g);
          }
        }
      }
    }
    if (W > 1) cluster_sync();  // no peer may still arrive here
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int wr = BM == 64 ? 0 : wg * T::WG_M;  // the WG's rows and
    const int wc = BM == 64 ? wg * T::WG_N : 0;  // columns in the tile
    int it = 0, tcount = 0;
    for (int ct = blockIdx.x / W; ct < tiles; ct += clusters, ++tcount) {
      const int2 o = tile_origin<BM>(p, ct, rank);
      // acc[mt][i] is C[r][c] with r = rb + 64 mt + 8 ((i / 2) % 2) and
      // c = cb + 8 (i / 4) + i % 2 (wgmma's f32 accumulator layout).
      const int rb = o.x + wr + warp * 16 + lane / 4;
      const int cb = o.y + wc + 2 * (lane % 4);
      float acc[T::MT][T::ACC];
      if constexpr (FILL) {
        // acc[mt][i], acc[mt][i + 1] sit in one 16-byte chunk of row r of
        // the 32-column box holding column c: chunk (c % 32) / 4, stored at
        // that index ^ (r % 8) by the 128-byte swizzle.
        mbar_wait(c_full, tcount & 1);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int i = 0; i < T::ACC; i += 2) {
            const int r = rb - o.x + 64 * mt + 8 * ((i / 2) % 2);
            const int c = cb - o.y + 8 * (i / 4);
            const uint32_t addr =
                cbuf + (c / T::C_BOX) * BM * ROW_BYTES + r * ROW_BYTES +
                ((((c % T::C_BOX) / 4) ^ (r & 7)) << 4) + (c % 4) * 4;
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                         : "=f"(acc[mt][i]), "=f"(acc[mt][i + 1])
                         : "r"(addr) : "memory");
          }
        // The next tile's TMA (async proxy) may overwrite what was read.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(c_empty);
      } else {
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int i = 0; i < T::ACC; ++i) acc[mt][i] = 0.f;
      }

      // A chunk's wgmmas are waited for before its stage is released.
      // Keeping one group in flight (chunk c - 1's stage released after
      // chunk c's wgmmas are issued) measured no faster for K3 and about
      // 10 % slower for K4 on an H100.
      for (int c = 0; c < nchunks; ++c, ++it) {
        const int s = it % S;
        mbar_wait(bars + 8 * s, (it / S) & 1);
        const uint32_t sa = base + s * T::STAGE_BYTES + wr * ROW_BYTES;
        const uint32_t sb =
            base + s * T::STAGE_BYTES + T::A_BYTES + (wc / 64) * BOX_BYTES;
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int i = 0; i < T::ACC; ++i) fence_operand(acc[mt][i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KCHUNK / 16; ++kk) {
          const uint64_t db =
              smem_desc(sb + kk * 16 * ROW_BYTES, BOX_BYTES, 8 * ROW_BYTES);
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const uint64_t da = smem_desc(
                sa + mt * 64 * ROW_BYTES + kk * 32, 16, 8 * ROW_BYTES);
            if constexpr (T::WG_N == 256)
              wgmma_m64n256k16(acc[mt], da, db);
            else
              wgmma_m64n128k16(acc[mt], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int i = 0; i < T::ACC; ++i) fence_operand(acc[mt][i]);
        // Release the stage in every CTA of the cluster: lane q of each
        // consumer warp arrives on CTA q's `empty` barrier.
        const uint32_t empty = bars + 8 * (S + s);
        if (W == 1) {
          if (lane == 0) mbar_arrive(empty);
        } else if (lane < W) {
          mbar_arrive_cluster(empty, lane);
        }
      }

#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int i = 0; i < T::ACC; i += 2) {
          const int r = rb + 64 * mt + 8 * ((i / 2) % 2);
          const int c = cb + 8 * (i / 4);
          if (p.store_out)
            store_pair(static_cast<OutT*>(p.out), p.n, r, c, acc[mt][i],
                       acc[mt][i + 1]);
          else
            store_pair(p.acc, p.n, r, c, acc[mt][i], acc[mt][i + 1]);
        }
    }
    if (W > 1) cluster_sync();
  }
}

// A row-major (outer, inner) bf16 or f32 tensor read in 128-byte-swizzled
// boxes of (box_outer, box_inner); reads past the edge are filled with
// zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, bool f32, int inner,
                int outer, int box_inner, int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int NO_CLUSTER = -2;  // the card holds no cluster of this size

// One launch.  A cluster of one CTA takes one tile: the block scheduler
// then hands out the tiles in order, so the tiles in flight stay within a
// rasterisation band.  Clusters of W > 1 CTAs are persistent, as many as
// the card holds at once (cudaOccupancyMaxActiveClusters), each walking
// its tiles: relaunched per tile, a cluster must wait for W free SMs of
// one GPC.  On an H100 the persistent grid made K3 at W > 1 faster and
// K3 at W = 1 slower (its CTAs drift apart, so the tiles in flight spread
// over more of B).  FILL launches are persistent too, so that the next
// tile's C loads while the current one computes.  Returns a cudaError_t,
// or NO_CLUSTER.
template <int BM, bool INT8, bool FILL>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tile<BM, FILL>;
  CUtensorMap map_a{}, map_b{}, map_c{};
  if (!INT8 && !(tensor_map(&map_a, p.a, false, p.k, p.m, KCHUNK, BM) &&
                 tensor_map(&map_b, p.b, false, p.n, p.k, 64, KCHUNK)))
    return cudaErrorInvalidValue;
  if (FILL &&
      !tensor_map(&map_c, p.acc, true, p.n, p.m, T::C_BOX, T::C_BOX))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tc<BM, INT8, FILL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int resident[MAX_CLUSTER + 1] = {};  // per W; 0: not asked yet
  if (!resident[p.cluster]) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    resident[p.cluster] = n > 0 ? n : -1;
  }
  if (resident[p.cluster] < 0) return NO_CLUSTER;
  const int tiles = (p.m / BM / p.cluster) * p.nb;
  const int clusters =
      (p.cluster == 1 && !FILL) || tiles < resident[p.cluster]
          ? tiles : resident[p.cluster];
  cfg.gridDim = dim3(clusters * p.cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, map_c, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K4's launches that start from the f32 C buffer take the FILL kernel.
template <bool INT8, bool FILL>
int launch_bm(const Params& p, int block_m, cudaStream_t stream) {
  return block_m == 64    ? launch<64, INT8, FILL>(p, stream)
         : block_m == 128 ? launch<128, INT8, FILL>(p, stream)
                          : launch<256, INT8, FILL>(p, stream);
}

template <bool INT8>
int launch_fill(const Params& p, int block_m, cudaStream_t stream) {
  return p.load_acc ? launch_bm<INT8, true>(p, block_m, stream)
                    : launch_bm<INT8, false>(p, block_m, stream);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int BM>
int tile(int fill, int* out) {
  const int got[2][3] = {
      {Tile<BM>::BN, Tile<BM>::STAGES, Tile<BM>::SMEM},
      {Tile<BM, true>::BN, Tile<BM, true>::STAGES, Tile<BM, true>::SMEM}};
  for (int i = 0; i < 3; ++i) out[i] = got[fill ? 1 : 0][i];
  return 0;
}

}  // namespace tc

// The tensor-core route's CTA tile at `block_m` (fill: K4's launches that
// start from the f32 C buffer): n_tile, stages and dynamic shared-memory
// bytes, written to out[0..2].  Returns -1 for a block_m the route does
// not take, else 0.  The wrapper's `tc_plan` must state the same numbers.
extern "C" int gemm_tc_tile(int block_m, int fill, int* out) {
  return block_m == 64    ? tc::tile<64>(fill, out)
         : block_m == 128 ? tc::tile<128>(fill, out)
         : block_m == 256 ? tc::tile<256>(fill, out)
                          : -1;
}

// The tensor-core route: C rows [0, m) of A (m, k) @ B (k, n), both
// row-major, over k in [k_begin, k_end), as block_m x n_tile CTA tiles in
// clusters of `cluster` CTAs along M (K3: W; K4: 1).  load_acc: start
// from `acc` (f32, (m, n)) instead of 0.  store_out: write `out` at the
// input type, else write `acc`.  dtype: 1 = bfloat16, 2 = int8.  Returns
// -1 for arguments the route does not take (the rules of the wrapper's
// `tc_plan`; it raises ValueError first), -2 if the card cannot hold one
// cluster of `cluster` such CTAs, else the launch's cudaError_t (0 on
// success); runs on `stream` and does not synchronise.
extern "C" int gemm_tc_launch(const void* a, const void* b, float* acc,
                              void* out, int m, int n, int k, int k_begin,
                              int k_end, int block_m, int cluster,
                              int load_acc, int store_out, int dtype,
                              void* stream) {
  const bool ok =
      (dtype == 1 || dtype == 2) &&
      (block_m == 64 || block_m == 128 || block_m == 256) && m > 0 &&
      m % block_m == 0 && cluster >= 1 && cluster <= tc::MAX_CLUSTER &&
      (m / block_m) % cluster == 0 && n > 0 && k > 0 && k % tc::KCHUNK == 0 &&
      k_begin >= 0 && k_begin < k_end && k_end <= k &&
      k_begin % tc::KCHUNK == 0 && k_end % tc::KCHUNK == 0 &&
      (dtype == 2 || n % 8 == 0) && ((store_out && !load_acc) || n % 4 == 0) &&
      tc::aligned16(a) && tc::aligned16(b) &&
      tc::aligned16(acc) && (out != nullptr || !store_out) &&
      (acc != nullptr || (!load_acc && store_out));
  if (!ok) return -1;
  const int bn = block_m == 256 ? 128 : 256;
  const int band = tc::BAND_ROWS / block_m / cluster;
  tc::Params p{a, b, acc, out, m, n, k, k_begin, k_end, load_acc,
               store_out, cluster, (n + bn - 1) / bn, band > 1 ? band : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? tc::launch_fill<false>(p, block_m, s)
                    : tc::launch_fill<true>(p, block_m, s);
}
