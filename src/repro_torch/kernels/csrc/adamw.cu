// Fused multi-tensor AdamW for Hopper (sm_90a), plain C interface.
//
// Replaces no kernel of the JAX package: the reference's optim/adamw.py
// `apply_updates` is plain jnp, left to XLA's fusion.  The port's plain
// path (kernels/adamw.py `adamw_plain`) runs it as ~21 torch elementwise
// ops a leaf plus a cast, a square and a sum a leaf for the global norm:
// ~7,300 launches a step over phi3-mini's 291 leaves, each reading and
// writing whole f32 tensors.  This file does the same step in two
// launches over every leaf.
//
// What bounds it on the card: the bytes.  A step reads each gradient
// twice (the norm must be known before the first update) and the f32 m,
// v and master once, and writes those three and the parameter once: 30 B
// a parameter with bf16 gradients and parameters, 34.2 ms for 3.82 B
// parameters at 3.35 TB/s.  The ~20 flops an element are nothing beside
// that.  So each launch moves each byte once, with 16-byte loads and
// stores marked streaming (ld.global.cs / st.global.cs: nothing is
// reused), from a persistent grid that keeps the card's memory busy.
//
// The leaves come as a table of int64 rows (`Field` below; built and
// checked by kernels/adamw.py `work_table`), one row a leaf, uploaded in
// one host-to-device copy a step.  A leaf's elements split into a scalar
// head (until all five of its tensors sit on 16-byte boundaries), groups
// of GROUP = 8 elements read and written by 16-byte vectors, and a scalar
// tail; the wrapper refuses a leaf whose tensors no head aligns together.
// Work items are (leaf, chunk) pairs of at most ITEM_ELEMS elements,
// numbered leaf after leaf; CTA b of the persistent grid takes items b,
// b + grid, ... and finds each item's leaf by walking the table forward.
//
// On a sharded step the rows are this rank's local shards; the wrapper
// sums the norm's partials over the mesh between the two launches, and a
// shard that another rank also holds (a leaf replicated over a mesh
// dimension) is left out of all but one rank's norm (flag bit 2).  A row
// with a null parameter pointer writes no parameter: the wrapper copies
// the master into a stand-in parameter that is no tensor.
//
//   adamw_norm    Each CTA sums the squares of its items' gradients (each
//                 group's eight f32 squares in f32, then in f64) and
//                 writes its f64 partial.  No atomics.
//   adamw_update  Each CTA first sums all the partials in one fixed order
//                 (so every CTA, and every rerun, has the same bits),
//                 takes grad_norm = sqrt in f64 rounded to f32 and the
//                 clip scale as the plain path computes it from
//                 grad_norm; CTA 0 writes both to `stats`.  Then for each
//                 element it reads g, m, v and master once and writes m,
//                 v, master and the parameter once.
//
// The update's arithmetic is the plain path's f32 operations in the same
// order, each rounded on its own (__fmul_rn and friends: no contraction
// into FMAs), with the scalars as torch casts them to f32; lr and the two
// bias corrections are read from the step's 0-d device tensors.  So given
// the same scale the new m, v, masters and parameters equal the plain
// path's bitwise; only grad_norm differs, by its order of summation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;              // elements a 16-byte vector group
constexpr int ITEM_ELEMS = 16384;     // elements a work item, at most
constexpr int NORM_CTAS_PER_SM = 4;   // launch bounds
constexpr int UPDATE_CTAS_PER_SM = 2;

// A table row's fields (int64 each).
enum Field {
  F_P, F_G, F_M, F_V, F_W,   // parameter, gradient, m, v, master pointers
  F_N,                       // elements
  F_HEAD,                    // scalar head elements
  F_GROUPS,                  // GROUP-element vector groups after the head
  F_FLAGS,                   // bit 0: parameter bf16; bit 1: gradient bf16;
                             // bit 2: left out of the norm
  F_ITEM_BEGIN,              // the leaf's first work item
  F_ITEMS,                   // its work items
  ENTRY
};

struct Leaf {
  int64_t p, g, m, v, w, n, head, groups, flags, begin, items;
};

__device__ __forceinline__ Leaf read_leaf(const int64_t* __restrict__ row) {
  Leaf l;
  l.p = __ldg(row + F_P);
  l.g = __ldg(row + F_G);
  l.m = __ldg(row + F_M);
  l.v = __ldg(row + F_V);
  l.w = __ldg(row + F_W);
  l.n = __ldg(row + F_N);
  l.head = __ldg(row + F_HEAD);
  l.groups = __ldg(row + F_GROUPS);
  l.flags = __ldg(row + F_FLAGS);
  l.begin = __ldg(row + F_ITEM_BEGIN);
  l.items = __ldg(row + F_ITEMS);
  return l;
}

// The leaf of `item`, walking forward from `leaf` (a CTA's items rise).
__device__ __forceinline__ int leaf_of(const int64_t* __restrict__ table,
                                       int nleaves, int leaf, int64_t item) {
  while (leaf + 1 < nleaves &&
         __ldg(table + (int64_t)(leaf + 1) * ENTRY + F_ITEM_BEGIN) <= item)
    ++leaf;
  return leaf;
}

// The range [g0, g1) of a leaf's chunk c, in groups, and whether the
// chunk also takes the head (its first) or the tail (its last).
struct Chunk {
  int64_t g0, g1;
  bool first, last;
};

__device__ __forceinline__ Chunk chunk_of(const Leaf& l, int64_t c) {
  constexpr int64_t per = ITEM_ELEMS / GROUP;
  Chunk k;
  k.g0 = c * per;
  k.g1 = k.g0 + per < l.groups ? k.g0 + per : l.groups;
  k.first = c == 0;
  k.last = c == l.items - 1;
  return k;
}

// ---- 16-byte groups of 8 elements, widened to f32 and narrowed back ----

__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);           // low half: element 2k
  f[1] = __uint_as_float(w & 0xffff0000u);   // high half: element 2k+1
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void load8(const float* base, int64_t e,
                                      float* f) {
  const float4* q = reinterpret_cast<const float4*>(base + e);
  const float4 a = __ldcs(q), b = __ldcs(q + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* base, int64_t e,
                                      float* f) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(base + e));
  bf16x2(u.x, f);
  bf16x2(u.y, f + 2);
  bf16x2(u.z, f + 4);
  bf16x2(u.w, f + 6);
}

__device__ __forceinline__ void store8(float* base, int64_t e,
                                       const float* f) {
  float4* q = reinterpret_cast<float4*>(base + e);
  __stcs(q, make_float4(f[0], f[1], f[2], f[3]));
  __stcs(q + 1, make_float4(f[4], f[5], f[6], f[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* base, int64_t e,
                                       const float* f) {
  __stcs(reinterpret_cast<uint4*>(base + e),
         make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                    bf16x2(f[4], f[5]), bf16x2(f[6], f[7])));
}

__device__ __forceinline__ float load1(const float* base, int64_t e) {
  return __ldcs(base + e);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* base,
                                       int64_t e) {
  return __bfloat162float(base[e]);
}

__device__ __forceinline__ void store1(float* base, int64_t e, float x) {
  __stcs(base + e, x);
}

__device__ __forceinline__ void store1(__nv_bfloat16* base, int64_t e,
                                       float x) {
  base[e] = __float2bfloat16_rn(x);
}

// ---- the global norm ----

// The CTA's sum of `x` over its threads in f64, in a fixed order; the
// result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double part[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += part[w];
  __syncthreads();   // `part` is free again for a later call
  return s;
}

template <typename G>
__device__ __forceinline__ double squares(const Leaf& l, const Chunk& k) {
  const G* g = reinterpret_cast<const G*>(l.g);
  const G* gv = g + l.head;
  double acc = 0.0;
  for (int64_t j = k.g0 + threadIdx.x; j < k.g1; j += THREADS) {
    float f[GROUP];
    load8(gv, j * GROUP, f);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < GROUP; ++e) s = __fadd_rn(s, __fmul_rn(f[e], f[e]));
    acc += (double)s;
  }
  if (k.first && threadIdx.x < l.head) {
    const float x = load1(g, threadIdx.x);
    acc += (double)__fmul_rn(x, x);
  }
  const int64_t tail = l.head + l.groups * GROUP;
  if (k.last && threadIdx.x < l.n - tail) {
    const float x = load1(g, tail + threadIdx.x);
    acc += (double)__fmul_rn(x, x);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, NORM_CTAS_PER_SM)
    adamw_norm(const int64_t* __restrict__ table, int nleaves,
               int64_t nitems, double* __restrict__ partials) {
  double acc = 0.0;
  int leaf = 0;
  for (int64_t item = blockIdx.x; item < nitems; item += gridDim.x) {
    leaf = leaf_of(table, nleaves, leaf, item);
    const Leaf l = read_leaf(table + (int64_t)leaf * ENTRY);
    if (l.flags & 4) continue;
    const Chunk k = chunk_of(l, item - l.begin);
    acc += (l.flags & 2) ? squares<__nv_bfloat16>(l, k)
                         : squares<float>(l, k);
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// ---- the update ----

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;   // as torch casts them to f32
};

struct Scalars {
  float scale, lr, b1c, b2c;
};

// The plain path's f32 operations on one element, in its order:
//   g = g * scale
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + ((1 - b2) * g) * g
//   upd = (m / b1c) / (sqrt(v / b2c) + eps) + wd * master
//   master = master - lr * upd
__device__ __forceinline__ void adamw_one(float g, float& m, float& v,
                                          float& w, const Hyper& h,
                                          const Scalars& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.b1c),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(s.lr, u));
}

template <typename P, typename G>
__device__ __forceinline__ void update_at(const Leaf& l, int64_t e,
                                          const Hyper& h, const Scalars& s) {
  float* m = reinterpret_cast<float*>(l.m);
  float* v = reinterpret_cast<float*>(l.v);
  float* w = reinterpret_cast<float*>(l.w);
  float mm = load1(m, e), vv = load1(v, e), ww = load1(w, e);
  adamw_one(load1(reinterpret_cast<const G*>(l.g), e), mm, vv, ww, h, s);
  store1(m, e, mm);
  store1(v, e, vv);
  store1(w, e, ww);
  if (l.p) store1(reinterpret_cast<P*>(l.p), e, ww);
}

template <typename P, typename G>
__device__ __forceinline__ void update_chunk(const Leaf& l, const Chunk& k,
                                             const Hyper& h,
                                             const Scalars& s) {
  // the vector part, based at the head
  const G* g = reinterpret_cast<const G*>(l.g) + l.head;
  float* m = reinterpret_cast<float*>(l.m) + l.head;
  float* v = reinterpret_cast<float*>(l.v) + l.head;
  float* w = reinterpret_cast<float*>(l.w) + l.head;
  P* p = l.p ? reinterpret_cast<P*>(l.p) + l.head : nullptr;
  for (int64_t j = k.g0 + threadIdx.x; j < k.g1; j += THREADS) {
    const int64_t e = j * GROUP;
    float fg[GROUP], fm[GROUP], fv[GROUP], fw[GROUP];
    load8(g, e, fg);
    load8(m, e, fm);
    load8(v, e, fv);
    load8(w, e, fw);
#pragma unroll
    for (int i = 0; i < GROUP; ++i) adamw_one(fg[i], fm[i], fv[i], fw[i], h, s);
    store8(m, e, fm);
    store8(v, e, fv);
    store8(w, e, fw);
    if (p) store8(p, e, fw);
  }
  if (k.first && threadIdx.x < l.head) update_at<P, G>(l, threadIdx.x, h, s);
  const int64_t tail = l.head + l.groups * GROUP;
  if (k.last && threadIdx.x < l.n - tail)
    update_at<P, G>(l, tail + threadIdx.x, h, s);
}

__global__ void __launch_bounds__(THREADS, UPDATE_CTAS_PER_SM)
    adamw_update(const int64_t* __restrict__ table, int nleaves,
                 int64_t nitems, const double* __restrict__ partials,
                 int nparts, const float* __restrict__ lr,
                 const float* __restrict__ b1c, const float* __restrict__ b2c,
                 Hyper h, float clip, float min_norm,
                 float* __restrict__ stats) {
  __shared__ float scale_s;
  // Every CTA sums the norm's partials in the same order.
  double acc = 0.0;
  for (int i = threadIdx.x; i < nparts; i += THREADS) acc += partials[i];
  const double total = block_sum(acc);
  if (threadIdx.x == 0) {
    const float norm = __double2float_rn(__dsqrt_rn(total));
    // clamp(clip / clamp(norm, min=min_norm), max=1) as torch computes it:
    // the division is reciprocal(x) * clip; NaN passes through both clamps
    const float x = norm < min_norm ? min_norm : norm;
    float scale = __fmul_rn(__fdiv_rn(1.0f, x), clip);
    scale = scale > 1.0f ? 1.0f : scale;
    scale_s = scale;
    if (blockIdx.x == 0) {
      stats[0] = norm;
      stats[1] = scale;
    }
  }
  __syncthreads();
  const Scalars s{scale_s, *lr, *b1c, *b2c};

  int leaf = 0;
  for (int64_t item = blockIdx.x; item < nitems; item += gridDim.x) {
    leaf = leaf_of(table, nleaves, leaf, item);
    const Leaf l = read_leaf(table + (int64_t)leaf * ENTRY);
    const Chunk k = chunk_of(l, item - l.begin);
    switch (l.flags & 3) {
      case 0: update_chunk<float, float>(l, k, h, s); break;
      case 1: update_chunk<__nv_bfloat16, float>(l, k, h, s); break;
      case 2: update_chunk<float, __nv_bfloat16>(l, k, h, s); break;
      default: update_chunk<__nv_bfloat16, __nv_bfloat16>(l, k, h, s);
    }
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

int resident(int which) {
  int n = 0;
  const cudaError_t err =
      which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, adamw_norm, THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, adamw_update, THREADS, 0);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// The built tile, on the current device: threads a CTA, GROUP,
// ITEM_ELEMS, ENTRY (int64 fields a table row), the norm's and the
// update's launch-bound CTAs per SM, the CTAs per SM the occupancy
// calculator finds resident for each, and the SM count.  The persistent
// grids are SMs x resident CTAs.  kernels/adamw.py states the first four
// (TILE); chip_smoke.py holds them against this function.
extern "C" int adamw_tile(int* out) {
  const int sms = sm_count();
  const int rn = resident(0), ru = resident(1);
  if (!sms || rn <= 0 || ru <= 0) return (int)cudaErrorInvalidDevice;
  const int tile[9] = {THREADS, GROUP, ITEM_ELEMS, ENTRY, NORM_CTAS_PER_SM,
                       UPDATE_CTAS_PER_SM, rn, ru, sms};
  for (int i = 0; i < 9; ++i) out[i] = tile[i];
  return 0;
}

// The norm launch: table (nleaves rows of ENTRY int64, on the card),
// nitems work items; writes `grid` f64 partials.  Returns the launch's
// cudaError_t (0 on success); runs on `stream`, does not synchronise.
extern "C" int adamw_norm_launch(const int64_t* table, int nleaves,
                                 int64_t nitems, double* partials, int grid,
                                 void* stream) {
  if (nleaves < 0 || nitems < 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  adamw_norm<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, nleaves, nitems, partials);
  return (int)cudaGetLastError();
}

// The update launch: the same table, the norm's `nparts` partials, the
// step's lr and bias corrections (0-d f32 on the card), the f32 scalars
// b1, 1 - b1, b2, 1 - b2, eps, weight_decay, clip_norm and the norm's
// floor (1e-12); writes grad_norm and the clip scale to stats[0..1].
extern "C" int adamw_update_launch(const int64_t* table, int nleaves,
                                   int64_t nitems, const double* partials,
                                   int nparts, const float* lr,
                                   const float* b1c, const float* b2c,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, float wd, float clip,
                                   float min_norm, float* stats, int grid,
                                   void* stream) {
  if (nleaves < 0 || nitems < 0 || nparts <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  adamw_update<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, nleaves, nitems, partials, nparts, lr, b1c, b2c, h, clip,
      min_norm, stats);
  return (int)cudaGetLastError();
}
