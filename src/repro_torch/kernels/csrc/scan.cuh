// An exclusive scan of n unsigned counts on the card, shared by the
// engine's sources (engine_scan.cu's K1b and cluster_scan.cu's K2 turn
// their per-bucket counts into offsets with it; kernels/_build.py hashes
// this header into every library's name).  Three passes: per-CTA sums, a
// scan of the sums in one CTA, then each CTA's entries with its offset.
// The total lands at v[n].  TAG only names the kernels of each caller
// apart in a profile (K1b takes 0, K2 1).  launch_dev scans a count that
// only the card knows (*n_dev entries, total included) with a grid fixed
// by the host: each CTA takes a stretch of whole BLOCKs.

#pragma once

#include <cuda_runtime.h>

namespace excl_scan {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 1024;          // entries a scan CTA takes
constexpr int THREADS = 256;
constexpr int ITEMS = BLOCK / THREADS;

__device__ unsigned block_exclusive_scan(unsigned v, unsigned& total) {
  __shared__ unsigned warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned w = lane < nw ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;               // inclusive over warps
  }
  __syncthreads();
  total = warp_sums[(blockDim.x >> 5) - 1];
  const unsigned before = warp ? warp_sums[warp - 1] : 0u;
  __syncthreads();
  return before + inc - v;
}

template <int TAG>
__global__ void __launch_bounds__(THREADS)
    scan_sums(const unsigned* v, long long n, unsigned* blocks) {
  const long long b0 = (long long)blockIdx.x * BLOCK;
  unsigned s = 0;
  for (int i = 0; i < ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * ITEMS + i;
    if (k < n) s += v[k];
  }
  unsigned total;
  block_exclusive_scan(s, total);
  if (threadIdx.x == 0) blocks[blockIdx.x] = total;
}

template <int TAG>
__global__ void __launch_bounds__(1024)
    scan_blocks(unsigned* blocks, int nb, unsigned* total_out) {
  unsigned carry = 0;
  for (int b0 = 0; b0 < nb; b0 += 1024) {
    const int k = b0 + threadIdx.x;
    const unsigned v = k < nb ? blocks[k] : 0u;
    unsigned total;
    const unsigned ex = block_exclusive_scan(v, total);
    if (k < nb) blocks[k] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

template <int TAG>
__global__ void __launch_bounds__(THREADS)
    scan_apply(unsigned* v, long long n, const unsigned* blocks) {
  const long long b0 = (long long)blockIdx.x * BLOCK;
  unsigned item[ITEMS];
  unsigned s = 0;
  for (int i = 0; i < ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * ITEMS + i;
    item[i] = k < n ? v[k] : 0u;
    s += item[i];
  }
  unsigned total;
  unsigned run = blocks[blockIdx.x] + block_exclusive_scan(s, total);
  for (int i = 0; i < ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * ITEMS + i;
    if (k < n) v[k] = run;
    run += item[i];
  }
}

// Entries [lo, hi) of the CTA's stretch when nb CTAs share n entries.
__device__ inline void dev_stretch(long long n, long long& lo,
                                   long long& hi) {
  const long long per =
      ((n + gridDim.x - 1) / gridDim.x + BLOCK - 1) / BLOCK * BLOCK;
  lo = blockIdx.x * per;
  hi = lo + per < n ? lo + per : n;
}

template <int TAG>
__global__ void __launch_bounds__(THREADS)
    scan_sums_dev(const unsigned* v, const unsigned* n_dev,
                  unsigned* blocks) {
  long long lo, hi;
  dev_stretch(*n_dev, lo, hi);
  unsigned s = 0;
  for (long long k = lo + threadIdx.x; k < hi; k += THREADS) s += v[k];
  unsigned total;
  block_exclusive_scan(s, total);
  if (threadIdx.x == 0) blocks[blockIdx.x] = total;
}

template <int TAG>
__global__ void __launch_bounds__(THREADS)
    scan_apply_dev(unsigned* v, const unsigned* n_dev,
                   const unsigned* blocks) {
  long long lo, hi;
  dev_stretch(*n_dev, lo, hi);
  unsigned carry = blocks[blockIdx.x];
  for (long long b0 = lo; b0 < hi; b0 += BLOCK) {
    unsigned item[ITEMS];
    unsigned s = 0;
    for (int i = 0; i < ITEMS; ++i) {
      const long long k = b0 + threadIdx.x * ITEMS + i;
      item[i] = k < hi ? v[k] : 0u;
      s += item[i];
    }
    unsigned total;
    unsigned run = carry + block_exclusive_scan(s, total);
    for (int i = 0; i < ITEMS; ++i) {
      const long long k = b0 + threadIdx.x * ITEMS + i;
      if (k < hi) v[k] = run;
      run += item[i];
    }
    carry += total;
  }
}

// The scan's launches on `s`: v holds n counts and room for the total at
// v[n]; blocks holds one entry per BLOCK counts.
template <int TAG>
cudaError_t launch(unsigned* v, long long n, unsigned* blocks,
                   cudaStream_t s) {
  const int nb = (int)((n + BLOCK - 1) / BLOCK);
  scan_sums<TAG><<<nb, THREADS, 0, s>>>(v, n, blocks);
  scan_blocks<TAG><<<1, 1024, 0, s>>>(blocks, nb, v + n);
  scan_apply<TAG><<<nb, THREADS, 0, s>>>(v, n, blocks);
  return cudaGetLastError();
}

// The same over *n_dev entries (the last one a zero, so that the total
// lands there) by nb CTAs; blocks holds nb + 1 entries.
template <int TAG>
cudaError_t launch_dev(unsigned* v, const unsigned* n_dev, int nb,
                       unsigned* blocks, cudaStream_t s) {
  scan_sums_dev<TAG><<<nb, THREADS, 0, s>>>(v, n_dev, blocks);
  scan_blocks<TAG><<<1, 1024, 0, s>>>(blocks, nb, blocks + nb);
  scan_apply_dev<TAG><<<nb, THREADS, 0, s>>>(v, n_dev, blocks);
  return cudaGetLastError();
}

}  // namespace excl_scan
