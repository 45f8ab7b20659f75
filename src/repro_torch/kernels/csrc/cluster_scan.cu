// The cluster scan (K2) for Hopper (sm_90a), plain C interface: the shared
// L2 and the round-robin channel arbiter of a cluster of N lockstep cores,
// over the L1-miss streams that K1b (engine_scan.cu) leaves behind.
//
// Replaces the reference's cluster engine, src/repro/cluster/engine.py
// `_run_cluster_grid` (:74): a `lax.scan` whose step vmaps the single-core
// body over the cores and then drains their L1-missed lines through
// src/repro/cluster/contention.py `l2_access` (:101) in `rank_order`
// (:118), charging `queue_rounds` (:127).  XLA compiles it; there is no
// `pallas_call`.
//
// What it computes.  For each K2 lane (a program, a cVRF class and a
// cluster point of N cores, an L2 of sets x ways, mem_channels) and each
// stored row t, the requests of rank r = 0..N-1 (core (t mod N + r) mod N)
// at sites 0..7, in that order: the core's L1-missed line shifted by its
// shift, where that line is >= 0.  They probe the shared LRU L2 (first
// equal tag on a hit, first least age on a miss, a free way age 0, ages
// from a clock that starts at 1 and ticks per request); the requests that
// miss queue on the channels: rank r waits (requests of earlier ranks that
// missed) // mem_channels rounds.  Per core and counter set: the weighted
// sums of L2 hits, L2 misses and queue rounds; then per (output, machine,
// core) K1's 12 counters plus contention_stalls = mem_latency * rounds,
// l2_hits, l2_misses, and cycles + mem_latency * rounds + (l2_hit_cycles -
// mem_latency) * hits.  Counters wrap as the reference's int32 (uint32).
//
// What bounds it on the card: the longest chain of dependent steps, the
// L2's walk of its largest (lane, L2 set) bucket, and beside it the bytes
// of the requests, which are the L1 misses times the cores: a lane's rows
// times cores times 8 sites are mostly empty (on the cluster suites' paper
// grids under 4 % of those slots hold a request).  So nothing here visits
// a slot without a miss:
//   * a compacted L1-miss stream per K1b lane, from K1b's kept records and
//     outcome bytes: a missed-site mask and a count per (lane, row), an
//     exclusive scan of the counts, and each miss scattered to its place
//     in (row, site) order as (line, row << 3 | site) with a byte for its
//     place in its row and the row's misses;
//   * a lane's candidates (its cores' misses, in the reference's (row,
//     rank, site) order) are numbered; candidate i of a lane whose cores
//     share one K1b lane is miss i / N's row, rank and place (the row's m
//     misses give it N * m consecutive candidates), found in O(1); cores
//     with their own K1b lanes find the row by a binary search over the
//     rows' candidate offsets;
//   * a stable counting sort over the candidates (per (lane, tile of
//     TILE_CANDS candidates) a warp counts per L2 set, an exclusive scan
//     of the (lane, set, tile) counts sized on the card, the same warps
//     scatter with __match_any_sync ranks) puts each (lane, L2 set) bucket
//     in the reference's order; a candidate whose shifted line is
//     negative is no request;
//   * one thread per (lane, L2 set) walks its bucket with the ways in
//     registers and a local clock (the L2 decides from the order within a
//     set only) and marks each hit in a byte per candidate;
//   * the arbiter takes one thread per row that has a miss: a rank's
//     candidates are consecutive, so it counts each rank's requests that
//     missed and its hits into one 64-bit word (a byte per rank: misses
//     in the low nibble, hits in the high), and one multiply gives the
//     exclusive scan over ranks.
// Every buffer is sized by the misses, the candidates or the rows of the
// K1b lanes, and every grid past the compaction reads its size from the
// card, so no launch waits for the host.  One walk serves every machine
// point: the cycles are a closed form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NCOL = 24;             // int32 columns of a packed row
constexpr int WT = 21;               // its weight columns: wt, wa, wb
constexpr int SITES = 8;             // spill, fill of REG slots 0..2, MEM 0, 1
constexpr int NSETS = 3;             // counter sets: total, period A, B
constexpr int NCTR = 12;             // K1's counters
constexpr int NCL = 15;              // + contention_stalls, l2_hits, l2_misses
constexpr int NSUM = 3;              // per core and set: hits, misses, rounds
constexpr int MAX_CORES = 8;         // one byte per rank of a 64-bit word
constexpr int TILE_CANDS = 512;      // candidates a bucketing warp takes
constexpr int HIST_WARPS = 4;        // bucketing warps in a CTA
constexpr int BUCKET_CTAS = 2048;    // the persistent bucketing grid's cap
constexpr int SCAN_CTAS = 1024;      // the bucket offsets' scan CTAs, at most
constexpr int ROW_THREADS = 256;     // threads of the per-record and row CTAs
constexpr int LANE_THREADS = 1024;   // the one CTA that numbers the lanes
constexpr int WALK_THREADS = 128;    // walkers in a CTA
constexpr int WALK_BATCH = 16;       // requests a walker loads ahead
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a CTA may use
constexpr long long MAX_ROWS = 1LL << 27;   // a miss packs row << 3 | site
constexpr unsigned long long NIBBLES = 0x0F0F0F0F0F0F0F0FULL;
constexpr unsigned long long BYTE_ONES = 0x0101010101010101ULL;
// A candidate's state: no request (its line < 0), a request that missed
// the L2 (or found none), a request that hit
constexpr unsigned char NO_REQUEST = 0, L2_MISS = 1, L2_HIT = 2;

int way_slots(int ways) {
  int w = 1;
  while (w < ways) w <<= 1;
  return w;
}

struct K2Args {
  const int* rows;                // (P, T, NCOL) int32
  long long T;
  const int* lengths;             // (P,)
  int L;                          // K1b's lanes
  const int* l1_row0;             // (L + 1,) each K1b lane's first row slot
  const int2* l1_recs;            // K1b's records: line, row<<4|site<<1|w
  const unsigned char* l1_outcome;  // per record: miss | write-back << 1
  const unsigned* l1_hist;        // K1b's bucket offsets
  long long l1_per_lane;          // K1b's buckets a lane
  unsigned char* row_mask;        // (row slots) missed sites of a row
  unsigned* row_off;              // (row slots + 1) misses -> offsets
  int2* miss;                     // compacted misses: line, row << 3 | site
  unsigned char* miss_pm;         // place in its row | (row's misses-1) << 3
  int K;                          // K2 lanes
  const int* k_prog;              // (K,) program, cores, L2 sets (0: none),
  const int* k_cores;             // ways, channels, L2 hit cycles
  const int* k_sets;
  const int* k_ways;
  const int* k_chan;
  const int* k_hit;
  const int* k_l1;                // (K, MAX_CORES) each core's K1b lane
  const int* k_shift;             // (K, MAX_CORES) each core's line shift
  int S;                          // the widest L2's sets
  unsigned* meta;                 // candidate, tile, histogram bases (K+1
                                  // each), then the histogram's entries
  unsigned* hist;                 // (lane, set, tile) counts -> offsets
  unsigned* blocks;
  int2* req;                      // bucketed requests: line, candidate
  unsigned char* state;           // per candidate: NO_REQUEST, L2_MISS, L2_HIT
  unsigned* sums;                 // (K, MAX_CORES, NSETS, NSUM)
  int Q, M;
  const int* o_lane;              // (Q,) K2 lane of each output
  const int* o_k1;                // (Q, MAX_CORES) each core's K1 output
  const int* mem;                 // (M,) memory latency
  const unsigned* k1_ctr[NSETS];  // (Q1, M, NCTR) K1's counters
  int* out[NSETS];                // (Q, M, MAX_CORES, NCL)
};

__device__ __forceinline__ const unsigned* cand_base(const K2Args& a) {
  return a.meta;
}
__device__ __forceinline__ const unsigned* tile_base(const K2Args& a) {
  return a.meta + (a.K + 1);
}
__device__ __forceinline__ const unsigned* hist_base(const K2Args& a) {
  return a.meta + 2 * (a.K + 1);
}

// K1b lane j's compacted misses: [first, end) of the list.
__device__ __forceinline__ unsigned lane_first(const K2Args& a, int j) {
  return a.row_off[a.l1_row0[j]];
}
__device__ __forceinline__ unsigned lane_end(const K2Args& a, int j) {
  return a.row_off[a.l1_row0[j + 1]];
}

// Per (K1b lane, row) the missed sites (a bit each) and the misses.
__global__ void __launch_bounds__(ROW_THREADS) cluster_mark(K2Args a) {
  const int j = blockIdx.y;
  const unsigned lo = a.l1_hist[j * a.l1_per_lane];
  const unsigned hi = a.l1_hist[(j + 1) * a.l1_per_lane];
  const size_t r0 = (unsigned)a.l1_row0[j];
  for (unsigned k = lo + blockIdx.x * blockDim.x + threadIdx.x; k < hi;
       k += gridDim.x * blockDim.x) {
    if (!(a.l1_outcome[k] & 1u)) continue;
    const unsigned info = (unsigned)a.l1_recs[k].y;
    const size_t i = r0 + (info >> 4);
    atomicOr(reinterpret_cast<unsigned*>(a.row_mask + (i & ~(size_t)3)),
             1u << (8 * (unsigned)(i & 3) + ((info >> 1) & 7u)));
    atomicAdd(&a.row_off[i], 1u);
  }
}

// Each miss to its place in (lane, row, site) order.
__global__ void __launch_bounds__(ROW_THREADS) cluster_compact(K2Args a) {
  const int j = blockIdx.y;
  const unsigned lo = a.l1_hist[j * a.l1_per_lane];
  const unsigned hi = a.l1_hist[(j + 1) * a.l1_per_lane];
  const size_t r0 = (unsigned)a.l1_row0[j];
  for (unsigned k = lo + blockIdx.x * blockDim.x + threadIdx.x; k < hi;
       k += gridDim.x * blockDim.x) {
    if (!(a.l1_outcome[k] & 1u)) continue;
    const int2 r = a.l1_recs[k];
    const unsigned row = (unsigned)r.y >> 4, site = ((unsigned)r.y >> 1) & 7u;
    const size_t i = r0 + row;
    const unsigned mask = a.row_mask[i];
    const unsigned p = __popc(mask & ((1u << site) - 1u));
    const unsigned pos = a.row_off[i] + p;
    a.miss[pos] = make_int2(r.x, (int)(row << 3 | site));
    a.miss_pm[pos] = (unsigned char)(p | (__popc(mask) - 1u) << 3);
  }
}

// One CTA numbers the K2 lanes: per lane its candidates (its cores'
// misses), its tiles and its (set, tile) histogram entries, each as an
// exclusive scan over the lanes with the total at index K; then the
// histogram's closing zero and the entries its scan takes.
__global__ void __launch_bounds__(LANE_THREADS) cluster_lanes(K2Args a) {
  unsigned carry[3] = {0u, 0u, 0u};
  for (int k0 = 0; k0 < a.K; k0 += LANE_THREADS) {
    const int k = k0 + threadIdx.x;
    unsigned v[3] = {0u, 0u, 0u};
    if (k < a.K) {
      const int n = a.k_cores[k];
      for (int c = 0; c < n; ++c) {
        const int j = a.k_l1[k * MAX_CORES + c];
        v[0] += lane_end(a, j) - lane_first(a, j);
      }
      v[1] = (v[0] + TILE_CANDS - 1) / TILE_CANDS;
      v[2] = (unsigned)a.k_sets[k] * v[1];
    }
    for (int i = 0; i < 3; ++i) {
      unsigned total;
      const unsigned ex = excl_scan::block_exclusive_scan(v[i], total);
      if (k < a.K) a.meta[i * (a.K + 1) + k] = carry[i] + ex;
      carry[i] += total;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) a.meta[i * (a.K + 1) + a.K] = carry[i];
    a.hist[carry[2]] = 0u;
    a.meta[3 * (a.K + 1)] = carry[2] + 1u;
  }
}

// Candidate i of K2 lane k: its row t, its rank, the shifted line and
// whether it is a request (the line >= 0).
struct Cand {
  unsigned t;
  int rank;
  int line;
  bool on;
};

__device__ Cand candidate(const K2Args& a, int k, int n, bool shared,
                          unsigned len, unsigned i) {
  const int* l1 = a.k_l1 + k * MAX_CORES;
  Cand q;
  int line;
  if (shared) {
    // The row's m misses give candidates [n * e0, n * (e0 + m)), rank
    // major, so miss i / n lies in the row.
    const unsigned first = lane_first(a, l1[0]);
    const unsigned e1 = i / n;
    const unsigned pm = a.miss_pm[first + e1];
    q.t = (unsigned)a.miss[first + e1].y >> 3;
    const unsigned m = (pm >> 3) + 1u;
    const unsigned e0 = e1 - (pm & 7u);
    const unsigned local = i - n * e0;
    q.rank = (int)(local / m);
    line = a.miss[first + e0 + (local - q.rank * m)].x;
  } else {
    // Each core its own list: the last row whose candidate offset,
    // summed over the cores, is <= i; then the rank whose block holds i.
    unsigned r0[MAX_CORES], f[MAX_CORES];
#pragma unroll
    for (int c = 0; c < MAX_CORES; ++c)
      if (c < n) {
        r0[c] = (unsigned)a.l1_row0[l1[c]];
        f[c] = a.row_off[r0[c]];
      }
    unsigned lo = 0, hi = len;
    while (hi - lo > 1) {
      const unsigned mid = (lo + hi) / 2;
      unsigned off = 0;
#pragma unroll
      for (int c = 0; c < MAX_CORES; ++c)
        if (c < n) off += a.row_off[r0[c] + mid] - f[c];
      if (off <= i) lo = mid;
      else hi = mid;
    }
    unsigned local = i;
#pragma unroll
    for (int c = 0; c < MAX_CORES; ++c)
      if (c < n) local -= a.row_off[r0[c] + lo] - f[c];
    q.t = lo;
    q.rank = 0;
    line = 0;
    for (int r = 0; r < n; ++r) {
      const int c = (int)((lo % n + r) % n);
      const size_t row = (unsigned)a.l1_row0[l1[c]] + lo;
      const unsigned m = __popc(a.row_mask[row]);
      if (local < m) {
        q.rank = r;
        line = a.miss[a.row_off[row] + local].x;
        break;
      }
      local -= m;
    }
  }
  const int c = (int)((q.t % n + q.rank) % n);
  q.line = (int)((unsigned)line + (unsigned)a.k_shift[k * MAX_CORES + c]);
  q.on = q.line >= 0;
  return q;
}

// Bucketing, persistent warps over the (lane, tile) pairs the card
// numbered, each over its tile's candidates in order.  SCATTER false:
// count the requests per L2 set into hist[hist base + set * tiles +
// tile].  SCATTER true: hist holds the offsets; mark each candidate a
// request or not and write each request to its bucket (the tile's warp
// owns its slice of every bucket of its lane).
template <bool SCATTER>
__global__ void __launch_bounds__(HIST_WARPS * 32) cluster_bucket(K2Args a) {
  extern __shared__ unsigned cnt_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* cnt = cnt_smem + warp * a.S;
  const unsigned* cb = cand_base(a);
  const unsigned* gb = tile_base(a);
  const unsigned* hb = hist_base(a);
  const unsigned G = gb[a.K];
  for (unsigned g = blockIdx.x * HIST_WARPS + warp; g < G;
       g += gridDim.x * HIST_WARPS) {
    int k = 0, top = a.K;                 // the last lane with gb[k] <= g
    while (top - k > 1) {
      const int mid = (k + top) / 2;
      if (gb[mid] <= g) k = mid;
      else top = mid;
    }
    const unsigned tiles = gb[k + 1] - gb[k], tile = g - gb[k];
    const int sets = a.k_sets[k], n = a.k_cores[k];
    const bool shared = a.k_l1[k * MAX_CORES] ==
                        a.k_l1[k * MAX_CORES + n - 1];
    const unsigned len = (unsigned)a.lengths[a.k_prog[k]];
    const size_t h0 = (size_t)hb[k] + tile;
    __syncwarp();
    for (int s = lane; s < sets; s += 32)
      cnt[s] = SCATTER ? a.hist[h0 + (size_t)s * tiles] : 0u;
    __syncwarp();
    const unsigned i0 = tile * TILE_CANDS;
    const unsigned i1 = min(cb[k + 1] - cb[k], i0 + TILE_CANDS);
    for (unsigned base = i0; base < i1; base += 32) {
      const unsigned i = base + lane;
      Cand q{0u, 0, 0, false};
      if (i < i1) q = candidate(a, k, n, shared, len, i);
      const int s = q.on && sets ? q.line & (sets - 1) : 0;
      if (!SCATTER) {
        if (q.on && sets) atomicAdd(&cnt[s], 1u);
        continue;
      }
      if (i < i1) a.state[cb[k] + i] = q.on ? L2_MISS : NO_REQUEST;
      if (!sets) continue;
      // Requests of one chunk to one set keep their order: each takes the
      // set's next offset plus its rank among the chunk's earlier ones.
      const unsigned peers = __match_any_sync(FULL, q.on ? s : -1 - lane);
      const unsigned before = __popc(peers & ((1u << lane) - 1u));
      if (q.on) a.req[cnt[s] + before] = make_int2(q.line, (int)(cb[k] + i));
      __syncwarp();
      if (q.on && before == 0) cnt[s] += __popc(peers);
      __syncwarp();
    }
    if (!SCATTER) {
      __syncwarp();
      for (int s = lane; s < sets; s += 32)
        a.hist[h0 + (size_t)s * tiles] = cnt[s];
    }
  }
}

// One thread per (K2 lane, L2 set): walk the bucket through the set's ways,
// kept in registers (WAYS a power of two >= the lane's ways), and mark
// each hit.
template <int WAYS>
__global__ void __launch_bounds__(WALK_THREADS) cluster_walk(K2Args a) {
  const long long g = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (g >= (long long)a.K * a.S) return;
  const int k = (int)(g / a.S), set = (int)(g % a.S);
  if (set >= a.k_sets[k]) return;
  const int ways = a.k_ways[k];
  const unsigned tiles = tile_base(a)[k + 1] - tile_base(a)[k];
  const size_t h0 = hist_base(a)[k];
  const unsigned lo = a.hist[h0 + (size_t)set * tiles];
  const unsigned hi = a.hist[h0 + (size_t)(set + 1) * tiles];
  int tag[WAYS];
  unsigned age[WAYS];
#pragma unroll
  for (int i = 0; i < WAYS; ++i) {
    tag[i] = -1;
    age[i] = 0;
  }
  unsigned clock = 1;
  int2 cur[WALK_BATCH], nxt[WALK_BATCH];
#pragma unroll
  for (int b = 0; b < WALK_BATCH; ++b)
    cur[b] = lo + b < hi ? __ldg(&a.req[lo + b]) : make_int2(0, 0);
  for (unsigned k0 = lo; k0 < hi; k0 += WALK_BATCH) {
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) {      // in flight during the walk
      const unsigned i = k0 + WALK_BATCH + b;
      nxt[b] = i < hi ? __ldg(&a.req[i]) : make_int2(0, 0);
    }
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) {
      if (k0 + b >= hi) break;
      const int line = cur[b].x;
      int way = -1;
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i < ways && way < 0 && tag[i] == line) way = i;
      if (way >= 0) {
        a.state[(unsigned)cur[b].y] = L2_HIT;
      } else {                        // the first least age
        way = 0;
        unsigned least = age[0];
#pragma unroll
        for (int i = 1; i < WAYS; ++i)
          if (i < ways && age[i] < least) {
            least = age[i];
            way = i;
          }
      }
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i == way) {
          tag[i] = line;
          age[i] = clock;
        }
      ++clock;
    }
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) cur[b] = nxt[b];
  }
}

// A core's requests that missed the L2 (low nibble) and its hits (high)
// over its m candidates from c0.
__device__ __forceinline__ unsigned rank_counts(const K2Args& a, unsigned c0,
                                                unsigned m) {
  unsigned missed = 0, hits = 0;
  for (unsigned i = c0; i < c0 + m; ++i) {
    const unsigned s = a.state[i];
    missed += s == L2_MISS;
    hits += s == L2_HIT;
  }
  return missed | hits << 4;
}

// The arbiter per (K2 lane, row with a miss), n lanes of a warp a row,
// lane c for core c (32 / n rows a warp), found at the row's first miss
// (of the first core that has one where the cores keep their own lists):
// each lane counts its core's requests that missed the L2 and its hits,
// the row's lanes pack them into one 64-bit word (a byte per rank) by
// shuffles, and one multiply gives each rank the requests of earlier
// ranks that missed, whose // mem_channels are its queue rounds; each
// lane sums its core's weighted hits, misses and rounds.  A CTA
// grid-strides over lane blockIdx.y's misses.
template <bool TRACK_AB>
__global__ void __launch_bounds__(ROW_THREADS) cluster_arbiter(K2Args a) {
  __shared__ unsigned cta_acc[MAX_CORES][NSETS][NSUM];
  const int k = blockIdx.y;
  const int n = a.k_cores[k], p = a.k_prog[k];
  const unsigned chan = (unsigned)a.k_chan[k];
  const int* l1 = a.k_l1 + k * MAX_CORES;
  const bool shared = l1[0] == l1[n - 1];
  const unsigned cb = cand_base(a)[k];
  const int lane = threadIdx.x & 31, rows_per_warp = 32 / n;
  const int slot = lane / n, c = lane % n;     // slot >= rows_per_warp: idle
  const bool active = slot < rows_per_warp;
  const unsigned groups = gridDim.x * (blockDim.x >> 5) * rows_per_warp;
  const unsigned warp_group =
      (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * rows_per_warp;
  for (int i = threadIdx.x; i < MAX_CORES * NSETS * NSUM; i += blockDim.x)
    (&cta_acc[0][0][0])[i] = 0u;
  __syncthreads();
  const int j_c = l1[c];
  const unsigned row0_c = (unsigned)a.l1_row0[j_c];
  const unsigned first_c = lane_first(a, j_c);
  unsigned acc[NSETS][NSUM] = {};
  for (int own = 0; own < (shared ? 1 : n); ++own) {
    const unsigned first = lane_first(a, l1[own]);
    const unsigned end = lane_end(a, l1[own]);
    for (unsigned base = first + warp_group; base < end; base += groups) {
      const unsigned e = base + slot;
      bool row = active && e < end;
      unsigned pm = 0, t = 0;
      if (row) {
        pm = a.miss_pm[e];
        row = (pm & 7u) == 0;                  // its row's first miss
        t = (unsigned)a.miss[e].y >> 3;
      }
      const int rank = (int)((c + n - t % n) % n);
      unsigned block = 0, m = 0;
      if (shared) {
        m = (pm >> 3) + 1u;
        block = cb + n * (e - first) + rank * m;
      } else {
        // this core's misses in the row and their offset; the row's
        // candidates start at the sum of the cores' offsets and rank r's
        // after the misses of ranks < r
        const size_t at = (size_t)row0_c + t;
        const unsigned off = row ? a.row_off[at] - first_c : 0u;
        m = row ? __popc(a.row_mask[at]) : 0u;
        block = cb;
        bool owner = true;
        for (int q = 0; q < n; ++q) {
          const int src = slot * n + q;
          const unsigned mq = __shfl_sync(FULL, m, src);
          block += __shfl_sync(FULL, off, src);
          if ((int)((q + n - t % n) % n) < rank) block += mq;
          if (q < own && mq) owner = false;
        }
        row = row && owner;
      }
      const unsigned mine = row ? rank_counts(a, block, m) : 0u;
      unsigned long long word = 0;
      for (int q = 0; q < n; ++q)
        word |= (unsigned long long)__shfl_sync(FULL, mine, slot * n + q)
                << (8 * ((q + n - t % n) % n));
      if (!row || !word) continue;
      // byte r: the misses of ranks < r (no byte passes 8 x 8)
      const unsigned long long earlier =
          ((word & NIBBLES) * BYTE_ONES) << 8;
      const unsigned v[NSUM] = {mine >> 4, mine & 0xfu,
                                ((unsigned)(earlier >> (8 * rank)) & 0xffu) /
                                    chan};
      const int* x = a.rows + ((size_t)p * a.T + t) * NCOL;
#pragma unroll
      for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s) {
        const unsigned w = (unsigned)x[WT + s];
#pragma unroll
        for (int i = 0; i < NSUM; ++i) acc[s][i] += w * v[i];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s)
#pragma unroll
      for (int i = 0; i < NSUM; ++i)
        if (acc[s][i]) atomicAdd(&cta_acc[c][s][i], acc[s][i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * NSETS * NSUM; i += blockDim.x) {
    const unsigned v = (&cta_acc[0][0][0])[i];
    if (v) atomicAdd(&a.sums[(size_t)k * MAX_CORES * NSETS * NSUM + i], v);
  }
}

// The closed form per (output, machine, core); zeros past a lane's cores
// and, without TRACK_AB, in the period counters.
template <bool TRACK_AB>
__global__ void cluster_finish(K2Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.Q * a.M * MAX_CORES) return;
  const int c = i % MAX_CORES, m = (i / MAX_CORES) % a.M;
  const int o = i / (MAX_CORES * a.M);
  const int k = a.o_lane[o];
  const bool core = c < a.k_cores[k];
  const unsigned lat = (unsigned)a.mem[m], hit = (unsigned)a.k_hit[k];
  const int q1 = core ? a.o_k1[o * MAX_CORES + c] : 0;
#pragma unroll
  for (int s = 0; s < NSETS; ++s) {
    int* d = a.out[s] + (size_t)i * NCL;
    if (!core || (!TRACK_AB && s > 0)) {
#pragma unroll
      for (int j = 0; j < NCL; ++j) d[j] = 0;
      continue;
    }
    const unsigned* e = a.k1_ctr[s] + ((size_t)q1 * a.M + m) * NCTR;
    const unsigned* u =
        a.sums + (((size_t)k * MAX_CORES + c) * NSETS + s) * NSUM;
    const unsigned stall = lat * u[2];
    d[0] = (int)(e[0] + stall + (hit - lat) * u[0]);
#pragma unroll
    for (int j = 1; j < NCTR; ++j) d[j] = (int)e[j];
    d[NCTR] = (int)stall;
    d[NCTR + 1] = (int)u[0];
    d[NCTR + 2] = (int)u[1];
  }
}

template <int WAYS>
cudaError_t launch_walk(const K2Args& a, cudaStream_t s) {
  const long long n = (long long)a.K * a.S;
  cluster_walk<WAYS><<<(unsigned)((n + WALK_THREADS - 1) / WALK_THREADS),
                       WALK_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

unsigned capped(long long v, long long cap) {
  return (unsigned)(v < 1 ? 1 : v > cap ? cap : v);
}

// The launches on `s`.  row_slots: the K1b lanes' rows; records: K1b's
// access slots (a bound on its records); tiles, hist_entries: bounds on
// the (lane, tile) pairs and the histogram's entries.
template <bool TRACK_AB>
cudaError_t launch_k2(const K2Args& a, long long row_slots, long long records,
                      long long tiles, long long hist_entries, int max_ways,
                      cudaStream_t s) {
  cudaError_t err;
  const long long scan_n = row_slots > 0 ? row_slots : 1;   // a grid >= 1
  if ((err = cudaMemsetAsync(a.row_mask, 0, (row_slots + 3) / 4 * 4, s)) ||
      (err = cudaMemsetAsync(a.row_off, 0, sizeof(unsigned) * (scan_n + 1),
                             s)) ||
      (err = cudaMemsetAsync(
           a.sums, 0, sizeof(unsigned) * a.K * MAX_CORES * NSETS * NSUM, s)))
    return err;
  // About a few thousand records a CTA, at least one CTA a lane.
  const dim3 rec_grid(capped((records / a.L + 4096) / 4096, 1024),
                      (unsigned)a.L);
  cluster_mark<<<rec_grid, ROW_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  if ((err = excl_scan::launch<1>(a.row_off, scan_n, a.blocks, s)))
    return err;
  cluster_compact<<<rec_grid, ROW_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  cluster_lanes<<<1, LANE_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  const unsigned bucket_ctas =
      capped((tiles + HIST_WARPS - 1) / HIST_WARPS, BUCKET_CTAS);
  const int smem = HIST_WARPS * a.S * (int)sizeof(unsigned);
  if (smem > 48 * 1024) {
    if ((err = cudaFuncSetAttribute(
             cluster_bucket<false>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
        (err = cudaFuncSetAttribute(
             cluster_bucket<true>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
  }
  cluster_bucket<false><<<bucket_ctas, HIST_WARPS * 32, smem, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  if ((err = excl_scan::launch_dev<1>(
           a.hist, a.meta + 3 * (a.K + 1),
           (int)capped((hist_entries + excl_scan::BLOCK - 1) /
                           excl_scan::BLOCK, SCAN_CTAS),
           a.blocks, s)))
    return err;
  cluster_bucket<true><<<bucket_ctas, HIST_WARPS * 32, smem, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  switch (way_slots(max_ways)) {
    case 1: err = launch_walk<1>(a, s); break;
    case 2: err = launch_walk<2>(a, s); break;
    case 4: err = launch_walk<4>(a, s); break;
    case 8: err = launch_walk<8>(a, s); break;
    case 16: err = launch_walk<16>(a, s); break;
    default: err = launch_walk<32>(a, s);
  }
  if (err) return err;

  // About a few thousand misses a CTA: a lane's misses are at most its
  // rows times SITES.
  cluster_arbiter<TRACK_AB>
      <<<dim3(capped((a.T * SITES / 4 + 4095) / 4096, 1024), (unsigned)a.K),
         ROW_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  const int outs = a.Q * a.M * MAX_CORES;
  cluster_finish<TRACK_AB><<<(outs + 127) / 128, 128, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The built tile for the widest L2 of a launch, S sets x ways: out =
// {candidates a bucketing warp takes, bucketing warps per CTA, bucketing
// shared memory in bytes, way slots of the walker, walkers per CTA, cores
// a lane may have}.  Returns -1 for what the kernel does not take (ways
// outside 1..32, S < 1, or bucketing counters past the CTA's shared
// memory).
extern "C" int cluster_scan_tile(int S, int ways, int* out) {
  if (S < 1 || ways < 1 || ways > 32) return -1;
  const long long smem = (long long)HIST_WARPS * S * 4;
  if (smem > MAX_SMEM) return -1;
  out[0] = TILE_CANDS;
  out[1] = HIST_WARPS;
  out[2] = (int)smem;
  out[3] = way_slots(ways);
  out[4] = WALK_THREADS;
  out[5] = MAX_CORES;
  return 0;
}

// K2.  rows, lengths: as K1b's; l1_row0 (L + 1): each K1b lane's first
// row slot (its program's rows, summed over the lanes before it; row_slots
// = l1_row0[L]); l1_recs, l1_outcome, l1_hist, l1_per_lane (K1b's sets x
// tiles): K1b's kept buffers; records: K1b's access slots; k_*: (K,) the
// K2 lanes (program, cores, L2 sets, ways, channels, L2 hit cycles) and
// (K, MAX_CORES) each core's K1b lane and shift; S: the widest L2's sets
// (>= 1) and max_ways its ways; candidates, tiles, hist_entries: bounds
// on the lanes' candidates (cores x rows x sites, summed), their tiles of
// TILE_CANDS and their (set, tile) entries; scratch: row_mask (row_slots
// rounded up to 4 bytes), row_off (row_slots + 1, at least 2), miss
// (records x 2),
// miss_pm (records), meta (3 (K + 1) + 1), hist (hist_entries + 1),
// blocks (one per 1024 row slots, and at least SCAN_CTAS + 1), req
// (candidates x 2), state (candidates bytes), sums (K, MAX_CORES, 3, 3);
// o_lane (Q,), o_k1 (Q, MAX_CORES): each output's K2 lane and each core's
// K1 output; mem (M,); k1_ctr*: (Q1, M, 12) K1's counters; out*: (Q, M,
// MAX_CORES, 15) int32, zero past a lane's cores (and out_a/out_b zero
// without track_ab).  Returns -1 for what the kernel does not take, else
// the launches' cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int cluster_l2_launch(
    const int* rows, long long T, const int* lengths, int L,
    const int* l1_row0, const int* l1_recs, const unsigned char* l1_outcome,
    const int* l1_hist, long long l1_per_lane, long long records,
    long long row_slots, int K, const int* k_prog, const int* k_cores,
    const int* k_sets, const int* k_ways, const int* k_chan,
    const int* k_hit, const int* k_l1, const int* k_shift, int S,
    int max_ways, int track_ab, long long candidates, long long tiles,
    long long hist_entries, unsigned char* row_mask, int* row_off,
    int* miss, unsigned char* miss_pm, int* meta, int* hist, int* blocks,
    int* req, unsigned char* state, int* sums, int Q, int M,
    const int* o_lane, const int* o_k1, const int* mem, const int* k1_ctr,
    const int* k1_ctr_a, const int* k1_ctr_b, int* out, int* out_a,
    int* out_b, void* cuda_stream) {
  int tile[6];
  if (cluster_scan_tile(S, max_ways, tile) || T >= MAX_ROWS ||
      candidates >= (1LL << 31) || records >= (1LL << 31) ||
      row_slots >= (1LL << 31) || hist_entries >= (1LL << 31))
    return -1;
  if (T < 0 || L <= 0 || K <= 0 || Q <= 0 || M <= 0 || L > 65535 ||
      K > 65535 || row_slots < 0 || records < 0 || tiles < 0 ||
      hist_entries < 0)
    return (int)cudaErrorInvalidValue;
  K2Args a{};
  a.rows = rows;
  a.T = T;
  a.lengths = lengths;
  a.L = L;
  a.l1_row0 = l1_row0;
  a.l1_recs = reinterpret_cast<const int2*>(l1_recs);
  a.l1_outcome = l1_outcome;
  a.l1_hist = reinterpret_cast<const unsigned*>(l1_hist);
  a.l1_per_lane = l1_per_lane;
  a.row_mask = row_mask;
  a.row_off = reinterpret_cast<unsigned*>(row_off);
  a.miss = reinterpret_cast<int2*>(miss);
  a.miss_pm = miss_pm;
  a.K = K;
  a.k_prog = k_prog;
  a.k_cores = k_cores;
  a.k_sets = k_sets;
  a.k_ways = k_ways;
  a.k_chan = k_chan;
  a.k_hit = k_hit;
  a.k_l1 = k_l1;
  a.k_shift = k_shift;
  a.S = S;
  a.meta = reinterpret_cast<unsigned*>(meta);
  a.hist = reinterpret_cast<unsigned*>(hist);
  a.blocks = reinterpret_cast<unsigned*>(blocks);
  a.req = reinterpret_cast<int2*>(req);
  a.state = state;
  a.sums = reinterpret_cast<unsigned*>(sums);
  a.Q = Q;
  a.M = M;
  a.o_lane = o_lane;
  a.o_k1 = o_k1;
  a.mem = mem;
  a.k1_ctr[0] = reinterpret_cast<const unsigned*>(k1_ctr);
  a.k1_ctr[1] = reinterpret_cast<const unsigned*>(k1_ctr_a);
  a.k1_ctr[2] = reinterpret_cast<const unsigned*>(k1_ctr_b);
  a.out[0] = out;
  a.out[1] = out_a;
  a.out[2] = out_b;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  return (int)(track_ab ? launch_k2<true>(a, row_slots, records, tiles,
                                          hist_entries, max_ways, s)
                        : launch_k2<false>(a, row_slots, records, tiles,
                                           hist_entries, max_ways, s));
}
