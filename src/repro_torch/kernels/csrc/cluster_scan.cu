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
// L2's walk, not bytes or operations.  The L2 decides hit or miss from the
// order of requests within a set only, so the design walks each (lane, L2
// set) bucket on its own thread with a local clock, as K1b does each L1
// set: a stable counting sort puts each bucket in (row, rank, site) order
// (per (lane, tile of rows) a warp counts, an exclusive scan, the same
// warps scatter with __match_any_sync ranks), and the chain is the largest
// bucket.  The arbiter needs only per (row, rank) counts, which the
// counting warps and the walkers pack into one 64-bit word per row: byte r
// holds rank r's requests that missed (low nibble) and its hits (high
// nibble); one multiply gives the exclusive scan over ranks.  One walk
// serves every machine point: the cycles are a closed form.

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
constexpr int TILE_ROWS = 256;       // rows a bucketing warp takes
constexpr int HIST_WARPS = 4;        // bucketing warps in a CTA
constexpr int WALK_THREADS = 128;    // walkers in a CTA
constexpr int WALK_BATCH = 16;       // requests a walker loads ahead
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a CTA may use
constexpr long long MAX_ROWS = 1LL << 27;   // a request packs t << 3 | rank
constexpr unsigned long long NIBBLES = 0x0F0F0F0F0F0F0F0FULL;
constexpr unsigned long long BYTE_ONES = 0x0101010101010101ULL;

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
  const int* l1_reg;              // (L,) K1a lane, -1: full VRF (MEM only)
  const unsigned* l1_slot0;       // (L + 1,) first engine-order slot
  const int2* l1_recs;            // K1b's records: line, row<<4|site<<1|w
  const unsigned char* l1_outcome;  // per record: miss | write-back << 1
  const unsigned* l1_hist;        // K1b's bucket offsets
  int l1_sets, l1_tiles;
  int* miss;                      // (slots,) L1-missed line or -1
  int K;                          // K2 lanes
  const int* k_prog;              // (K,) program, cores, L2 sets (0: none),
  const int* k_cores;             // ways, channels, L2 hit cycles
  const int* k_sets;
  const int* k_ways;
  const int* k_chan;
  const int* k_hit;
  const int* k_l1;                // (K, MAX_CORES) each core's K1b lane
  const int* k_shift;             // (K, MAX_CORES) each core's line shift
  int S, tiles;                   // the widest L2's sets; tiles of rows
  unsigned* hist;                 // (K * S * tiles + 1) counts -> offsets
  unsigned* blocks;
  int2* req;                      // bucketed requests: line, t << 3 | rank
  unsigned long long* counts;     // (K, T) per row: a byte per rank
  unsigned* sums;                 // (K, MAX_CORES, NSETS, NSUM)
  int Q, M;
  const int* o_lane;              // (Q,) K2 lane of each output
  const int* o_k1;                // (Q, MAX_CORES) each core's K1 output
  const int* mem;                 // (M,) memory latency
  const unsigned* k1_ctr[NSETS];  // (Q1, M, NCTR) K1's counters
  int* out[NSETS];                // (Q, M, MAX_CORES, NCL)
};

// K1b's misses back into engine order: miss[slot] = the missed line.
__global__ void cluster_misses(K2Args a) {
  const int j = blockIdx.y;
  const size_t per_lane = (size_t)a.l1_sets * a.l1_tiles;
  const unsigned lo = a.l1_hist[j * per_lane];
  const unsigned hi = a.l1_hist[(j + 1) * per_lane];
  const int nsites = a.l1_reg[j] >= 0 ? SITES : 2;
  const unsigned s0 = a.l1_slot0[j];
  for (unsigned k = lo + blockIdx.x * blockDim.x + threadIdx.x; k < hi;
       k += gridDim.x * blockDim.x) {
    if (!(a.l1_outcome[k] & 1u)) continue;
    const int2 r = a.l1_recs[k];
    const unsigned row = (unsigned)r.y >> 4, site = ((unsigned)r.y >> 1) & 7u;
    a.miss[s0 + row * nsites + site - (SITES - nsites)] = r.x;
  }
}

// Bucketing, one warp per (K2 lane, tile), over the tile's (row, rank,
// site) slots in order.  SCATTER false: add each request to its (row,
// rank)'s count and to its L2 set's count, hist[(k * S + set) * tiles +
// tile].  SCATTER true: hist holds the offsets; write each request to its
// bucket (the tile's warp owns its slice of every bucket of its lane).
template <bool SCATTER>
__global__ void __launch_bounds__(HIST_WARPS * 32) cluster_bucket(K2Args a) {
  extern __shared__ unsigned cnt_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * HIST_WARPS + warp;
  const int k = (int)(gw / a.tiles), tile = (int)(gw % a.tiles);
  if (k >= a.K) return;                      // whole warps only
  const int sets = a.k_sets[k];
  if (SCATTER && !sets) return;
  unsigned* cnt = cnt_smem + warp * a.S;
  const size_t hbase = (size_t)k * a.S * a.tiles + tile;
  for (int s = lane; s < sets; s += 32)
    cnt[s] = SCATTER ? a.hist[hbase + (size_t)s * a.tiles] : 0u;
  __syncwarp();
  const int n = a.k_cores[k], p = a.k_prog[k];
  const int* l1 = a.k_l1 + k * MAX_CORES;
  const int* shift = a.k_shift + k * MAX_CORES;
  const long long len = a.lengths[p];
  const long long t0 = (long long)tile * TILE_ROWS;
  const long long t1 = min(len, t0 + TILE_ROWS);
  const int per_row = n * SITES;
  const int slots = t0 < t1 ? (int)(t1 - t0) * per_row : 0;
  for (int base = 0; base < slots; base += 32) {
    const int i = base + lane;
    bool on = false;
    int line = 0, rank = 0;
    long long t = 0;
    if (i < slots) {
      t = t0 + i / per_row;
      rank = (i % per_row) / SITES;
      const int site = i % SITES;
      const int c = (int)((t % n + rank) % n);
      const int j = l1[c];
      const int skip = a.l1_reg[j] >= 0 ? 0 : SITES - 2;
      if (site >= skip) {
        const int m = a.miss[a.l1_slot0[j] +
                             (unsigned)t * (unsigned)(SITES - skip) +
                             (unsigned)(site - skip)];
        line = (int)((unsigned)m + (unsigned)shift[c]);
        on = m != -1 && line >= 0;
      }
    }
    if (!SCATTER) {
      if (on) {
        atomicAdd(&a.counts[k * a.T + t], 1ull << (8 * rank));
        if (sets) atomicAdd(&cnt[line & (sets - 1)], 1u);
      }
      continue;
    }
    // Requests of one chunk to one set keep their order: each takes the
    // set's next offset plus its rank among the chunk's earlier ones.
    const int s = on ? line & (sets - 1) : 0;
    const unsigned peers = __match_any_sync(FULL, on ? s : -1 - lane);
    const unsigned before = __popc(peers & ((1u << lane) - 1u));
    if (on)
      a.req[cnt[s] + before] =
          make_int2(line, (int)((unsigned)t << 3 | (unsigned)rank));
    __syncwarp();
    if (on && before == 0) cnt[s] += __popc(peers);
    __syncwarp();
  }
  if (!SCATTER) {
    __syncwarp();
    for (int s = lane; s < sets; s += 32)
      a.hist[hbase + (size_t)s * a.tiles] = cnt[s];
  }
}

// One thread per (K2 lane, L2 set): walk the bucket through the set's ways,
// kept in registers (WAYS a power of two >= the lane's ways), and move each
// hit from its (row, rank)'s request count to its hit count.
template <int WAYS>
__global__ void __launch_bounds__(WALK_THREADS) cluster_walk(K2Args a) {
  const long long g = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (g >= (long long)a.K * a.S) return;
  const int k = (int)(g / a.S), set = (int)(g % a.S);
  if (set >= a.k_sets[k]) return;
  const int ways = a.k_ways[k];
  unsigned long long* cnt = a.counts + (size_t)k * a.T;
  const unsigned lo = a.hist[g * a.tiles];
  const unsigned hi = a.hist[(g + 1) * a.tiles];
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
      const unsigned info = (unsigned)cur[b].y;
      int way = -1;
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i < ways && way < 0 && tag[i] == line) way = i;
      if (way >= 0) {
        atomicAdd(&cnt[info >> 3], 15ull << (8 * (info & 7u)));
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

// The arbiter per (K2 lane, row): rank r's queue rounds are the requests
// of earlier ranks that missed the L2 over the channels; the weighted
// hits, misses and rounds are summed per core.  A CTA grid-strides over
// lane blockIdx.y's rows.
template <bool TRACK_AB>
__global__ void cluster_arbiter(K2Args a) {
  const int k = blockIdx.y;
  const int n = a.k_cores[k], p = a.k_prog[k];
  const unsigned chan = (unsigned)a.k_chan[k];
  const long long len = a.lengths[p];
  const unsigned long long* cnt = a.counts + (size_t)k * a.T;
  unsigned acc[MAX_CORES][NSETS][NSUM] = {};
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < len; t += (long long)gridDim.x * blockDim.x) {
    const unsigned long long word = cnt[t];
    if (!word) continue;
    const unsigned long long missed = word & NIBBLES;
    const unsigned long long hits = (word >> 4) & NIBBLES;
    // byte r: the misses of ranks < r (no byte passes 8 x 8)
    const unsigned long long earlier = (missed * BYTE_ONES) << 8;
    const int first = (int)(t % n);
    const int* x = a.rows + ((size_t)p * a.T + t) * NCOL;
    unsigned w[NSETS];
#pragma unroll
    for (int s = 0; s < NSETS; ++s) w[s] = (unsigned)x[WT + s];
#pragma unroll
    for (int c = 0; c < MAX_CORES; ++c) {
      if (c >= n) break;
      const int sh = 8 * ((c - first + n) % n);   // core c's rank
      const unsigned v[NSUM] = {(unsigned)(hits >> sh) & 0xffu,
                                (unsigned)(missed >> sh) & 0xffu,
                                ((unsigned)(earlier >> sh) & 0xffu) / chan};
#pragma unroll
      for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s)
#pragma unroll
        for (int i = 0; i < NSUM; ++i) acc[c][s][i] += w[s] * v[i];
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_CORES; ++c)
#pragma unroll
    for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s)
#pragma unroll
      for (int i = 0; i < NSUM; ++i) {
        unsigned v = acc[c][s][i];
#pragma unroll
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        if ((threadIdx.x & 31) == 0 && v)
          atomicAdd(&a.sums[(((size_t)k * MAX_CORES + c) * NSETS + s) * NSUM +
                            i],
                    v);
      }
}

// The closed form per (output, machine, core).
template <bool TRACK_AB>
__global__ void cluster_finish(K2Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.Q * a.M * MAX_CORES) return;
  const int c = i % MAX_CORES, m = (i / MAX_CORES) % a.M;
  const int o = i / (MAX_CORES * a.M);
  const int k = a.o_lane[o];
  if (c >= a.k_cores[k]) return;               // left zero
  const unsigned lat = (unsigned)a.mem[m], hit = (unsigned)a.k_hit[k];
  const int q1 = a.o_k1[o * MAX_CORES + c];
#pragma unroll
  for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s) {
    const unsigned* e = a.k1_ctr[s] + ((size_t)q1 * a.M + m) * NCTR;
    const unsigned* u =
        a.sums + (((size_t)k * MAX_CORES + c) * NSETS + s) * NSUM;
    const unsigned stall = lat * u[2];
    int* d = a.out[s] + (size_t)i * NCL;
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

template <bool TRACK_AB>
cudaError_t launch_k2(const K2Args& a, long long slots, int max_ways,
                      cudaStream_t s) {
  cudaError_t err;
  const long long n = (long long)a.K * a.S * a.tiles;
  if ((err = cudaMemsetAsync(a.miss, 0xff, sizeof(int) * slots, s)) ||
      (err = cudaMemsetAsync(a.hist, 0, sizeof(unsigned) * (n + 1), s)) ||
      (err = cudaMemsetAsync(a.counts, 0,
                             sizeof(unsigned long long) * a.K * a.T, s)) ||
      (err = cudaMemsetAsync(
           a.sums, 0, sizeof(unsigned) * a.K * MAX_CORES * NSETS * NSUM, s)))
    return err;
  // About a few thousand records a CTA, at least one CTA a lane.
  const long long per_lane = slots / a.L + 1;
  const long long mctas = (per_lane + 4095) / 4096;
  cluster_misses<<<dim3((unsigned)(mctas < 1024 ? mctas : 1024),
                        (unsigned)a.L),
                   256, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  const long long warps = (long long)a.K * a.tiles;
  const unsigned bucket_ctas =
      (unsigned)((warps + HIST_WARPS - 1) / HIST_WARPS);
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
  if ((err = excl_scan::launch<1>(a.hist, n, a.blocks, s))) return err;
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

  const long long rctas = (a.T + 4095) / 4096;
  cluster_arbiter<TRACK_AB>
      <<<dim3((unsigned)(rctas < 1024 ? (rctas > 0 ? rctas : 1) : 1024),
              (unsigned)a.K),
         256, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  const int outs = a.Q * a.M * MAX_CORES;
  cluster_finish<TRACK_AB><<<(outs + 127) / 128, 128, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The built tile for the widest L2 of a launch, S sets x ways: out = {rows a
// bucketing warp takes, bucketing warps per CTA, bucketing shared memory in
// bytes, way slots of the walker, walkers per CTA, cores a lane may have}.
// Returns -1 for what the kernel does not take (ways outside 1..32, S < 1,
// or bucketing counters past the CTA's shared memory).
extern "C" int cluster_scan_tile(int S, int ways, int* out) {
  if (S < 1 || ways < 1 || ways > 32) return -1;
  const long long smem = (long long)HIST_WARPS * S * 4;
  if (smem > MAX_SMEM) return -1;
  out[0] = TILE_ROWS;
  out[1] = HIST_WARPS;
  out[2] = (int)smem;
  out[3] = way_slots(ways);
  out[4] = WALK_THREADS;
  out[5] = MAX_CORES;
  return 0;
}

// K2.  rows, lengths: as K1b's; l1_reg, l1_slot0 (L + 1), l1_recs,
// l1_outcome, l1_hist, l1_sets, l1_tiles: K1b's lanes and kept buffers;
// slots: K1b's access slots, miss: (slots,) scratch; k_*: (K,) the K2
// lanes (program, cores, L2 sets, ways, channels, L2 hit cycles) and (K,
// MAX_CORES) each core's K1b lane and shift; S: the widest L2's sets (>= 1)
// and max_ways its ways; requests: the bound on the requests (rows x sites
// x cores, summed); scratch: hist (K * S * tiles + 1), blocks (one per
// 1024 hist entries), req (requests x 2), counts (K, T) int64, sums (K,
// MAX_CORES, 3, 3); o_lane (Q,), o_k1 (Q, MAX_CORES): each output's K2 lane
// and each core's K1 output; mem (M,); k1_ctr*: (Q1, M, 12) K1's counters;
// out*: (Q, M, MAX_CORES, 15) int32, zero past a lane's cores (out_a/out_b
// written only when track_ab).  Returns -1 for what the kernel does not
// take, else the launches' cudaError_t (0 on success); runs on `stream`
// and does not synchronise.
extern "C" int cluster_l2_launch(
    const int* rows, long long T, const int* lengths, int L,
    const int* l1_reg, const int* l1_slot0, const int* l1_recs,
    const unsigned char* l1_outcome, const int* l1_hist, int l1_sets,
    int l1_tiles, long long slots, int* miss, int K, const int* k_prog,
    const int* k_cores, const int* k_sets, const int* k_ways,
    const int* k_chan, const int* k_hit, const int* k_l1,
    const int* k_shift, int S, int max_ways, int track_ab,
    long long requests, int* hist, int* blocks, int* req, long long* counts,
    int* sums, int Q, int M, const int* o_lane, const int* o_k1,
    const int* mem, const int* k1_ctr, const int* k1_ctr_a,
    const int* k1_ctr_b, int* out, int* out_a, int* out_b,
    void* cuda_stream) {
  int tile[6];
  if (cluster_scan_tile(S, max_ways, tile) || T >= MAX_ROWS ||
      requests >= (1LL << 31) || slots >= (1LL << 31))
    return -1;
  if (T < 0 || L <= 0 || K <= 0 || Q <= 0 || M <= 0 || L > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(T > 0 ? (T + TILE_ROWS - 1) / TILE_ROWS : 1);
  K2Args a{};
  a.rows = rows;
  a.T = T;
  a.lengths = lengths;
  a.L = L;
  a.l1_reg = l1_reg;
  a.l1_slot0 = reinterpret_cast<const unsigned*>(l1_slot0);
  a.l1_recs = reinterpret_cast<const int2*>(l1_recs);
  a.l1_outcome = l1_outcome;
  a.l1_hist = reinterpret_cast<const unsigned*>(l1_hist);
  a.l1_sets = l1_sets;
  a.l1_tiles = l1_tiles;
  a.miss = miss;
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
  a.tiles = tiles;
  a.hist = reinterpret_cast<unsigned*>(hist);
  a.blocks = reinterpret_cast<unsigned*>(blocks);
  a.req = reinterpret_cast<int2*>(req);
  a.counts = reinterpret_cast<unsigned long long*>(counts);
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
  return (int)(track_ab ? launch_k2<true>(a, slots, max_ways, s)
                        : launch_k2<false>(a, slots, max_ways, s));
}
