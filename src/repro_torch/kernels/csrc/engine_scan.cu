// The engine scan (K1) for Hopper (sm_90a), plain C interface: two
// kernels, K1a (the cVRF pass) and K1b (the L1 pass).
//
// Replaces the reference's cycle engine, src/repro/core/simulator.py
// `_run_grid` (:386): one `lax.scan` of `_make_step`/`_make_body` (:344,
// :234) under three `vmap`s, with `_l1_access` (:190) and the policies of
// src/repro/core/policies.py (`lookup`, `free_slot`, `select_victim`,
// `apply_access`).  XLA compiles it; there is no `pallas_call`.
//
// What it computes.  Each lane of the (program, config, machine) grid walks
// its program's T instruction rows in order.  A row holds up to three REG
// accesses (vs1, vs2, vd), tag-checked serially against a fully
// associative cVRF of `capacity` slots; a miss picks a victim by
// FIFO/LRU/LFU/OPT among occupied slots whose tag is not locked, spills it
// through the L1 if dirty and fills the missing register.  Then up to two
// MEM accesses go through the same set-associative, LRU, write-back L1.
// Each row adds its 12 counters (simulator.COUNTER_NAMES) times the fold
// weight `wt`, and times `wa`/`wb` into the measured periods A and B.
//
// What bounds it on the card: the longest chain of dependent steps, not
// bytes or operations.  The design cuts that chain where the reference's
// body allows:
//   * nothing the L1 returns feeds the cVRF, so K1a runs the cVRF once per
//     (program, cVRF class) lane, for every machine and L1: its chain is
//     the lane's rows, each a few warp votes; a full VRF (capacity >= 32)
//     never misses and launches nothing;
//   * an access touches one L1 set only, and hits, misses and write-backs
//     do not depend on the latencies, so K1b buckets each lane's accesses
//     by set (a stable counting sort: histogram, exclusive scan, scatter)
//     and walks every (lane, set) bucket on its own thread, its ways in
//     registers: its chain is the largest bucket.  Cycles are linear in
//     the hit and memory latencies given the weighted accesses, misses and
//     write-backs of each access class, so one walk serves every machine.
//
// K1a.  One warp per lane: thread i holds cVRF slot i's metadata in
// registers; `lookup` and `free_slot` are ballots (first set bit = the
// first index), `select_victim` a warp min-reduction and a ballot.  Each
// warp stages CHUNK rows in shared memory, the next chunk's loads in
// flight, and writes per row its spill and fill accesses (REG_SITES bytes:
// the register, -1 where inactive) and sums its REG counters.
//
// K1b.  Per launch: trace sums per program (cost, REG and MEM counts times
// the weights); per (lane, tile of TILE_ROWS rows) a warp counts the
// tile's accesses per set; an exclusive scan of the (lane, set, tile)
// counts; the same warps scatter each access, in engine order, to its
// bucket as (line, row << 4 | site << 1 | write); one thread per (lane,
// set) walks its bucket through the set's ways (first equal tag on a hit,
// first least `now << 1 | dirty` word on a miss, free ways holding 0) and
// stores a miss / write-back byte per access; a weighted reduction per
// lane; the closed form per (output, machine).  Counters are summed in
// uint32, so an overflow wraps as the reference's int32 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NOW_STEP = 6;         // events.NUM_SLOTS: `now` per row
constexpr int NCOL = 24;            // int32 columns of a packed row
constexpr int CHUNK = 32;           // K1a: rows a warp stages at a time
constexpr int REG_WARPS = 4;        // K1a: lanes (warps) in a CTA
constexpr int REG_SITES = 6;        // K1a: spill, fill of REG slots 0..2
constexpr int SITES = 8;            // + MEM lanes 0, 1
constexpr int NSETS = 3;            // counter sets: total, period A, B
constexpr int NREG = 6;             // K1a's counters
constexpr int NL1 = 6;              // K1b's sums per lane and set
constexpr int NTR = 6;              // trace sums per program and set
constexpr int NCTR = 12;            // simulator.COUNTER_NAMES
constexpr int TILE_ROWS = 1024;     // K1b: rows a bucketing warp takes
constexpr int HIST_WARPS = 4;       // K1b: bucketing warps in a CTA
constexpr int SCAN_BLOCK = 1024;    // K1b: entries a scan CTA takes
constexpr int WALK_THREADS = 128;   // K1b: walkers in a CTA
constexpr int WALK_BATCH = 16;      // K1b: records a walker loads ahead
constexpr int PER_THREAD = CHUNK * NCOL / 32;
constexpr int INT_MAX_ = 0x7fffffff;
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a CTA may use
constexpr long long MAX_ROWS = 1LL << 27;

// Column offsets of a packed row (kernels/engine_scan.py COLUMNS).
enum {
  RV = 0, REG = 3, VDW = 6, VDR = 7, VDNF = 8, LK1 = 9, LK2 = 10, MV = 11,
  ML = 13, MW = 15, COST = 17, NXT = 18, WT = 21, WA = 22, WB = 23
};
enum { FIFO = 0, LRU = 1, LFU = 2, OPT = 3 };
constexpr int LFU_FREQ_CAP = 511;
constexpr int LFU_SEQ_BITS = 21;

int way_slots(int ways) {
  int w = 1;
  while (w < ways) w <<= 1;
  return w;
}

// ------------------------------------------------------------------ K1a --

struct RegArgs {
  const int* rows;      // (P, T, NCOL) int32
  long long T;
  const int* lengths;   // (P,) rows to walk; the rest is padding
  const int* prog;      // (R,) program, capacity, policy, alloc_no_fetch
  const int* cap;
  const int* pol;
  const int* anf;
  int R;
  signed char* stream;  // (R, T, REG_SITES) register spilled/filled or -1
  unsigned* ctr;        // (R, NSETS, NREG)
};

template <bool TRACK_AB>
__global__ void __launch_bounds__(REG_WARPS * 32) engine_reg(RegArgs a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * REG_WARPS + warp;
  if (r >= a.R) return;                      // whole warps only
  int* stage = smem + warp * (CHUNK * NCOL + CHUNK * REG_SITES / 4);
  signed char* out = reinterpret_cast<signed char*>(stage + CHUNK * NCOL);

  const int p = a.prog[r];
  const int capacity = a.cap[r], policy = a.pol[r], anf = a.anf[r] != 0;
  const bool valid = lane < capacity;
  // Slot `lane` of the cVRF (policies.py's columns).
  int tag = -1, dirty = 0, ins_seq = 0, last_use = 0, freq = 0;
  int next_use = 0;                  // (the engine never pins a slot)
  unsigned seq = 0, now0 = 0;
  unsigned ctr[NSETS][NREG] = {};

  const int* src = a.rows + (size_t)p * (size_t)a.T * NCOL;
  signed char* dst = a.stream + (size_t)r * (size_t)a.T * REG_SITES;
  const long long len = a.lengths[p];
  int pre[PER_THREAD];
  auto fetch = [&](long long t0) {
    const long long n =
        (len - t0 < CHUNK ? len - t0 : (long long)CHUNK) * NCOL;
    const int* s = src + t0 * NCOL;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int k = lane + 32 * i;
      pre[i] = k < n ? __ldg(s + k) : 0;
    }
  };
  if (len > 0) fetch(0);

  for (long long t0 = 0; t0 < len; t0 += CHUNK) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) stage[lane + 32 * i] = pre[i];
    __syncwarp();
    const int n = (int)(len - t0 < CHUNK ? len - t0 : CHUNK);
    if (t0 + CHUNK < len) fetch(t0 + CHUNK);   // in flight during the walk

    for (int k = 0; k < n; ++k, now0 += NOW_STEP) {
      int x[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) x[i] = stage[k * NCOL + i];
      unsigned hits = 0, misses = 0, spills = 0, fills = 0, rr = 0, rw = 0;
      int site[REG_SITES] = {-1, -1, -1, -1, -1, -1};

      // REG lanes in the hardware's serial tag-check order.
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (!x[RV + s]) continue;
        const int wr = s == 2 ? x[VDW] != 0 : 0;
        const int rd = s == 2 ? x[VDR] != 0 : 1;
        rr += rd;
        rw += wr;
        const int reg = x[REG + s];
        const int nxt = x[NXT + s];
        const int now = (int)(now0 + s);
        const unsigned hm = __ballot_sync(FULL, valid && tag == reg);
        if (hm) {
          ++hits;
          if (lane == __ffs(hm) - 1) {   // FIFO keeps its insertion order
            dirty |= wr;
            last_use = now;
            freq = (int)((unsigned)freq + 1u);
            next_use = nxt;
          }
          continue;
        }
        ++misses;
        const unsigned fm = __ballot_sync(FULL, valid && tag < 0);
        const int lock_a = s >= 1 ? x[LK1] : -1;
        const int lock_b = s == 2 ? x[LK2] : -1;
        const bool occ = tag >= 0 && valid && tag != lock_a && tag != lock_b;
        int metric;
        switch (policy) {
          case LRU: metric = last_use; break;
          case LFU:
            metric = (int)(((unsigned)min(freq, LFU_FREQ_CAP)
                            << LFU_SEQ_BITS) +
                           (unsigned)(ins_seq & ((1 << LFU_SEQ_BITS) - 1)));
            break;
          case OPT: metric = (int)(0u - (unsigned)next_use); break;
          default: metric = ins_seq;
        }
        metric = occ ? metric : INT_MAX_;
        const int least = __reduce_min_sync(FULL, metric);
        const int victim = __ffs(__ballot_sync(FULL, metric == least)) - 1;
        const int vtag = __shfl_sync(FULL, tag, victim);
        const int vdirty = __shfl_sync(FULL, dirty, victim);
        const int slot = fm ? __ffs(fm) - 1 : victim;
        if (!fm && vdirty == 1) {        // spill the evictee to its line
          ++spills;
          site[2 * s] = max(vtag, 0);
        }
        if (rd || !(s == 2 && x[VDNF] && anf)) {   // fill the register
          ++fills;
          site[2 * s + 1] = max(reg, 0);
        }
        if (lane == slot) {
          tag = reg;
          dirty = wr;
          ins_seq = (int)seq;
          last_use = now;
          freq = 1;
          next_use = nxt;
        }
        ++seq;
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < REG_SITES; ++i)
          out[k * REG_SITES + i] = (signed char)site[i];
      }

      const unsigned inc[NREG] = {hits, misses, spills, fills, rr, rw};
      const unsigned w[NSETS] = {(unsigned)x[WT], (unsigned)x[WA],
                                 (unsigned)x[WB]};
#pragma unroll
      for (int j = 0; j < (TRACK_AB ? NSETS : 1); ++j)
#pragma unroll
        for (int i = 0; i < NREG; ++i) ctr[j][i] += inc[i] * w[j];
    }
    __syncwarp();
    signed char* d = dst + t0 * REG_SITES;
    for (int i = lane; i < n * REG_SITES; i += 32) d[i] = out[i];
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NSETS; ++j)
#pragma unroll
      for (int i = 0; i < NREG; ++i)
        a.ctr[((size_t)r * NSETS + j) * NREG + i] = TRACK_AB || j == 0
                                                        ? ctr[j][i]
                                                        : 0u;
  }
}

// ------------------------------------------------------------------ K1b --

struct L1Args {
  const int* rows;            // (P, T, NCOL) int32
  long long T;
  int P;
  const int* lengths;         // (P,)
  const int* spill0;          // (P,) first spill cacheline
  const signed char* stream;  // (R, T, REG_SITES) K1a's accesses
  const unsigned* reg_ctr;    // (R, NSETS, NREG) K1a's counters
  int L;
  const int* l1_prog;         // (L,) program of each K1b lane
  const int* l1_reg;          // (L,) its K1a lane, -1: the full VRF
  int Q;
  const int* out_l1;          // (Q,) K1b lane of each output
  int M;
  const int* l1h;             // (M,) L1 hit, uop hit, memory latency
  const int* uop;
  const int* mem;
  int sets, ways, tiles;
  int NP;
  const int* tprog;           // (NP,) programs of the launch
  unsigned* hist;             // (L * sets * tiles + 1) counts -> offsets
  unsigned* blocks;           // scan: one sum per SCAN_BLOCK entries
  int2* recs;                 // bucketed accesses: line, row<<4|site<<1|w
  unsigned char* outcome;     // per record: miss | write-back << 1
  unsigned* l1sum;            // (L, NSETS, NL1)
  unsigned* tsum;             // (P, NSETS, NTR)
  int* ctr;                   // (Q, M, NCTR): total, period A, period B
  int* ctrA;
  int* ctrB;
};

__device__ __forceinline__ int floor_mod(int v, int m) {
  const int s = v % m;
  return s < 0 ? s + m : s;           // Python's %: line -1 -> last set
}

// Access slot k of rows [t0, ...) of K1b lane j: its row, site, line and
// write flag; false where the site is inactive.
__device__ __forceinline__ bool access_at(const L1Args& a, int p, int r,
                                          int nsites, long long t0, int k,
                                          long long& t, int& site, int& line,
                                          int& write) {
  t = t0 + k / nsites;
  site = nsites == SITES ? k % SITES : REG_SITES + k % 2;
  if (site < REG_SITES) {
    const int reg = a.stream[((size_t)r * a.T + t) * REG_SITES + site];
    line = (int)((unsigned)a.spill0[p] + (unsigned)reg);
    write = (site & 1) == 0;          // a spill writes, a fill reads
    return reg >= 0;
  }
  const int* row = a.rows + ((size_t)p * a.T + t) * NCOL;
  const int m = site - REG_SITES;
  line = row[ML + m];
  write = row[MW + m] != 0;
  return row[MV + m] != 0;
}

// The trace sums per program: cost, REG accesses, REG reads, REG writes,
// MEM reads, MEM writes, times wt, wa and wb.
template <bool TRACK_AB>
__global__ void l1_trace_sums(L1Args a) {
  const int p = a.tprog[blockIdx.y];
  const long long len = a.lengths[p];
  unsigned acc[NSETS][NTR] = {};
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < len; t += (long long)gridDim.x * blockDim.x) {
    const int* x = a.rows + ((size_t)p * a.T + t) * NCOL;
    const unsigned act = (x[RV] != 0) + (x[RV + 1] != 0) + (x[RV + 2] != 0);
    const unsigned rd = (x[RV] != 0) + (x[RV + 1] != 0) +
                        (x[RV + 2] != 0 && x[VDR] != 0);
    const unsigned wr = x[RV + 2] != 0 && x[VDW] != 0;
    unsigned mr = 0, mw = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (!x[MV + m]) continue;
      x[MW + m] ? ++mw : ++mr;
    }
    const unsigned v[NTR] = {(unsigned)x[COST], act, rd, wr, mr, mw};
#pragma unroll
    for (int j = 0; j < (TRACK_AB ? NSETS : 1); ++j) {
      const unsigned w = (unsigned)x[WT + j];
#pragma unroll
      for (int i = 0; i < NTR; ++i) acc[j][i] += v[i] * w;
    }
  }
#pragma unroll
  for (int j = 0; j < (TRACK_AB ? NSETS : 1); ++j)
#pragma unroll
    for (int i = 0; i < NTR; ++i) {
      unsigned v = acc[j][i];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if ((threadIdx.x & 31) == 0 && v)
        atomicAdd(&a.tsum[((size_t)p * NSETS + j) * NTR + i], v);
    }
}

// Bucketing, one warp per (lane, tile).  SCATTER false: count the tile's
// accesses per set into hist[(j * sets + s) * tiles + tile].  SCATTER
// true: hist holds the exclusive offsets; write each access, in engine
// order, to its bucket (the tile's warp owns its slice of every bucket).
template <bool SCATTER>
__global__ void __launch_bounds__(HIST_WARPS * 32) l1_bucket(L1Args a) {
  extern __shared__ unsigned cnt_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * HIST_WARPS + warp;
  const int j = (int)(gw / a.tiles), tile = (int)(gw % a.tiles);
  if (j >= a.L) return;                      // whole warps only
  unsigned* cnt = cnt_smem + warp * a.sets;
  const size_t hbase = (size_t)j * a.sets * a.tiles + tile;
  for (int s = lane; s < a.sets; s += 32)
    cnt[s] = SCATTER ? a.hist[hbase + (size_t)s * a.tiles] : 0u;
  __syncwarp();
  const int p = a.l1_prog[j], r = a.l1_reg[j];
  const int nsites = r >= 0 ? SITES : 2;
  const long long len = a.lengths[p];
  const long long t0 = (long long)tile * TILE_ROWS;
  const long long t1 = min(len, t0 + TILE_ROWS);
  const int slots = t0 < t1 ? (int)(t1 - t0) * nsites : 0;
  for (int base = 0; base < slots; base += 32) {
    const int k = base + lane;
    long long t = 0;
    int site = 0, line = 0, write = 0;
    const bool on = k < slots &&
                    access_at(a, p, r, nsites, t0, k, t, site, line, write);
    const int s = on ? floor_mod(line, a.sets) : 0;
    if (!SCATTER) {
      if (on) atomicAdd(&cnt[s], 1u);
      continue;
    }
    // Accesses of one chunk to one set keep their order: each takes the
    // set's next offset plus its rank among the chunk's earlier ones.
    const unsigned peers = __match_any_sync(FULL, on ? s : -1 - lane);
    const unsigned rank = __popc(peers & ((1u << lane) - 1u));
    if (on) {
      const unsigned pos = cnt[s] + rank;
      a.recs[pos] = make_int2(line, (int)(t << 4) | site << 1 | write);
    }
    __syncwarp();
    if (on && rank == 0) cnt[s] += __popc(peers);
    __syncwarp();
  }
  if (!SCATTER) {
    __syncwarp();
    for (int s = lane; s < a.sets; s += 32)
      a.hist[hbase + (size_t)s * a.tiles] = cnt[s];
  }
}

// Exclusive scan of n entries in three passes: per-CTA sums, a scan of
// the sums in one CTA, then each CTA's entries with its offset.
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

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = SCAN_BLOCK / SCAN_THREADS;

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_sums(const unsigned* v, long long n, unsigned* blocks) {
  const long long b0 = (long long)blockIdx.x * SCAN_BLOCK;
  unsigned s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * SCAN_ITEMS + i;
    if (k < n) s += v[k];
  }
  unsigned total;
  block_exclusive_scan(s, total);
  if (threadIdx.x == 0) blocks[blockIdx.x] = total;
}

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

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_apply(unsigned* v, long long n, const unsigned* blocks) {
  const long long b0 = (long long)blockIdx.x * SCAN_BLOCK;
  unsigned item[SCAN_ITEMS];
  unsigned s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * SCAN_ITEMS + i;
    item[i] = k < n ? v[k] : 0u;
    s += item[i];
  }
  unsigned total;
  unsigned run = blocks[blockIdx.x] + block_exclusive_scan(s, total);
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long k = b0 + threadIdx.x * SCAN_ITEMS + i;
    if (k < n) v[k] = run;
    run += item[i];
  }
}

// One thread per (lane, set): walk the bucket through the set's ways, kept
// in registers (WAYS a power of two >= the geometry's ways), and store
// each access's outcome.
template <int WAYS>
__global__ void __launch_bounds__(WALK_THREADS) l1_walk(L1Args a) {
  const long long g = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (g >= (long long)a.L * a.sets) return;
  const unsigned lo = a.hist[g * a.tiles];
  const unsigned hi = a.hist[(g + 1) * a.tiles];
  int tag[WAYS], word[WAYS];
#pragma unroll
  for (int i = 0; i < WAYS; ++i) {
    tag[i] = -1;
    word[i] = 0;
  }
  int2 cur[WALK_BATCH], nxt[WALK_BATCH];
#pragma unroll
  for (int b = 0; b < WALK_BATCH; ++b)
    cur[b] = lo + b < hi ? __ldg(&a.recs[lo + b]) : make_int2(0, 0);
  for (unsigned k0 = lo; k0 < hi; k0 += WALK_BATCH) {
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) {      // in flight during the walk
      const unsigned k = k0 + WALK_BATCH + b;
      nxt[b] = k < hi ? __ldg(&a.recs[k]) : make_int2(0, 0);
    }
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) {
      if (k0 + b >= hi) break;
      const int line = cur[b].x;
      const unsigned info = (unsigned)cur[b].y;
      const unsigned row = info >> 4, site = (info >> 1) & 7u;
      const unsigned w = info & 1u;
      const unsigned now =
          NOW_STEP * row + (site < REG_SITES ? site >> 1 : site - 3);
      int way = -1;
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i < a.ways && way < 0 && tag[i] == line) way = i;
      const bool hit = way >= 0;
      if (!hit) {                     // the first least word
        way = 0;
        int least = word[0];
#pragma unroll
        for (int i = 1; i < WAYS; ++i)
          if (i < a.ways && word[i] < least) {
            least = word[i];
            way = i;
          }
      }
      int old_tag = 0, old_word = 0;
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i == way) {
          old_tag = tag[i];
          old_word = word[i];
        }
      const unsigned od = (unsigned)old_word & 1u;
      const bool wb = !hit && old_tag >= 0 && od;
      const int nw = (int)((now << 1) | (hit ? od | w : w));
#pragma unroll
      for (int i = 0; i < WAYS; ++i)
        if (i == way) {
          tag[i] = line;
          word[i] = nw;
        }
      a.outcome[k0 + b] = (unsigned char)(!hit | wb << 1);
    }
#pragma unroll
    for (int b = 0; b < WALK_BATCH; ++b) cur[b] = nxt[b];
  }
}

// The weighted accesses, misses and write-backs of each access class per
// lane: a CTA grid-strides over lane blockIdx.y's records.
template <bool TRACK_AB>
__global__ void l1_reduce(L1Args a) {
  const int j = blockIdx.y;
  const int p = a.l1_prog[j];
  const size_t per_lane = (size_t)a.sets * a.tiles;
  const unsigned lo = a.hist[j * per_lane], hi = a.hist[(j + 1) * per_lane];
  unsigned acc[NSETS][NL1] = {};
  for (unsigned k = lo + blockIdx.x * blockDim.x + threadIdx.x; k < hi;
       k += gridDim.x * blockDim.x) {
    const unsigned info = (unsigned)a.recs[k].y;
    const unsigned o = a.outcome[k];
    const int* x = a.rows + ((size_t)p * a.T + (info >> 4)) * NCOL;
    const bool uop = ((info >> 1) & 7u) < REG_SITES;
    const unsigned miss = o & 1u, wb = o >> 1;
#pragma unroll
    for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s) {
      const unsigned w = (unsigned)x[WT + s];
      if (uop) {
        acc[s][0] += w;
        acc[s][1] += w * miss;
        acc[s][2] += w * wb;
      } else {
        acc[s][3] += w;
        acc[s][4] += w * miss;
        acc[s][5] += w * wb;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s)
#pragma unroll
    for (int i = 0; i < NL1; ++i) {
      unsigned v = acc[s][i];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if ((threadIdx.x & 31) == 0 && v)
        atomicAdd(&a.l1sum[((size_t)j * NSETS + s) * NL1 + i], v);
    }
}

// The closed form per (output, machine): stall and memory cycles are the
// hit cost times the accesses plus the memory latency times the misses
// and write-backs of each class.
template <bool TRACK_AB>
__global__ void l1_finish(L1Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.Q * a.M) return;
  const int q = i / a.M, m = i % a.M;
  const int j = a.out_l1[q];
  const int p = a.l1_prog[j], r = a.l1_reg[j];
  const unsigned hd = (unsigned)a.l1h[m], hu = (unsigned)a.uop[m];
  const unsigned lat = (unsigned)a.mem[m];
  int* const out[NSETS] = {a.ctr, a.ctrA, a.ctrB};
#pragma unroll
  for (int s = 0; s < (TRACK_AB ? NSETS : 1); ++s) {
    const unsigned* ts = a.tsum + ((size_t)p * NSETS + s) * NTR;
    const unsigned* l = a.l1sum + ((size_t)j * NSETS + s) * NL1;
    unsigned rc[NREG] = {ts[1], 0u, 0u, 0u, ts[2], ts[3]};
    if (r >= 0) {
      const unsigned* k = a.reg_ctr + ((size_t)r * NSETS + s) * NREG;
#pragma unroll
      for (int c = 0; c < NREG; ++c) rc[c] = k[c];
    }
    const unsigned stall = hu * l[0] + lat * (l[1] + l[2]);
    const unsigned memc = hd * l[3] + lat * (l[4] + l[5]);
    const unsigned v[NCTR] = {ts[0] + stall + memc, stall, rc[0], rc[1],
                              rc[2], rc[3], l[0] - l[1] + l[3] - l[4],
                              l[1] + l[4], rc[4], rc[5], ts[4], ts[5]};
    int* o = out[s] + (size_t)i * NCTR;
#pragma unroll
    for (int c = 0; c < NCTR; ++c) o[c] = (int)v[c];
  }
}

template <int WAYS>
cudaError_t launch_walk(const L1Args& a, cudaStream_t s) {
  const long long n = (long long)a.L * a.sets;
  l1_walk<WAYS><<<(unsigned)((n + WALK_THREADS - 1) / WALK_THREADS),
                  WALK_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool TRACK_AB>
cudaError_t launch_l1(const L1Args& a, long long records, cudaStream_t s) {
  cudaError_t err;
  if ((err = cudaMemsetAsync(a.l1sum, 0,
                             sizeof(unsigned) * a.L * NSETS * NL1, s)) ||
      (err = cudaMemsetAsync(a.tsum, 0,
                             sizeof(unsigned) * a.P * NSETS * NTR, s)))
    return err;
  l1_trace_sums<TRACK_AB><<<dim3(64, (unsigned)a.NP), 256, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  const long long warps = (long long)a.L * a.tiles;
  const unsigned bucket_ctas =
      (unsigned)((warps + HIST_WARPS - 1) / HIST_WARPS);
  const int smem = HIST_WARPS * a.sets * (int)sizeof(unsigned);
  if (smem > 48 * 1024) {
    if ((err = cudaFuncSetAttribute(
             l1_bucket<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) ||
        (err = cudaFuncSetAttribute(
             l1_bucket<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)))
      return err;
  }
  l1_bucket<false><<<bucket_ctas, HIST_WARPS * 32, smem, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  const long long n = warps * a.sets;
  const int nb = (int)((n + SCAN_BLOCK - 1) / SCAN_BLOCK);
  scan_sums<<<nb, SCAN_THREADS, 0, s>>>(a.hist, n, a.blocks);
  scan_blocks<<<1, 1024, 0, s>>>(a.blocks, nb, a.hist + n);
  scan_apply<<<nb, SCAN_THREADS, 0, s>>>(a.hist, n, a.blocks);
  if ((err = cudaGetLastError())) return err;

  l1_bucket<true><<<bucket_ctas, HIST_WARPS * 32, smem, s>>>(a);
  if ((err = cudaGetLastError())) return err;

  switch (way_slots(a.ways)) {
    case 1: err = launch_walk<1>(a, s); break;
    case 2: err = launch_walk<2>(a, s); break;
    case 4: err = launch_walk<4>(a, s); break;
    case 8: err = launch_walk<8>(a, s); break;
    case 16: err = launch_walk<16>(a, s); break;
    default: err = launch_walk<32>(a, s);
  }
  if (err) return err;

  // About a few thousand records a CTA, at least one CTA a lane.
  const long long per_lane = records / a.L + 1;
  const long long ctas = (per_lane + 4095) / 4096;
  const unsigned gx = (unsigned)(ctas < 1024 ? ctas : 1024);
  l1_reduce<TRACK_AB><<<dim3(gx, (unsigned)a.L), 256, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  l1_finish<TRACK_AB><<<(a.Q * a.M + 127) / 128, 128, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The built tiles: out = {K1a warps per CTA, rows a K1a warp stages,
// int32 columns of a row, K1a dynamic shared memory in bytes, rows a
// bucketing warp takes, bucketing warps per CTA, bucketing shared memory
// in bytes, way slots of the walker, walkers per CTA} for an L1 of sets x
// ways.  Returns -1 for a geometry the kernels do not take (ways outside
// 1..32, sets < 1, or bucketing counters past the CTA's shared memory).
extern "C" int engine_scan_tile(int sets, int ways, int* out) {
  if (sets < 1 || ways < 1 || ways > 32) return -1;
  const long long hist = (long long)HIST_WARPS * sets * 4;
  if (hist > MAX_SMEM) return -1;
  out[0] = REG_WARPS;
  out[1] = CHUNK;
  out[2] = NCOL;
  out[3] = REG_WARPS * CHUNK * (NCOL * 4 + REG_SITES);
  out[4] = TILE_ROWS;
  out[5] = HIST_WARPS;
  out[6] = (int)hist;
  out[7] = way_slots(ways);
  out[8] = WALK_THREADS;
  return 0;
}

// K1a.  rows: (P, T, NCOL) int32; lengths: (P,); prog, cap, pol, anf:
// (R,) int32, capacity < 32; stream: (R, T, REG_SITES) int8; ctr: (R,
// NSETS, NREG) int32 (periods zero unless track_ab).  Returns the
// launch's cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int engine_reg_launch(const int* rows, int P, long long T,
                                 const int* lengths, const int* prog,
                                 const int* cap, const int* pol,
                                 const int* anf, int R, int track_ab,
                                 signed char* stream, int* ctr,
                                 void* cuda_stream) {
  if (P <= 0 || R <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const RegArgs a{rows, T, lengths, prog, cap, pol, anf, R, stream,
                  reinterpret_cast<unsigned*>(ctr)};
  const int bytes = REG_WARPS * CHUNK * (NCOL * 4 + REG_SITES);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const unsigned grid = (unsigned)((R + REG_WARPS - 1) / REG_WARPS);
  if (track_ab)
    engine_reg<true><<<grid, REG_WARPS * 32, bytes, s>>>(a);
  else
    engine_reg<false><<<grid, REG_WARPS * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// K1b.  rows, lengths, spill0: as K1a's, spill0 (P,); stream, reg_ctr:
// K1a's outputs for R lanes; l1_prog, l1_reg: (L,) the K1b lanes' program
// and K1a lane (-1: full VRF); out_l1: (Q,) each output's K1b lane; l1h,
// uop, mem: (M,); tprog: (NP,) the programs of l1_prog; records: the
// access slots the lanes may hold (rows x sites, summed); scratch: hist
// (L * sets * tiles + 1), blocks (one per SCAN_BLOCK hist entries), recs
// (records x 2), outcome (records bytes), l1sum (L, NSETS, NL1), tsum (P,
// NSETS, NTR); ctr, ctr_a, ctr_b: (Q, M, 12) int32 (ctr_a/ctr_b written
// only when track_ab).  Returns -1 for what the kernels do not take, else
// the launches' cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int engine_l1_launch(
    const int* rows, int P, long long T, const int* lengths,
    const int* spill0, const signed char* stream, const int* reg_ctr, int L,
    const int* l1_prog, const int* l1_reg, int Q, const int* out_l1, int M,
    const int* l1h, const int* uop, const int* mem, int sets, int ways,
    int track_ab, int NP, const int* tprog, long long records, int* hist,
    int* blocks, int* recs, unsigned char* outcome, int* l1sum, int* tsum,
    int* ctr, int* ctr_a, int* ctr_b, void* cuda_stream) {
  int tile[9];
  if (engine_scan_tile(sets, ways, tile) || T >= MAX_ROWS ||
      records >= (1LL << 31))
    return -1;
  if (P <= 0 || L <= 0 || Q <= 0 || M <= 0 || NP <= 0 || T < 0 ||
      L > 65535 || NP > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(T > 0 ? (T + TILE_ROWS - 1) / TILE_ROWS : 1);
  const L1Args a{rows, T, P, lengths, spill0, stream,
                 reinterpret_cast<const unsigned*>(reg_ctr), L, l1_prog,
                 l1_reg, Q, out_l1, M, l1h, uop, mem, sets, ways, tiles, NP,
                 tprog, reinterpret_cast<unsigned*>(hist),
                 reinterpret_cast<unsigned*>(blocks),
                 reinterpret_cast<int2*>(recs), outcome,
                 reinterpret_cast<unsigned*>(l1sum),
                 reinterpret_cast<unsigned*>(tsum), ctr, ctr_a, ctr_b};
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  return (int)(track_ab ? launch_l1<true>(a, records, s)
                        : launch_l1<false>(a, records, s));
}
