// The engine scan (K1) for Hopper (sm_90a), plain C interface.
//
// Replaces the reference's cycle engine, src/repro/core/simulator.py
// `_run_grid` (:386): one `lax.scan` of `_make_step`/`_make_body` (:234,
// :344) under three `vmap`s, with `_l1_access` (:190) and the policies of
// src/repro/core/policies.py (`lookup`, `free_slot`, `select_victim`,
// `apply_access`).  XLA compiles it; there is no `pallas_call`.
//
// What it computes.  Each lane of the (program, config, machine) grid walks
// its program's T instruction rows in order.  A row holds up to three REG
// accesses (vs1, vs2, vd), tag-checked serially against a fully
// associative cVRF of `capacity` slots; a miss picks a victim by
// FIFO/LRU/LFU/OPT among occupied slots whose tag is not locked (vs1 for
// vs2; vs1 and vs2 for vd), spills it through the L1 if dirty and fills
// the missing register.  Then up to two MEM accesses go through the same
// set-associative, LRU, write-back L1.  Each row adds its 12 counters
// (simulator.COUNTER_NAMES) times the fold weight `wt`, and times `wa`/`wb`
// into the measured periods A and B when the trace is folded.  The output
// is (P, C, M, 12) int32, three times.
//
// What bounds it on the card: neither bytes nor operations.  A lane is one
// serial chain of dependent steps (each row's cache state is the next
// row's input), so a lane's time is rows x the latency of one row's
// dependent chain of warp votes and shared-memory round trips.  The bytes
// bound (each input row read once) is far below that; the card's
// parallelism only spreads lanes, never rows.
//
// Design.  One warp per lane: thread i holds cVRF slot i's seven metadata
// fields (policies.py's columns) in registers, so the 32 slots of the
// architectural register file are the warp's 32 threads.  `lookup` and
// `free_slot` are ballots (first set bit = argmax's first index);
// `select_victim` is a warp min-reduction of the metric followed by a
// ballot of the slots that hold it (first set bit = argmin's first
// index).  The lane's L1 (sets x ways line tags and `now << 1 | dirty`
// words) lives in shared memory; thread w < ways reads way w, and the
// way is a ballot on a hit and the first least word on a miss (free ways
// hold word 0).  A CTA holds WARPS lanes of one program; each warp stages
// CHUNK rows of its program in shared memory, loading the next chunk into
// registers while it walks the current one, and reads each row's columns
// into registers once.  Every decision is warp-
// uniform except the owner slot's register updates.  Counters are summed
// in uint32, so an overflow wraps as the reference's int32 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NUM_ARCH_VREGS = 32;  // cVRF slots = the warp's threads
constexpr int NOW_STEP = 6;         // events.NUM_SLOTS: `now` per row
constexpr int NCOL = 24;            // int32 columns of a packed row
constexpr int CHUNK = 32;           // rows a warp stages at a time
constexpr int WARPS = 4;            // lanes (warps) in a CTA
constexpr int NCTR = 12;            // simulator.COUNTER_NAMES
constexpr int PER_THREAD = CHUNK * NCOL / 32;
constexpr int INT_MAX_ = 0x7fffffff;
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a CTA may use

// Column offsets of a packed row (kernels/engine_scan.py COLUMNS).
enum {
  RV = 0, REG = 3, VDW = 6, VDR = 7, VDNF = 8, LK1 = 9, LK2 = 10, MV = 11,
  ML = 13, MW = 15, COST = 17, NXT = 18, WT = 21, WA = 22, WB = 23
};
enum { FIFO = 0, LRU = 1, LFU = 2, OPT = 3 };
constexpr int LFU_FREQ_CAP = 511;
constexpr int LFU_SEQ_BITS = 21;

struct Args {
  const int* rows;      // (P, T, NCOL) int32
  long long T;
  const int* lengths;   // (P,) rows to walk; the rest is padding
  const int* spill0;    // (P,) first spill cacheline
  const int* cap;       // (C,) capacity, policy, alloc_no_fetch
  const int* pol;
  const int* anf;
  int C;
  const int* l1h;       // (M,) L1 hit, uop hit, memory latency
  const int* uop;
  const int* mem;
  int M;
  int sets, ways;
  int* ctr;             // (P, C, M, NCTR) int32: total, period A, B
  int* ctrA;
  int* ctrB;
};

struct L1 {
  int* tag;    // (sets, ways) line tags, -1 free
  int* word;   // (sets, ways) now << 1 | dirty
  int sets, ways;
};

// One cacheline access: LRU within the set, write-allocate, write-back.
// Returns the access's cycles and sets `hit`; every thread of the warp
// calls it with the same arguments.
__device__ __forceinline__ unsigned l1_access(const L1& l1, int line,
                                              int is_write, int now,
                                              int hit_cost, int mem_lat,
                                              int lane, bool& hit) {
  int set = line % l1.sets;
  if (set < 0) set += l1.sets;       // floor modulo, as Python's %
  const int base = set * l1.ways;
  const bool mine = lane < l1.ways;
  int t = 0, w = INT_MAX_;
  if (mine) {
    t = l1.tag[base + lane];
    w = l1.word[base + lane];
  }
  const unsigned eq = __ballot_sync(FULL, mine && t == line);
  hit = eq != 0u;
  int way;
  if (hit) {
    way = __ffs(eq) - 1;
  } else {
    const int least = __reduce_min_sync(FULL, w);
    way = __ffs(__ballot_sync(FULL, mine && w == least)) - 1;
  }
  const int old_tag = __shfl_sync(FULL, t, way);
  const int old_dirty = __shfl_sync(FULL, w, way) & 1;
  const bool writeback = !hit && old_tag >= 0 && old_dirty == 1;
  if (lane == way) {
    l1.tag[base + way] = line;
    l1.word[base + way] = (int)(((unsigned)now << 1) |
                                (unsigned)(hit ? old_dirty | is_write
                                               : is_write));
  }
  __syncwarp();
  const unsigned c = (unsigned)hit_cost;
  const unsigned m = (unsigned)mem_lat;
  return hit ? c : c + m + (writeback ? m : 0u);
}

// A register's reserved spill line, spill0 + max(tag, 0), wrapping as the
// reference's int32 sum does.
__device__ __forceinline__ int reserved_line(int spill0, int tag) {
  return (int)((unsigned)spill0 + (unsigned)max(tag, 0));
}

template <bool TRACK_AB>
__global__ void __launch_bounds__(WARPS * 32) engine_scan(Args a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.y;
  const int q = blockIdx.x * WARPS + warp;   // the (config, machine) lane
  if (q >= a.C * a.M) return;                // whole warps only
  const int c = q / a.M, m = q % a.M;

  const int l1_ints = a.sets * a.ways;
  int* stage = smem + warp * (CHUNK * NCOL + 2 * l1_ints);
  const L1 l1{stage + CHUNK * NCOL, stage + CHUNK * NCOL + l1_ints, a.sets,
              a.ways};
  for (int i = lane; i < l1_ints; i += 32) {
    l1.tag[i] = -1;
    l1.word[i] = 0;
  }

  const int capacity = a.cap[c], policy = a.pol[c], anf = a.anf[c] != 0;
  const int hit_d = a.l1h[m], hit_u = a.uop[m], lat = a.mem[m];
  const int spill0 = a.spill0[p];
  const bool full = capacity >= NUM_ARCH_VREGS;
  const bool valid = lane < capacity;
  // Slot `lane` of the cVRF (policies.py's columns).
  int tag = -1, dirty = 0, ins_seq = 0, last_use = 0, freq = 0;
  int next_use = 0;                  // (the engine never pins a slot)
  unsigned seq = 0, now0 = 0;
  unsigned ctr[NCTR] = {}, ctr_a[NCTR] = {}, ctr_b[NCTR] = {};

  const int* src = a.rows + (size_t)p * (size_t)a.T * NCOL;
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
      // The row's columns, read at once into registers: read through the
      // stage pointer, each would be re-read after every L1 store (the
      // compiler cannot tell the two shared arrays apart).
      int r[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) r[i] = stage[k * NCOL + i];
      unsigned stall = 0, memc = 0, hits = 0, misses = 0, spills = 0;
      unsigned fills = 0, l1_hits = 0, l1_misses = 0, rr = 0, rw = 0;
      unsigned mr = 0, mw = 0;

      // REG lanes in the hardware's serial tag-check order.
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (!r[RV + s]) continue;
        const int wr = s == 2 ? r[VDW] != 0 : 0;
        const int rd = s == 2 ? r[VDR] != 0 : 1;
        rr += rd;
        rw += wr;
        if (full) {          // every access hits; the cache never changes
          ++hits;
          continue;
        }
        const int reg = r[REG + s];
        const int nxt = r[NXT + s];
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
        const int lock_a = s >= 1 ? r[LK1] : -1;
        const int lock_b = s == 2 ? r[LK2] : -1;
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
        bool h;
        if (!fm && vdirty == 1) {        // spill the evictee to its line
          ++spills;
          stall += l1_access(l1, reserved_line(spill0, vtag), 1, now, hit_u,
                             lat, lane, h);
          h ? ++l1_hits : ++l1_misses;
        }
        if (rd || !(s == 2 && r[VDNF] && anf)) {   // fill the register
          ++fills;
          stall += l1_access(l1, reserved_line(spill0, reg), 0, now, hit_u,
                             lat, lane, h);
          h ? ++l1_hits : ++l1_misses;
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

      // MEM lanes: the instruction's own data accesses.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!r[MV + j]) continue;
        const int w = r[MW + j] != 0;
        bool h;
        memc += l1_access(l1, r[ML + j], w, (int)(now0 + 3 + j), hit_d, lat,
                          lane, h);
        h ? ++l1_hits : ++l1_misses;
        w ? ++mw : ++mr;
      }

      const unsigned inc[NCTR] = {(unsigned)r[COST] + stall + memc,
                                  stall, hits, misses, spills, fills,
                                  l1_hits, l1_misses, rr, rw, mr, mw};
      const unsigned wt = (unsigned)r[WT];
#pragma unroll
      for (int i = 0; i < NCTR; ++i) ctr[i] += inc[i] * wt;
      if (TRACK_AB) {
        const unsigned wa = (unsigned)r[WA], wb = (unsigned)r[WB];
#pragma unroll
        for (int i = 0; i < NCTR; ++i) {
          ctr_a[i] += inc[i] * wa;
          ctr_b[i] += inc[i] * wb;
        }
      }
    }
  }

  if (lane == 0) {
    const size_t o = (((size_t)p * a.C + c) * a.M + m) * NCTR;
#pragma unroll
    for (int i = 0; i < NCTR; ++i) {
      a.ctr[o + i] = (int)ctr[i];
      if (TRACK_AB) {
        a.ctrA[o + i] = (int)ctr_a[i];
        a.ctrB[o + i] = (int)ctr_b[i];
      }
    }
  }
}

}  // namespace

// The built tile: out = {warps per CTA, rows staged per warp, int32
// columns of a row, dynamic shared memory in bytes} for an L1 of sets x
// ways.  Returns -1 for a geometry the kernel does not take (ways outside
// 1..32, sets < 1, or shared memory past the CTA's limit).
extern "C" int engine_scan_tile(int sets, int ways, int* out) {
  if (sets < 1 || ways < 1 || ways > 32) return -1;
  const long long bytes =
      (long long)WARPS * (CHUNK * NCOL + 2LL * sets * ways) * 4;
  if (bytes > MAX_SMEM) return -1;
  out[0] = WARPS;
  out[1] = CHUNK;
  out[2] = NCOL;
  out[3] = (int)bytes;
  return 0;
}

// rows: (P, T, NCOL) int32, row-major; lengths, spill0: (P,) int32;
// cap, pol, anf: (C,) int32; l1h, uop, mem: (M,) int32; ctr, ctr_a,
// ctr_b: (P, C, M, 12) int32 (ctr_a/ctr_b written only when track_ab).
// Returns -1 for an L1 geometry the kernel does not take, else the
// launch's cudaError_t (0 on success); runs on `stream` and does not
// synchronise.
extern "C" int engine_scan_launch(const int* rows, int P, long long T,
                                  const int* lengths, const int* spill0,
                                  const int* cap, const int* pol,
                                  const int* anf, int C, const int* l1h,
                                  const int* uop, const int* mem, int M,
                                  int sets, int ways, int track_ab, int* ctr,
                                  int* ctr_a, int* ctr_b, void* stream) {
  int tile[4];
  if (engine_scan_tile(sets, ways, tile)) return -1;
  if (P <= 0 || C <= 0 || M <= 0 || T < 0 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{rows, T, lengths, spill0, cap, pol, anf, C, l1h, uop, mem, M,
               sets, ways, ctr, ctr_a, ctr_b};
  const int bytes = tile[3];
  const dim3 grid((unsigned)((C * M + WARPS - 1) / WARPS), (unsigned)P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = track_ab ? engine_scan<true> : engine_scan<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, WARPS * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}
