// An event-free segment of the time-blocked engine in one launch: the
// segment's precompute, the TLB and page-walk-cache chain through its
// rows, the cost terms and accumulators, the hotness counts and the
// integer counters, one CTA of four warps per (run, simulated thread).
//
// No Pallas original: replaces the JAX package's
// src/repro/core/sim.py::_build_fast_window, its tile precompute
// (sim.py:980-1013), its inner lax.scan `row` (sim.py:1015-1062) and its
// hotness scatter-adds (sim.py:1076-1082).  What stays outside is the
// per-row f32 sums over threads (the timeline's cycle columns), taken by
// the caller in the same reduction as the per-step engine's.  Per run l,
// thread t and row r (step now = now0 + r), as the reference:
//   m = clamp(va >= 0 ? va >> map_shift : 0, 0, n_map - 1)
//   active = va >= 0 && !oom_killed
//   leaf / mid / top LLC hit, data LLC hit = bern draws of sites 1-4 on
//     (m, m >> 2rb, m >> 3rb, m; now; t) against the row's thresholds
//   leaf_read = leaf_llc ? llc_hit : read[leaf_node[m >> rb] + 1], and
//     the mid and top reads on a miss the same way; data_cost = active ?
//     (data_llc ? llc_hit : (write ? write : read)[data_node[m] + 1]) : 0
//   hit1 = L1 dTLB(m), hit2 = STLB(m), pde_hit = PDE(m >> rb),
//     pdpte_hit = PDPTE(m >> 2rb); walkn = active & !hit1 & !hit2
//   touch-or-insert m in L1 (active), in STLB (active & !hit1), the PDE
//     and PDPTE tags (walkn), each stamped now
//   walk_cost, walk_reads, tlb_penalty, stall, total as the reference;
//   ct += total, cwk += walk_cost, cst += stall, cdm += data_cost
//   access_recent[m] += active, written_recent[m] += active & write
//   counts: l1 hits (active & hit1), stlb hits (active & !hit1 & hit2),
//     walks (walkn), walk reads
// A lookup hits at the lowest matching way; a miss picks the lowest way
// of least lru (an empty way carries -1), as the reference's
// argmax/argmin.  Stamps must keep (now0 + R + 3) * ways below 2^32 (the
// wrapper checks).  Each run l has its own latency tables (lat[l]) and
// costs (costs[l]: llc_hit, stlb_hit, cpu_work, data_stall_frac).  The
// trace rows (va, is_write, thr) are read through a lane and a row stride,
// so a window of a step-major table needs no copy.  Outputs: cum [L, R, 4, T], the four accumulators
// after each row; in place: the caches, the accumulators, the counters
// (the segment's totals added), the hotness counts, and three [L, R]
// row-count views (each row's l1 hits, stlb hits and walks since the
// launch, summed over threads, added; atomics, integers, so exact).
//
// Exactness: every f32 operation is a separate round-to-nearest intrinsic
// in the reference's order (no FMA contraction), the accumulators are
// summed row after row, and the draws are the reference's uint32
// wrap-around hash, so the kernel equals the per-step engine bit for bit.
//
// Bound: launch latency and the caches' serial chain.  A quickstart
// segment (64 rows, T = 32, benchmark_machine()) must move about 0.18 MB
// (the trace rows, the gathered placements, the cache sets its rows probe
// and the entries they change, the accumulators, the outputs), 0.05 us at
// 3.35 TB/s, far below one launch; a
// row of a chain is a few dependent latencies (a shared load, the key, a
// warp minimum, a store) that one warp per scheduler cannot hide.
//
// Design.  Only the caches are truly serial; everything else of a row
// hangs off its four hit bits.  So a CTA of 128 threads works through the
// rows in chunks of 128 (one fixed size: any R, in one pass on the main
// path's 64-row segments):
//   prologue, one row per thread: the granule, flags and latency terms
//     into shared memory, the hotness atomics; meanwhile cp.async stages
//     the thread's four caches (13,120 B at benchmark_machine()) into
//     shared memory, once per launch;
//   chain, one warp per cache: warp 0 the L1 dTLB, warp 1 the STLB, warps
//     2 and 3 the PDE and PDPTE caches.  A row is one probe: the set's
//     ways one per lane, one warp minimum of a key per way (the way itself
//     where its tag matches, else ways * (lru + 2) + way, so the least key
//     is the lowest matching way or the lowest way of least lru), one
//     owner write, one __syncwarp; the next row's set is computed beside
//     it.  Warp 0 depends on nothing, warp 1 on hit1 (it updates on active
//     & !hit1), warps 2 and 3 on walkn, which warp 1 records; a producer
//     publishes its progress every kGroup rows (a release store to a
//     shared flag), and a consumer probes ahead and waits (an acquire
//     load) only when it needs a bit it has not seen, so the four chains
//     overlap.  A cache of more than 32 ways gives a lane the ways lane,
//     lane + 32, ..., whose least key it takes before the warp's minimum
//     (keys are distinct, so one lane owns the least); that fold is
//     compiled into a second instance, launched only for such caches.  Each row records
//     its hit bits and the entry it wrote;
//   epilogue, one row per thread: the entries the chunk wrote go back to
//     global memory, the cost terms come from the four hit bits, the
//     counts by a block scan (four 16-bit fields of a 64-bit word), then
//     the row-count atomics; four lanes take the f32 accumulators row
//     after row, as exactness needs.
// The set index is tag - (tag * magic >> shift) * sets with the host's
// magic number (ref.set_magic): exact for every tag in [0, 2^31) and
// every set count, without a division.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                  // one per cache structure
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = kThreads;           // rows per chunk: one a thread
// Rows per hand-off between the chain's warps: a flag costs a release
// store on the producer and an acquire round trip on the consumer, so a
// group of 8 keeps both below a few cycles a row, while the pipeline's
// fill (two groups: L1, then STLB, before the walk caches start) stays a
// quarter of a 64-row segment.
constexpr int kGroup = 8;
constexpr unsigned kFull = 0xffffffffu;
// The four caches of a thread, staged whole in dynamic shared memory (tag
// and stamp, each array padded to 4 ints): at most 216 KiB, 27,648
// entries, which with the static Shared below stays under the 227 KiB a
// Hopper CTA may take.  ops.fast_window checks it first.
constexpr size_t kMaxStagedBytes = 216 * 1024;

__host__ __device__ constexpr uint32_t site_seed(uint32_t site) {
  return 0x811C9DC5u + 0x1000193u * site;
}
constexpr uint32_t kMix0 = 0x9E3779B1u, kMix1 = 0x85EBCA77u,
                   kMix2 = 0xC2B2AE3Du;

struct Params {
  const int32_t* va;           // [L, R, T] (strides va_sl, va_sr, 1)
  const uint8_t* is_write;     // [L, R, T], va's strides
  const int64_t* thr;          // [L, R, 4] (strides thr_sl, thr_sr, 1)
  const uint8_t* oom;          // [L]
  const int32_t* node[4];      // data, leaf, mid, top: [L, n]
  const float* lat[2];         // read, write: [L, K]
  const float* costs;          // [L, 4]
  int32_t* tags[4];            // L1, STLB, PDE, PDPTE: [L, T, sets, ways]
  int32_t* lru[4];
  float* acc[4];               // total, walk, stall, data: [L, T]
  int32_t* counters[4];        // l1 hits, stlb hits, walks, reads: [L]
  int32_t* hot[2];             // access, written: [L, n_map]
  int32_t* rc[3];              // l1 hits, stlb hits, walks: [L, R] views
  float* cum;                  // [L, R, 4, T]
  int L, R, T, now0, map_shift, rb, thp;
  int n_node[4];
  int K;
  int sets[4], ways[4];
  unsigned magic[4];
  int shift[4];
  long long rc_sl, rc_sr;      // the row counts' strides
  long long va_sl, va_sr, thr_sl, thr_sr;
};

// Run l's costs, read once per CTA.
struct Costs {
  float llc_hit, stlb_hit, cpu_work, frac;
};

// ---- staging the caches ---------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// dst is 16-byte aligned (the shared layout pads every array to 4 ints)
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src, int n,
                                      int tid) {
  if (n % 4 == 0 && (uintptr_t)src % 16 == 0) {
    for (int i = tid; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
  }
}

// ---- the prologue -------------------------------------------------------

// bern's 24-bit multiplicative hash of (key, now, t) at one site
__device__ __forceinline__ uint32_t hash24(uint32_t seed, int key,
                                           uint32_t now, int t) {
  uint32_t h = (seed ^ (uint32_t)key) * kMix0;
  h = (h ^ now) * kMix1;
  h = (h ^ (uint32_t)t) * kMix2;
  return h >> 8;
}

__device__ __forceinline__ float node_lat(const float* table, int K,
                                          int node) {
  return __ldg(table + min(max(node + 1, 0), K - 1));
}

__device__ __forceinline__ int node_of(const Params& p, int which, int l,
                                       int page) {
  const int n = p.n_node[which];
  return __ldg(p.node[which] + (size_t)l * n + min(page, n - 1));
}

struct RowIn {
  int m;
  int flags;      // bit 0 active, 1 leaf LLC hit, 2 mid LLC hit, 3 top LLC hit
  float4 x;       // leaf read, mid and top read on a miss, data cost
};

__device__ __forceinline__ RowIn row_inputs(const Params& p, const Costs& cs,
                                            int l, int t, int r) {
  const size_t idx = (size_t)l * p.va_sl + (size_t)r * p.va_sr + t;
  const int va = __ldg(p.va + idx);
  const bool write = __ldg(p.is_write + idx);
  const int n_map = p.n_node[0];
  const int m = min(max(va >= 0 ? va >> p.map_shift : 0, 0), n_map - 1);
  const bool act = va >= 0 && !__ldg(p.oom + l);
  const int leaf = m >> p.rb, mid = m >> (2 * p.rb), top = m >> (3 * p.rb);
  const int data_n = node_of(p, 0, l, m), leaf_n = node_of(p, 1, l, leaf),
            mid_n = node_of(p, 2, l, mid), top_n = node_of(p, 3, l, top);
  const uint32_t now = (uint32_t)(p.now0 + r);
  const int64_t* thr = p.thr + (size_t)l * p.thr_sl + (size_t)r * p.thr_sr;
  const bool leaf_llc = (int64_t)hash24(site_seed(1), m, now, t) < __ldg(thr);
  const bool up1 = (int64_t)hash24(site_seed(2), mid, now, t) < __ldg(thr + 1);
  const bool up2 = (int64_t)hash24(site_seed(3), top, now, t) < __ldg(thr + 2);
  const bool data_llc =
      (int64_t)hash24(site_seed(4), m, now, t) < __ldg(thr + 3);
  const float* rd = p.lat[0] + (size_t)l * p.K;
  const float* wr = p.lat[1] + (size_t)l * p.K;
  const float mem = write ? node_lat(wr, p.K, data_n)
                          : node_lat(rd, p.K, data_n);
  RowIn in;
  in.m = m;
  in.flags = (int)act | (int)leaf_llc << 1 | (int)up1 << 2 | (int)up2 << 3;
  in.x = make_float4(leaf_llc ? cs.llc_hit : node_lat(rd, p.K, leaf_n),
                     up1 ? cs.llc_hit : node_lat(rd, p.K, mid_n),
                     up2 ? cs.llc_hit : node_lat(rd, p.K, top_n),
                     act ? (data_llc ? cs.llc_hit : mem) : 0.f);
  if (act) {
    const size_t h = (size_t)l * n_map + m;
    atomicAdd(p.hot[0] + h, 1);
    if (write) atomicAdd(p.hot[1] + h, 1);
  }
  return in;
}

// ---- the chain ------------------------------------------------------------

struct Shared {
  int32_t m[kChunk];
  float4 x[kChunk];
  float sum[3][kChunk];             // total, walk cost, stall
  unsigned long long warp_sum[kWarps];
  // warp w's record of row r: bit 0 hit, bit 1 walkn (warp 1), and
  // (entry + 1) << 2 where the row wrote its cache (else 0)
  int32_t rec[kWarps][kChunk];
  uint8_t flags[kChunk];
  int carry[4];                     // counts of the chunks before
  int progress[2];                  // rows published by warps 0 and 1
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A producer's progress: a release store, so the rows' hit bits written
// before it are seen by a consumer that acquires it.
__device__ __forceinline__ void publish(int* flag, int rows) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(shared_addr(flag)),
               "r"(rows)
               : "memory");
}

// Wait until the producer has published `need` rows; returns how many it
// had (each lane acquired at least that many).
__device__ __forceinline__ int wait_rows(const int* flag, int need) {
  int v;
  do {
    int mine;
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
                 : "=r"(mine)
                 : "r"(shared_addr(flag))
                 : "memory");
    v = __reduce_min_sync(kFull, mine);
  } while (v < need);
  return v;
}

__device__ __forceinline__ int padded(int n) { return (n + 3) & ~3; }

// Cache c's tags and lru in shared memory, each padded to 4 ints, in the
// order of the caches (computed, not stored, so that the compiler keeps
// the shared address space).
__device__ __forceinline__ int32_t* shared_tags(int32_t* smem,
                                                const Params& p, int c) {
  int off = 0;
  for (int k = 0; k < c; ++k) off += 2 * padded(p.sets[k] * p.ways[k]);
  return smem + off;
}

// One way's key: the way itself on a match, else ways * (lru + 2) + way
// (both loads unconditional; a match keys below every lru key).
__device__ __forceinline__ unsigned way_key(const int32_t* tags,
                                            const int32_t* lru, int e, int w,
                                            int ways, int tag) {
  return min(tags[e] == tag ? (unsigned)w : UINT_MAX,
             (unsigned)ways * (unsigned)(lru[e] + 2) + w);
}

// The first entry of `tag`'s set, without a division (ref.set_magic).
template <bool kSets>
__device__ __forceinline__ int set_base(int tag, int sets, int ways,
                                        unsigned magic, int shift) {
  if (!kSets) return 0;
  const unsigned q =
      (unsigned)(((unsigned long long)(unsigned)tag * magic) >> shift);
  return (tag - (int)q * sets) * ways;
}

// Warp C runs cache C (0 L1 dTLB, 1 STLB, 2 PDE, 3 PDPTE) through the
// chunk's n rows (see Design), one way a lane.  The kWide instance, which
// the launcher picks only when a cache has more than 32 ways, also folds
// the ways lane + 32, lane + 64, ... into the lane's key; the loop, even
// when it runs no time, costs the latency-bound chain about 13%, so the
// other instance leaves it out.  The chain of
// a row is the set's loads, the key, the warp minimum and the owner's
// store; the next row's tag and set are computed beside it, and a
// consumer reads its producer's bits only for the store (waiting only
// when it has caught up).  Each row leaves its record for the epilogue,
// which writes the touched entries back.
template <int C, bool kWide>
__device__ __forceinline__ void chain(const Params& p, Shared& s,
                                      int32_t* smem, int lane, int n,
                                      int now0) {
  int32_t* tags = shared_tags(smem, p, C);
  int32_t* lru = tags + padded(p.sets[C] * p.ways[C]);
  constexpr bool kSets = C < 2;            // the walk caches have one set
  const int ways = p.ways[C];
  const int sets = kSets ? p.sets[C] : 1;
  const unsigned magic = p.magic[C];
  const int shift = p.shift[C];
  const int tag_shift = C < 2 ? 0 : (C - 1) * p.rb;
  int seen = 0;
  int tag = s.m[0] >> tag_shift;
  int base = set_base<kSets>(tag, sets, ways, magic, shift);
  for (int r = 0; r < n; ++r) {
    unsigned key = UINT_MAX;
    int slot = base + lane;
    if (lane < ways) key = way_key(tags, lru, slot, lane, ways, tag);
    if (kWide) {
      for (int w = lane + kWarp; w < ways; w += kWarp) {
        const unsigned kw = way_key(tags, lru, base + w, w, ways, tag);
        if (kw < key) {
          key = kw;
          slot = base + w;
        }
      }
    }
    const int tag_next = s.m[min(r + 1, n - 1)] >> tag_shift;
    const int base_next = set_base<kSets>(tag_next, sets, ways, magic, shift);
    bool on;
    if (C == 0) {
      on = s.flags[r] & 1;
    } else {
      if (r >= seen) seen = wait_rows(&s.progress[C == 1 ? 0 : 1], r + 1);
      on = C == 1 ? (s.flags[r] & 1) && !(s.rec[0][r] & 1)
                  : (s.rec[1][r] >> 1) & 1;
    }
    const unsigned least = __reduce_min_sync(kFull, key);
    const bool hit = least < (unsigned)ways;
    const bool mine = key == least;
    if (on && mine) {
      tags[slot] = tag;
      lru[slot] = now0 + r;
    }
    if (on ? mine : lane == 0)
      s.rec[C][r] = (int)hit | (int)(C == 1 && on && !hit) << 1 |
                    (on ? (slot + 1) << 2 : 0);
    __syncwarp();
    if (C < 2 && lane == 0 && ((r + 1) % kGroup == 0 || r + 1 == n))
      publish(&s.progress[C], r + 1);
    tag = tag_next;
    base = base_next;
  }
}

// ---- the kernel -----------------------------------------------------------

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    fast_window_kernel(const Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ Shared s;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int run = blockIdx.x, l = run / p.T, t = run % p.T;

  for (int c = 0; c < 4; ++c) {
    const int n = p.sets[c] * p.ways[c];
    int32_t* tags = shared_tags(smem, p, c);
    stage(tags, p.tags[c] + (size_t)run * n, n, tid);
    stage(tags + padded(n), p.lru[c] + (size_t)run * n, n, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (tid < 4) s.carry[tid] = 0;
  float acc = tid < 4 ? p.acc[tid][run] : 0.f;   // lane k of warp 0: acc k
  const float* cl = p.costs + (size_t)l * 4;
  const Costs cs = {__ldg(cl), __ldg(cl + 1), __ldg(cl + 2), __ldg(cl + 3)};

  for (int r0 = 0; r0 < p.R; r0 += kChunk) {
    const int n = min(kChunk, p.R - r0);
    if (tid < n) {
      const RowIn in = row_inputs(p, cs, l, t, r0 + tid);
      s.m[tid] = in.m;
      s.flags[tid] = (uint8_t)in.flags;
      s.x[tid] = in.x;
    }
    if (tid < 2) s.progress[tid] = 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    switch (warp) {
      case 0: chain<0, kWide>(p, s, smem, lane, n, p.now0 + r0); break;
      case 1: chain<1, kWide>(p, s, smem, lane, n, p.now0 + r0); break;
      case 2: chain<2, kWide>(p, s, smem, lane, n, p.now0 + r0); break;
      default: chain<3, kWide>(p, s, smem, lane, n, p.now0 + r0); break;
    }
    __syncthreads();

    // epilogue: one row a thread
    unsigned long long inc = 0;
    if (tid < n) {
      const int f = s.flags[tid];
      const bool act = f & 1, leaf_llc = f & 2, up1 = f & 4, up2 = f & 8;
      const bool hit1 = s.rec[0][tid] & 1, hit2 = s.rec[1][tid] & 1,
                 walkn = s.rec[1][tid] & 2, pde_hit = s.rec[2][tid] & 1,
                 pdpte_hit = s.rec[3][tid] & 1;
      for (int c = 0; c < 4; ++c) {   // write back the entries it touched
        const int e = (s.rec[c][tid] >> 2) - 1;
        if (e >= 0) {
          const int32_t* tags = shared_tags(smem, p, c);
          const size_t g = (size_t)run * p.sets[c] * p.ways[c] + e;
          p.tags[c][g] = tags[e];
          p.lru[c][g] = tags[padded(p.sets[c] * p.ways[c]) + e];
        }
      }
      const float4 x = s.x[tid];
      const bool full = !pde_hit && !pdpte_hit;
      const float mid_read = pde_hit ? 0.f : x.y;
      const float top_read = (!p.thp && full) ? x.z : 0.f;
      const float root_read = full ? cs.llc_hit : 0.f;
      const float walk_cost =
          walkn ? __fadd_rn(__fadd_rn(__fadd_rn(x.x, mid_read), top_read),
                            root_read)
                : 0.f;
      const int reads = walkn ? (int)!leaf_llc + (int)(!pde_hit && !up1) +
                                    (int)(!p.thp && full && !up2)
                              : 0;
      const float tlb_penalty = (act && !hit1) ? cs.stlb_hit : 0.f;
      const float stall = __fadd_rn(walk_cost, __fmul_rn(cs.frac, x.w));
      s.sum[0][tid] =
          __fadd_rn(__fadd_rn(act ? cs.cpu_work : 0.f, tlb_penalty), stall);
      s.sum[1][tid] = walk_cost;
      s.sum[2][tid] = stall;
      inc = (unsigned long long)(act && hit1) |
            (unsigned long long)(act && !hit1 && hit2) << 16 |
            (unsigned long long)walkn << 32 |
            (unsigned long long)reads << 48;
    }
    // inclusive scan of the chunk's counts (each field below 2^16)
    for (int o = 1; o < kWarp; o <<= 1) {
      const unsigned long long u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == kWarp - 1) s.warp_sum[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) inc += s.warp_sum[w];
    int cnt[4];
    for (int k = 0; k < 4; ++k)
      cnt[k] = s.carry[k] + (int)((inc >> (16 * k)) & 0xffff);
    if (tid < n) {
      const size_t o = (size_t)l * p.rc_sl + (size_t)(r0 + tid) * p.rc_sr;
      for (int k = 0; k < 3; ++k)
        if (cnt[k]) atomicAdd(p.rc[k] + o, cnt[k]);
    }
    if (tid < 4) {                  // the accumulators, row after row
      const float* x = tid < 3 ? s.sum[tid] : nullptr;
      float* out = p.cum + ((size_t)l * p.R + r0) * 4 * p.T + tid * p.T + t;
      for (int r = 0; r < n; ++r) {
        acc = __fadd_rn(acc, tid < 3 ? x[r] : s.x[r].w);
        out[(size_t)r * 4 * p.T] = acc;
      }
    }
    __syncthreads();
    if (tid == n - 1)
      for (int k = 0; k < 4; ++k) s.carry[k] = cnt[k];
  }
  __syncthreads();
  if (tid < 4) {                    // the caches were written through
    p.acc[tid][run] = acc;
    if (s.carry[tid]) atomicAdd(p.counters[tid] + l, s.carry[tid]);
  }
}

}  // namespace

// ptrs: va, is_write, thr, oom_killed, data / leaf / mid / top nodes, read
// and write latencies, costs, the four caches' tags then their lru, the
// four accumulators, the four counters, access and written counts, the
// three row counts, cum (33).  ints: L, R, T, now0, map_shift, radix_bits,
// thp, the four placements' lengths, K, the caches' sets, ways, magic
// numbers and shifts, the row counts' two strides, va's and thr's lane and
// row strides (34).
extern "C" int fast_window_launch(const uint64_t* ptrs, const long long* ints,
                                  void* stream) {
  Params p;
  int i = 0;
  p.va = (const int32_t*)ptrs[i++];
  p.is_write = (const uint8_t*)ptrs[i++];
  p.thr = (const int64_t*)ptrs[i++];
  p.oom = (const uint8_t*)ptrs[i++];
  for (int k = 0; k < 4; ++k) p.node[k] = (const int32_t*)ptrs[i++];
  for (int k = 0; k < 2; ++k) p.lat[k] = (const float*)ptrs[i++];
  p.costs = (const float*)ptrs[i++];
  for (int k = 0; k < 4; ++k) p.tags[k] = (int32_t*)ptrs[i++];
  for (int k = 0; k < 4; ++k) p.lru[k] = (int32_t*)ptrs[i++];
  for (int k = 0; k < 4; ++k) p.acc[k] = (float*)ptrs[i++];
  for (int k = 0; k < 4; ++k) p.counters[k] = (int32_t*)ptrs[i++];
  for (int k = 0; k < 2; ++k) p.hot[k] = (int32_t*)ptrs[i++];
  for (int k = 0; k < 3; ++k) p.rc[k] = (int32_t*)ptrs[i++];
  p.cum = (float*)ptrs[i++];
  int j = 0;
  p.L = (int)ints[j++];
  p.R = (int)ints[j++];
  p.T = (int)ints[j++];
  p.now0 = (int)ints[j++];
  p.map_shift = (int)ints[j++];
  p.rb = (int)ints[j++];
  p.thp = (int)ints[j++];
  for (int k = 0; k < 4; ++k) p.n_node[k] = (int)ints[j++];
  p.K = (int)ints[j++];
  for (int k = 0; k < 4; ++k) p.sets[k] = (int)ints[j++];
  for (int k = 0; k < 4; ++k) p.ways[k] = (int)ints[j++];
  for (int k = 0; k < 4; ++k) p.magic[k] = (unsigned)ints[j++];
  for (int k = 0; k < 4; ++k) p.shift[k] = (int)ints[j++];
  p.rc_sl = ints[j++];
  p.rc_sr = ints[j++];
  p.va_sl = ints[j++];
  p.va_sr = ints[j++];
  p.thr_sl = ints[j++];
  p.thr_sr = ints[j++];
  if (p.L == 0 || p.T == 0 || p.R == 0) return 0;
  bool bad = p.L < 0 || p.T < 0 || p.R < 0 || p.K < 1 || p.rb < 0 ||
             p.rb > 15 || p.map_shift < 0 || p.map_shift > 30;
  size_t smem = 0;
  bool wide = false;
  for (int k = 0; k < 4; ++k) {
    bad |= p.n_node[k] < 1 || p.sets[k] < 1 || p.ways[k] < 1;
    wide |= p.ways[k] > kWarp;
    smem += 2 * sizeof(int32_t) * (((size_t)p.sets[k] * p.ways[k] + 3) & ~3);
  }
  if (bad || smem > kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? fast_window_kernel<true> : fast_window_kernel<false>;
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<p.L * p.T, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
