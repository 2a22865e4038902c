// The allocator of one page-fault step: one warp per run, the step's
// allocations speculated in parallel and verified, the serial chain only
// where a threshold is crossed.
//
// No Pallas original: replaces the `lax.scan` of the JAX package's
// src/repro/core/alloc.py::alloc_many (its `body` and the compacted scan
// over the slot row, alloc.py:201-264).
// Per run l, for threads t = 0..T-1 in order, with the carry (node_free[N],
// node_reclaimable[N], the interleave cursor, the OOM latch):
//   gate = !oom                                   (thread-entry OOM gate)
//   for each request r of root, top, mid, leaf (PT pages), data:
//     act = need[r] && gate && t is in the slot row
//     the page is taken from the first node of the request's preference
//     order that is above its watermark (fast), else has a free page
//     (slow), else has a reclaimable page (slow, from the reserve), else
//     the request fails (node -1).  PT pages bound to DRAM (bind-all; BHi
//     for upper levels, and the leaf under THP) ignore the watermark, and
//     BHi falls back to the data order when DRAM has no page.
//     act && ok commits the page and may advance the interleave cursor;
//     act && !ok latches OOM for the threads after this one.
// Outputs per request: node, slow, ok (for every request, as the cost model
// reads it), act; per thread: gate; and the carry after the last thread.
// A thread outside the slot row requests nothing and reports node -1, slow
// and ok false, as the compacted scan of the reference does.
//
// Bound: launch latency.  A populate step (L = 1, T = 32, N = 4, a slot row
// of 32) moves 1,538 B (1,410 B without the slot row), so the floor is one
// launch.
//
// Design.  The carry chains through all T x 5 requests, but only three
// predicates per node decide every pick: free > watermark, free > 0 and
// reclaimable > 0.  A step only takes pages, so each predicate can only
// fall, and at most 3N fall over a whole run.  So a warp runs one run, lane
// k as thread t0 + k of a chunk of 32, node i's counts in lane i, and a
// chunk is one pass, or one more for each predicate that falls inside it:
//   1. speculate every request from the predicates at the pass's start
//      (node bitmasks, by ballot): a request finds a page or not whatever
//      the interleave rotation (every rotation lists every allocatable
//      node), so the OOM gates come first (the first failing thread, by
//      ballot), then the commits, then each request's cursor (an exclusive
//      warp prefix of advancing commits), and only then each pick, by bit
//      tricks on the predicate masks, branch-free;
//   2. verify: lane i holds how many decrements of each kind make one of
//      node i's predicates fall, and exclusive warp prefixes of each
//      lane's decrements per node find the first request at which such a
//      count is reached.  Up to and including it the speculation is the
//      serial result; with none, the whole rest of the chunk is;
//   3. keep those requests, their decrements (warp reductions) and cursor
//      advances, and speculate again from the next request.
// So the serial chain is only as long as the thresholds crossed.  The
// kernel counts the chunks that took more than one pass (replayed past a
// fall) on the device; the caller reads the count after a run.
// The carry passes from chunk to chunk in registers: node i's counts in
// lane i, the cursor and the latch in every lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRunsPerCta = 4;                 // one warp per run
constexpr unsigned kFull = 0xffffffffu;
// policy codes of core/config.py
constexpr int kInterleave = 1;
constexpr int kPtFollowData = 10;
constexpr int kPtBindAll = 11;
constexpr int kPtBindHigh = 12;

struct Pick {
  int node;            // -1 on failure
  bool ok, slow, from_reclaim;
};

// node bitmasks of the three predicates
struct Preds {
  unsigned above, free, reserve;   // free > wm, free > 0, reclaimable > 0
};

// what is fixed for a run
struct Run {
  unsigned all;           // every node
  unsigned alloc_mask;    // the allocatable nodes (the interleave list)
  bool interleave, bhi, bind_all, thp;
};

// lane i < N holds node i's counts; every lane gets the bitmasks
__device__ __forceinline__ Preds preds(int free_pages, int reserve, int wm,
                                       bool is_node) {
  return {__ballot_sync(kFull, is_node && free_pages > wm),
          __ballot_sync(kFull, is_node && free_pages > 0),
          __ballot_sync(kFull, is_node && reserve > 0)};
}

// The first node of x in a preference order, -1 if x is empty.  Both
// orders are computed and one selected, so a pick branches nowhere: a
// first-touch order (fastest tier first, the thread's own node
// of each pair first), or, under interleave (x then holds allocatable nodes
// only), the rotation that starts at allocatable node a_start (the nodes
// from a_start up, then the rest, ascending).
__device__ __forceinline__ int first_of(unsigned x, bool rotate, int local,
                                        int a_start) {
  const unsigned tiers = (x | (x >> 1)) & 0x55555555u;
  const int p = __ffs(tiers) - 1;              // node 2 x (first tier)
  const int touch = tiers == 0 ? -1
                    : (x >> (p + local) & 1) ? p + local : p + 1 - local;
  const unsigned hi = x & (kFull << a_start);
  const int rotated = __ffs(hi ? hi : x) - 1;
  return rotate ? rotated : touch;
}

// core/alloc.py::alloc_one over the nodes of one order passing each test
__device__ __forceinline__ Pick pick(unsigned fast, unsigned slow,
                                     unsigned reserve, bool rotate, int local,
                                     int a_start) {
  const int f = first_of(fast, rotate, local, a_start);
  const int s = first_of(slow, rotate, local, a_start);
  const int v = first_of(reserve, rotate, local, a_start);
  return f >= 0 ? Pick{f, true, false, false}
       : s >= 0 ? Pick{s, true, true, false}
       : v >= 0 ? Pick{v, true, true, true}
                : Pick{-1, false, false, false};
}

// request r (0-3 the PT levels, 4 the data page) of a thread on pair member
// `local`, the cursor's rotation starting at allocatable node a_start
__device__ __forceinline__ Pick request(const Run& c, Preds p, int r,
                                        int local, int a_start) {
  const unsigned set = c.interleave ? c.alloc_mask : c.all;
  const Pick data = pick(p.above & set, p.free & set, p.reserve & set,
                         c.interleave, local, a_start);
  // bound to the DRAM order (nodes 0 and 1), the watermark ignored
  const Pick dram = pick(p.free & 3u, p.free & 3u, p.reserve & 3u, false,
                         local, 0);
  const bool upper = r < 3 || c.thp;
  const bool bound = r < 4 && (c.bind_all || (c.bhi && upper));
  const bool fallback = !dram.ok && c.bhi && upper;    // BHi falls back
  return bound && !fallback ? dram : data;
}

// whether request r finds a page: the same tests as request(), which
// depend on neither the thread nor the interleave rotation
__device__ __forceinline__ bool request_ok(const Run& c, Preds p, int r) {
  const unsigned set = c.interleave ? c.alloc_mask : c.all;
  const bool data = ((p.above | p.free | p.reserve) & set) != 0;
  const bool dram = ((p.free | p.reserve) & 3u) != 0;
  const bool upper = r < 3 || c.thp;
  const bool bound = r < 4 && (c.bind_all || (c.bhi && upper));
  return bound ? dram || (c.bhi && upper && data) : data;
}

// the position of the j-th (from 0) set bit of a 5-bit mask
__device__ __forceinline__ int nth_bit(unsigned mask, int j) {
  int pos = 5;
#pragma unroll
  for (int r = 4; r >= 0; --r) {
    if (mask >> r & 1 && __popc(mask & ((1u << r) - 1)) == j) pos = r;
  }
  return pos;
}

__device__ __forceinline__ int rotation(int ptr, int n) {   // ptr mod n
  const int s = ptr % n;
  return s < 0 ? s + n : s;
}

__device__ __forceinline__ int wrap_add(int a, int b) {     // int32 wrap
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(kWarp * kRunsPerCta) alloc_scan_kernel(
    const int32_t* __restrict__ node_free, const int32_t* __restrict__ node_rec,
    const int32_t* __restrict__ ptr_in, const uint8_t* __restrict__ oom_in,
    const int32_t* __restrict__ wm_in, const int32_t* __restrict__ data_policy,
    const int32_t* __restrict__ pt_policy, const uint8_t* __restrict__ need_pt,
    const uint8_t* __restrict__ need_data,
    const int32_t* __restrict__ slot_thread, int lanes, int T, int N, int G,
    int half_threads, unsigned alloc_mask, int thp,
    int32_t* __restrict__ nodes, uint8_t* __restrict__ slow_out,
    uint8_t* __restrict__ ok_out, uint8_t* __restrict__ act_out,
    uint8_t* __restrict__ gate_out, int32_t* __restrict__ free_out,
    int32_t* __restrict__ rec_out, int32_t* __restrict__ ptr_out,
    uint8_t* __restrict__ oom_out, unsigned long long* __restrict__ replays) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int l = blockIdx.x * kRunsPerCta + (threadIdx.x / kWarp);
  if (l >= lanes) return;                      // the whole warp
  const unsigned below = (1u << lane) - 1;
  const bool is_node = lane < N;
  int free_pages = is_node ? node_free[l * N + lane] : 0;
  int reserve = is_node ? node_rec[l * N + lane] : 0;
  const int wm = is_node ? wm_in[lane] : 0;
  // lane j < n_alloc holds the j-th allocatable node (the position of the
  // j-th set bit of alloc_mask, by halves)
  const int n_alloc = __popc(alloc_mask);
  int alloc_node = 0;
  {
    unsigned m = alloc_mask;
    int k = lane;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const int below_half = __popc(m & ((1u << w) - 1));
      const bool up = k >= below_half;
      k -= up ? below_half : 0;
      m = up ? m >> w : m;
      alloc_node += up ? w : 0;
    }
  }
  int ptr = ptr_in[l];
  bool oom = oom_in[l] != 0;
  const int pt = pt_policy[l];
  const Run c = {(1u << N) - 1, alloc_mask, data_policy[l] == kInterleave,
                 pt == kPtBindHigh, pt == kPtBindAll, thp != 0};
  // requests that advance the cursor when committed: the data page under
  // interleave, the PT pages too when they follow the data policy
  const unsigned advancing =
      c.interleave ? (pt == kPtFollowData ? 0x1fu : 0x10u) : 0u;

  for (int t0 = 0; t0 < T; t0 += kWarp) {
    const int t = t0 + lane;
    const size_t row = (size_t)l * T + t;
    unsigned need = 0;                         // bit r: request r
    if (t < T) {
#pragma unroll
      for (int r = 0; r < 4; ++r) need |= (unsigned)(need_pt[row * 4 + r] != 0) << r;
      need |= (unsigned)(need_data[row] != 0) << 4;
    }
    // the chunk's threads in the slot row (every thread without one)
    unsigned in_row = kFull;
    if (slot_thread != nullptr) {
      unsigned bits = 0;
      for (int j = lane; j - lane < G; j += kWarp) {
        const int s = j < G ? slot_thread[(size_t)l * G + j] : -1;
        if (s >= t0 && s - t0 < kWarp && s < T) bits |= 1u << (s - t0);
      }
      in_row = __reduce_or_sync(kFull, bits);
    }
    if (!(in_row >> lane & 1)) need = 0;
    const int local = t >= half_threads;

    // The chunk's passes.  A pass speculates every request from (k0, r0)
    // on (request r0 of thread t0 + k0; the requests before it are done)
    // from the predicates at that point, finds the first request after
    // which a predicate falls, and keeps the requests up to it.  The next
    // pass starts after it; a chunk in which no predicate falls is one pass.
    int node[5] = {-1, -1, -1, -1, -1};        // this lane's thread's outputs
    unsigned slow = 0, ok = 0, act = 0;
    bool gate = false;
    const int span = T - t0 < kWarp ? T - t0 : kWarp;
    int k0 = 0, r0 = 0, passes = 0;
    bool g0 = !oom;                            // thread t0 + k0's entry gate
    while (k0 < span) {
      ++passes;
      const unsigned region = lane > k0 ? 0x1fu
                              : lane == k0 ? (0x1fu << r0) & 0x1fu : 0u;
      const unsigned live = need & region;
      // ---- speculate: which requests find a page, then the gates, the
      // commits, each request's cursor, and only then the picks
      const Preds p = preds(free_pages, reserve, wm, is_node);
      unsigned okb = 0;
#pragma unroll
      for (int r = 0; r < 5; ++r) okb |= (unsigned)request_ok(c, p, r) << r;
      // thread t0 + k0 keeps its entry gate; a later one is gated by the
      // latch or by a failure of a thread between
      const unsigned fails =
          __ballot_sync(kFull, (live & ~okb) != 0 && (lane != k0 || g0));
      const int first_fail = fails ? __ffs(fails) - 1 : kWarp;
      const bool g = lane == k0 ? g0 : !oom && lane <= first_fail;
      const unsigned acts = g ? live : 0u;
      const unsigned commit = acts & okb;
      // the cursor at this thread: an exclusive warp prefix of the
      // advancing commits (0 to 5 a thread, so three ballots of their bits)
      const int n_adv = __popc(commit & advancing);
      int before = 0, total = 0;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const unsigned v = __ballot_sync(kFull, n_adv >> b & 1);
        before += __popc(v & below) << b;
        total += __popc(v) << b;
      }
      int picked[5];
      unsigned slows = 0, from_reserve = 0, used = 0;
      int cursor = wrap_add(ptr, before);
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int a_start =
            __shfl_sync(kFull, alloc_node, rotation(cursor, n_alloc));
        const Pick q = request(c, p, r, local, a_start);
        picked[r] = q.node;
        slows |= (unsigned)q.slow << r;
        from_reserve |= (unsigned)q.from_reclaim << r;
        if (commit >> r & 1) {
          used |= 1u << q.node;
          cursor = wrap_add(cursor, advancing >> r & 1);
        }
      }
      // ---- verify: lane n < N holds how many decrements of each kind make
      // one of node n's predicates fall (clamped: a pass takes at most 160)
      constexpr long long kNever = 1 << 20;
      const long long above_by = (long long)free_pages - wm;
      const int fall_free = (int)min(free_pages > wm ? above_by : kNever,
                                     free_pages > 0 ? (long long)free_pages : kNever);
      const int fall_reserve = reserve > 0 ? reserve : (int)kNever;
      // the first request at which that count is reached: per node taken
      // from, exclusive warp prefixes of this lane's commits of each kind
      int fall_at = 5;                         // this lane's; 5 = none
      int dec = 0;           // node lane: the pass's free (low) and reserve
                             // (high half) decrements
      for (unsigned m = __reduce_or_sync(kFull, used); m; m &= m - 1) {
        const int n = __ffs(m) - 1;
        unsigned of_free = 0, of_reserve = 0;  // bit r: request r took from n
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          const bool here = (commit >> r & 1) && picked[r] == n;
          of_free |= (unsigned)(here && !(from_reserve >> r & 1)) << r;
          of_reserve |= (unsigned)(here && (from_reserve >> r & 1)) << r;
        }
        const int counts = __popc(of_free) | __popc(of_reserve) << 3;
        int before_f = 0, before_r = 0, total_f = 0, total_r = 0;
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          const unsigned v = __ballot_sync(kFull, counts >> b & 1);
          const int lo = __popc(v & below), all = __popc(v);
          if (b < 3) { before_f += lo << b; total_f += all << b; }
          else { before_r += lo << (b - 3); total_r += all << (b - 3); }
        }
        const int df = __shfl_sync(kFull, fall_free, n);
        const int dr = __shfl_sync(kFull, fall_reserve, n);
        if (before_f < df && df <= before_f + __popc(of_free))
          fall_at = min(fall_at, nth_bit(of_free, df - before_f - 1));
        if (before_r < dr && dr <= before_r + __popc(of_reserve))
          fall_at = min(fall_at, nth_bit(of_reserve, dr - before_r - 1));
        if (lane == n) dec = total_f | total_r << 16;
      }
      const unsigned falls = __ballot_sync(kFull, fall_at < 5);
      unsigned kept = region;
      int next_k = span, next_r = 0;
      if (falls) {
        // keep the requests up to the first fall; their decrements only
        const int kf = __ffs(falls) - 1;
        const int rf = __shfl_sync(kFull, fall_at, kf);
        kept = lane < kf ? region : lane == kf ? region & ((2u << rf) - 1) : 0u;
        next_k = rf < 4 ? kf : kf + 1;
        next_r = rf < 4 ? rf + 1 : 0;
        dec = 0;
        const unsigned taken = commit & kept;
        unsigned used_kept = 0;
#pragma unroll
        for (int r = 0; r < 5; ++r)
          if (taken >> r & 1) used_kept |= 1u << picked[r];
        for (unsigned m = __reduce_or_sync(kFull, used_kept); m; m &= m - 1) {
          const int n = __ffs(m) - 1;
          int here = 0;
#pragma unroll
          for (int r = 0; r < 5; ++r)
            if ((taken >> r & 1) && picked[r] == n)
              here += (from_reserve >> r & 1) ? 1 << 16 : 1;
          const int sum = __reduce_add_sync(kFull, here);
          if (lane == n) dec = sum;
        }
        total = __reduce_add_sync(kFull, __popc(taken & advancing));
      }
      // ---- keep: the carry, the latch and this lane's outputs
      free_pages -= dec & 0xffff;
      reserve -= dec >> 16;
      ptr = wrap_add(ptr, total);
      oom = oom || __any_sync(kFull, (acts & ~okb & kept) != 0);
#pragma unroll
      for (int r = 0; r < 5; ++r)
        if (kept >> r & 1) node[r] = picked[r];
      slow = (slow & ~kept) | (slows & kept);
      ok = (ok & ~kept) | (okb & kept);
      act = (act & ~kept) | (acts & kept);
      if (kept & 1) gate = g;
      const bool g_next = __shfl_sync(kFull, g, next_k & (kWarp - 1));
      g0 = next_r > 0 ? g_next : !oom;
      k0 = next_k;
      r0 = next_r;
    }
    if (passes > 1 && lane == 0) atomicAdd(replays, 1ull);

    // ---- outputs of this lane's thread ----------------------------------
    if (t < T) {
      const bool keep = in_row >> lane & 1;
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        nodes[row * 5 + r] = keep ? node[r] : -1;
        slow_out[row * 5 + r] = keep && (slow >> r & 1);
        ok_out[row * 5 + r] = keep && (ok >> r & 1);
        act_out[row * 5 + r] = act >> r & 1;
      }
      gate_out[row] = gate;
    }
  }
  if (is_node) {
    free_out[l * N + lane] = free_pages;
    rec_out[l * N + lane] = reserve;
  }
  if (lane == 0) {
    ptr_out[l] = ptr;
    oom_out[l] = oom;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  Per run:
// node_free / node_rec / free_out / rec_out are [lanes, n] (n even, 2 to
// 16), need_pt [lanes, T, 4], need_data / gate [lanes, T], nodes / slow /
// ok / act [lanes, T, 5]; wm is [n]; slot_thread is [lanes, G] or null
// (every thread in the row; an entry outside [0, T) is a pad); bools are
// one byte (0 or 1).  Thread t is on the second node of each pair when
// t >= half_threads; interleaving rotates over the nodes set in
// alloc_mask.  replays (one counter) gains the chunks that were replayed.
extern "C" int alloc_scan_launch(
    const void* node_free, const void* node_rec, const void* ptr,
    const void* oom, const void* wm, const void* data_policy,
    const void* pt_policy, const void* need_pt, const void* need_data,
    const void* slot_thread, int lanes, int T, int n, int G,
    int half_threads, int alloc_mask, int thp, void* nodes, void* slow,
    void* ok, void* act, void* gate, void* free_out, void* rec_out,
    void* ptr_out, void* oom_out, void* replays, void* stream) {
  if (lanes == 0) return 0;
  if (n < 2 || n > 16 || n % 2 || T < 0 || G < 0 || alloc_mask == 0 ||
      (alloc_mask >> n) != 0)
    return (int)cudaErrorInvalidValue;
  const int per_cta = lanes < kRunsPerCta ? lanes : kRunsPerCta;
  const int ctas = (lanes + kRunsPerCta - 1) / kRunsPerCta;
  alloc_scan_kernel<<<ctas, per_cta * kWarp, 0, (cudaStream_t)stream>>>(
      (const int32_t*)node_free, (const int32_t*)node_rec,
      (const int32_t*)ptr, (const uint8_t*)oom, (const int32_t*)wm,
      (const int32_t*)data_policy, (const int32_t*)pt_policy,
      (const uint8_t*)need_pt, (const uint8_t*)need_data,
      (const int32_t*)slot_thread, lanes, T, n, G, half_threads,
      (unsigned)alloc_mask, thp, (int32_t*)nodes, (uint8_t*)slow,
      (uint8_t*)ok, (uint8_t*)act, (uint8_t*)gate, (int32_t*)free_out,
      (int32_t*)rec_out, (int32_t*)ptr_out, (uint8_t*)oom_out,
      (unsigned long long*)replays);
  return (int)cudaGetLastError();
}
