// The allocator of one page-fault step, serially over the faulting threads.
//
// No Pallas original: replaces the `lax.scan` of the JAX package's
// src/repro/core/alloc.py::alloc_many (its `body`, alloc.py:201-245).
// Per lane l (a run of the simulator; the engine passes one), for threads
// t = 0..T-1 in order, with the carry (node_free[N], node_reclaimable[N],
// the interleave cursor, the OOM latch):
//   gate = !oom                                   (thread-entry OOM gate)
//   for each request r of root, top, mid, leaf (PT pages), data:
//     act = need[r] && gate
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
//
// Bound: launch latency.  A step moves about 1.5 KB (T = 32) and runs a
// serial chain of T x 5 small allocations, so the floor is one launch.
// Design: one thread per lane, integer work only.  The node count N is a
// template parameter (2 to 16, even), so the carry and each preference
// order are register arrays read and written at compile-time indices: a
// node id chosen at run time is read by a select over the N registers,
// never by indexing local memory, whose round trips would lengthen every
// link of the serial chain.  The request masks of up to 32 threads load as
// bitmasks ahead of the chain, so no global load waits inside it.  A
// thread that requests nothing leaves the carry as it is, so the
// full-depth scan equals the reference's scan compacted to the allocating
// threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 16;
constexpr int kLanesPerCta = 32;
// policy codes of core/config.py
constexpr int kInterleave = 1;
constexpr int kPtFollowData = 10;
constexpr int kPtBindAll = 11;
constexpr int kPtBindHigh = 12;

struct Pick {
  int node;            // -1 on failure
  bool ok, slow, from_reclaim;
};

// a[p] for a register array and a run-time p (0 when p is out of range)
template <int N>
__device__ __forceinline__ int get(const int (&a)[N], int p) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) v = i == p ? a[i] : v;
  return v;
}

// core/alloc.py::alloc_one: the first acceptable node in preference order
template <int N>
__device__ __forceinline__ Pick alloc_one(const int (&avail)[N],
                                          const int (&reserve)[N],
                                          const int (&prefs)[N],
                                          const int (&wm)[N], bool ignore_wm) {
  int fast = -1, slow = -1, reclaim = -1;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {       // backwards: the first one wins
    const int p = prefs[i];
    const int a = get(avail, p);
    if (p >= 0 && a > (ignore_wm ? 0 : get(wm, p))) fast = p;
    if (p >= 0 && a > 0) slow = p;
    if (p >= 0 && get(reserve, p) > 0) reclaim = p;
  }
  if (fast >= 0) return {fast, true, false, false};
  if (slow >= 0) return {slow, true, true, false};
  if (reclaim >= 0) return {reclaim, true, true, true};
  return {-1, false, false, false};
}

template <int N>
__global__ void alloc_scan_kernel(
    const int32_t* __restrict__ node_free, const int32_t* __restrict__ node_rec,
    const int32_t* __restrict__ ptr_in, const uint8_t* __restrict__ oom_in,
    const int32_t* __restrict__ wm_in, const int32_t* __restrict__ data_policy,
    const int32_t* __restrict__ pt_policy, const uint8_t* __restrict__ need_pt,
    const uint8_t* __restrict__ need_data, int lanes, int T, int half_threads,
    int alloc_mask, int thp, int32_t* __restrict__ nodes,
    uint8_t* __restrict__ slow_out, uint8_t* __restrict__ ok_out,
    uint8_t* __restrict__ act_out, uint8_t* __restrict__ gate_out,
    int32_t* __restrict__ free_out, int32_t* __restrict__ rec_out,
    int32_t* __restrict__ ptr_out, uint8_t* __restrict__ oom_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  // the carry: free and reclaimable pages per node
  int avail[N], reserve[N], wm[N], alloc[N];
  int n_alloc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    avail[i] = node_free[l * N + i];
    reserve[i] = node_rec[l * N + i];
    wm[i] = wm_in[i];
    alloc[i] = -1;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {             // the allocatable nodes, in order
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j == n_alloc && (alloc_mask >> i & 1)) alloc[j] = i;
    n_alloc += alloc_mask >> i & 1;
  }
  int ptr = ptr_in[l];
  bool oom = oom_in[l] != 0;
  const bool interleave = data_policy[l] == kInterleave;
  const int pt = pt_policy[l];
  const bool is_bhi = pt == kPtBindHigh;

  for (int t0 = 0; t0 < T; t0 += 32) {
    // the request masks of the next (up to) 32 threads, as bits
    const int span = T - t0 < 32 ? T - t0 : 32;
    uint32_t need[5] = {0, 0, 0, 0, 0};
    for (int k = 0; k < span; ++k) {
      const int row = l * T + t0 + k;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        need[r] |= (uint32_t)(need_pt[row * 4 + r] != 0) << k;
      need[4] |= (uint32_t)(need_data[row] != 0) << k;
    }
    for (int k = 0; k < span; ++k) {
      const int t = t0 + k;
      const int local = t < half_threads ? 0 : 1;
      int dram[N], first_touch[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {         // dram_prefs, first_touch_prefs
        dram[i] = i < 2 ? (i == 0 ? local : 1 - local) : -1;
        first_touch[i] = (i & ~1) + ((i & 1) ? 1 - local : local);
      }
      const bool gate = !oom;
      const int row = l * T + t;
      gate_out[row] = gate;
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        int dprefs[N];
        int start = ptr % n_alloc;
        if (start < 0) start += n_alloc;
#pragma unroll
        for (int i = 0; i < N; ++i) {       // interleave_prefs(ptr)
          int j = start + i;
          j = j >= n_alloc ? j - n_alloc : j;
          dprefs[i] = !interleave ? first_touch[i]
                                  : (i < n_alloc ? get(alloc, j) : -1);
        }
        const bool act = (need[r] >> k & 1) && gate;
        bool advance;
        Pick pick;
        if (r < 4) {
          const bool upper = r < 3 || thp;
          const bool bound = pt == kPtBindAll || (is_bhi && upper);
          int prefs[N];
#pragma unroll
          for (int i = 0; i < N; ++i) prefs[i] = bound ? dram[i] : dprefs[i];
          pick = alloc_one(avail, reserve, prefs, wm, bound);
          if (upper && is_bhi && !pick.ok)  // BHi falls back to the data order
            pick = alloc_one(avail, reserve, dprefs, wm, false);
          advance = interleave && pt == kPtFollowData;
        } else {
          pick = alloc_one(avail, reserve, dprefs, wm, false);
          advance = interleave;
        }
        if (act && pick.ok) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            reserve[i] -= (i == pick.node && pick.from_reclaim);
            avail[i] -= (i == pick.node && !pick.from_reclaim);
          }
          ptr += advance;
        }
        if (act && !pick.ok) oom = true;
        const int o = row * 5 + r;
        nodes[o] = pick.node;
        slow_out[o] = pick.slow;
        ok_out[o] = pick.ok;
        act_out[o] = act;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    free_out[l * N + i] = avail[i];
    rec_out[l * N + i] = reserve[i];
  }
  ptr_out[l] = ptr;
  oom_out[l] = oom;
}

template <int N>
cudaError_t launch(const void* node_free, const void* node_rec,
                   const void* ptr, const void* oom, const void* wm,
                   const void* data_policy, const void* pt_policy,
                   const void* need_pt, const void* need_data, int lanes,
                   int T, int half_threads, int alloc_mask, int thp,
                   void* nodes, void* slow, void* ok, void* act, void* gate,
                   void* free_out, void* rec_out, void* ptr_out,
                   void* oom_out, cudaStream_t stream) {
  const int ctas = (lanes + kLanesPerCta - 1) / kLanesPerCta;
  alloc_scan_kernel<N><<<ctas, kLanesPerCta, 0, stream>>>(
      (const int32_t*)node_free, (const int32_t*)node_rec,
      (const int32_t*)ptr, (const uint8_t*)oom, (const int32_t*)wm,
      (const int32_t*)data_policy, (const int32_t*)pt_policy,
      (const uint8_t*)need_pt, (const uint8_t*)need_data, lanes, T,
      half_threads, alloc_mask, thp, (int32_t*)nodes, (uint8_t*)slow,
      (uint8_t*)ok, (uint8_t*)act, (uint8_t*)gate, (int32_t*)free_out,
      (int32_t*)rec_out, (int32_t*)ptr_out, (uint8_t*)oom_out);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  Per lane:
// node_free / node_rec / free_out / rec_out are [lanes, n] (n even, 2 to
// 16), need_pt [lanes, T, 4], need_data / gate [lanes, T], nodes / slow /
// ok / act [lanes, T, 5]; wm is [n]; bools are one byte (0 or 1).  Thread
// t is on the second node of each pair when t >= half_threads;
// interleaving rotates over the nodes set in alloc_mask.
extern "C" int alloc_scan_launch(
    const void* node_free, const void* node_rec, const void* ptr,
    const void* oom, const void* wm, const void* data_policy,
    const void* pt_policy, const void* need_pt, const void* need_data,
    int lanes, int T, int n, int half_threads, int alloc_mask, int thp,
    void* nodes, void* slow, void* ok, void* act, void* gate, void* free_out,
    void* rec_out, void* ptr_out, void* oom_out, void* stream) {
  if (lanes == 0) return 0;
  if (alloc_mask == 0 || (alloc_mask >> n) != 0)
    return (int)cudaErrorInvalidValue;
#define ALLOC_SCAN_CASE(N)                                                   \
  case N:                                                                    \
    return (int)launch<N>(node_free, node_rec, ptr, oom, wm, data_policy,    \
                          pt_policy, need_pt, need_data, lanes, T,           \
                          half_threads, alloc_mask, thp, nodes, slow, ok,    \
                          act, gate, free_out, rec_out, ptr_out, oom_out,    \
                          (cudaStream_t)stream);
  switch (n) {
    ALLOC_SCAN_CASE(2)
    ALLOC_SCAN_CASE(4)
    ALLOC_SCAN_CASE(6)
    ALLOC_SCAN_CASE(8)
    ALLOC_SCAN_CASE(10)
    ALLOC_SCAN_CASE(12)
    ALLOC_SCAN_CASE(14)
    ALLOC_SCAN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ALLOC_SCAN_CASE
}
