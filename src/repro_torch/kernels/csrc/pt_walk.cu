// Two-level radix block-table walk, batched over table rows, with an
// optional gather of the rows and an optional per-row reduction.
//
// Replaces the Pallas TPU kernel `pt_walk_kernel` / `_kernel` in
// src/repro/kernels/pt_walk.py.  For every row r and query q:
//   row = rows ? rows[r] : r
//   leaf = upper[row, floor(vb[q] / F)];  invalid (< 0) -> (-1, -1)
//   else (leaf_tier[leaf], leaf_entries[leaf, vb[q] mod F])
// and, when a flag output is given, flags[r] = any_q(tier[r, q] == flag_tier).
// Out-of-range reads follow JAX's gathers, as the TPU kernel and its
// oracle do: a negative index (a row id, an upper index) counts from the
// end once, every index is then clamped into its table, and the entry
// index is never negative.
//
// Bound: launch latency.  On the decode path a call moves a few hundred
// bytes to a few KB (R rows of the upper table, N = max_blocks queries,
// the tier of each leaf page reached, and one entry per walk that reaches
// one when the entries are asked for), far below what one launch costs.
// Design: one warp per row, lanes on consecutive queries; the decode
// tick's whole walk (R rows, N <= 32 * iterations) is one CTA.  Nothing
// is staged in shared memory and there is no barrier: each thread loads
// vb[q] and its row id together, then the upper entry it needs, then the
// leaf page's tier and its entry together.  So a walk is three dependent
// round trips (queries, upper entry, leaf page); the row ids, when the
// rows are gathered, load beside the queries.
// With flags the warp covers all N queries of its row and reduces them
// with __any_sync, so no output needs zeroing and no second launch is
// made; the tick's gather of its rows, the walk and the reduction are one
// launch.  Leaf entries are read through their strides (in elements), so
// the engine passes the slot column of its [n_leaf, F, 2] (tier, slot)
// table as a view, without a copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;   // rows per CTA
constexpr int kSpan = 256;        // queries per CTA along x without flags

__global__ void pt_walk_kernel(const int32_t* __restrict__ upper,
                               int n_rows, int max_leaf,
                               const int32_t* __restrict__ rows, int r_count,
                               const int32_t* __restrict__ leaf_tier,
                               const int32_t* __restrict__ leaf_entries,
                               int n_leaf, int fanout, int64_t entry_stride,
                               int64_t entry_step,
                               const int32_t* __restrict__ vb, int n, int span,
                               int32_t* __restrict__ tier,
                               int32_t* __restrict__ slot,
                               int32_t* __restrict__ flags, int flag_tier) {
  const int lane = threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= r_count) return;                       // whole warps only
  const int q0 = blockIdx.x * span;
  const int q1 = min(n, q0 + span);
  // the first query is on its way before the row id is used
  int32_t v = q0 + lane < q1 ? __ldg(vb + q0 + lane) : 0;
  int64_t row = rows ? __ldg(rows + r) : r;
  if (row < 0) row += n_rows;
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  const int32_t* up = upper + row * max_leaf;
  bool hit = false;
  for (int base = q0; base < q1; base += 32) {    // warp-uniform trips
    const int q = base + lane;
    const bool live = q < q1;
    const int32_t next = q + 32 < q1 ? __ldg(vb + q + 32) : 0;
    int li = v / fanout;                    // C truncates: make it floor
    if (li * fanout > v) --li;
    const int e = v - li * fanout;          // v mod F, in [0, F)
    if (li < 0) li += max_leaf;
    li = min(max(li, 0), max_leaf - 1);
    int32_t leaf = live ? __ldg(up + li) : -1;
    int32_t t = -1, s = -1;
    if (live && leaf >= 0) {
      leaf = min(leaf, n_leaf - 1);
      t = __ldg(leaf_tier + leaf);
      if (slot)
        s = __ldg(leaf_entries + (int64_t)leaf * entry_stride
                  + (int64_t)e * entry_step);
    }
    if (live) {
      const int64_t o = (int64_t)r * n + q;
      if (tier) tier[o] = t;
      if (slot) slot[o] = s;
      hit |= t == flag_tier;
    }
    v = next;
  }
  if (flags) {
    const unsigned any = __any_sync(0xffffffffu, hit);
    if (lane == 0) flags[r] = any ? 1 : 0;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  upper is
// [n_rows, max_leaf]; rows (i32[r_count]) may be null, and then row r is
// walked for r < r_count.  leaf_entries[l, j] lies at element
// l * entry_stride + j * entry_step.  tier / slot ([r_count, n]) and flags
// ([r_count]) may each be null; with flags every row's queries run in one
// warp.
extern "C" int pt_walk_launch(const void* upper, int n_rows, int max_leaf,
                              const void* rows, int r_count,
                              const void* leaf_tier, const void* leaf_entries,
                              int n_leaf, int fanout, long long entry_stride,
                              long long entry_step, const void* vb, int n,
                              void* tier, void* slot, void* flags,
                              int flag_tier, void* stream) {
  if (r_count == 0 || n == 0) return 0;
  const int warps = r_count < kWarpsPerCta ? r_count : kWarpsPerCta;
  const int span = flags ? n : kSpan;
  const dim3 grid((n + span - 1) / span, (r_count + warps - 1) / warps);
  pt_walk_kernel<<<grid, dim3(32, warps), 0, (cudaStream_t)stream>>>(
      (const int32_t*)upper, n_rows, max_leaf, (const int32_t*)rows, r_count,
      (const int32_t*)leaf_tier, (const int32_t*)leaf_entries, n_leaf, fanout,
      (int64_t)entry_stride, (int64_t)entry_step, (const int32_t*)vb, n, span,
      (int32_t*)tier, (int32_t*)slot, (int32_t*)flags, flag_tier);
  return (int)cudaGetLastError();
}

// An empty kernel in the walk's launch shape at the decode tick (one CTA
// of four warps): chip_smoke.py times it as the floor of one launch.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, dim3(32, 4), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
