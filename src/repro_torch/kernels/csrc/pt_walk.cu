// Two-level radix block-table walk, batched over table rows.
//
// Replaces the Pallas TPU kernel `pt_walk_kernel` / `_kernel` in
// src/repro/kernels/pt_walk.py.  For every row r and query q:
//   leaf = upper[r, floor(vb[q] / F)];  invalid (< 0) -> (-1, -1)
//   else (leaf_tier[leaf], leaf_entries[leaf, vb[q] mod F])
// Out-of-range reads follow JAX's gathers, as the TPU kernel and its
// oracle do: a negative upper index counts from the end, every index is
// then clamped into its table, and the entry index is never negative.
//
// Bound: launch latency.  On the decode path a call moves a few hundred
// bytes to a few KB (R rows of the upper table, N = max_blocks queries,
// the tier of each leaf page reached and one entry per walk that reaches
// one, two [R, N] outputs), far below what one launch costs.
// Design: grid (ceil(N / 256), R), one thread per (row, query), a tail
// mask instead of padding.  Each CTA stages its upper row in shared
// memory once (the BHi pinning of the TPU kernel, which kept the upper
// level whole in VMEM); leaf tier and leaf entries are plain gathers.
// Leaf entries are read through their strides (in elements), so the
// engine passes the slot column of its [n_leaf, F, 2] (tier, slot) table
// as a view, without a copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void pt_walk_kernel(const int32_t* __restrict__ upper, int max_leaf,
                               const int32_t* __restrict__ leaf_tier,
                               const int32_t* __restrict__ leaf_entries,
                               int n_leaf, int fanout, int64_t entry_stride,
                               int64_t entry_step,
                               const int32_t* __restrict__ vb, int n,
                               int32_t* __restrict__ tier,
                               int32_t* __restrict__ slot) {
  extern __shared__ int32_t row[];
  const int r = blockIdx.y;
  const int32_t* up = upper + (int64_t)r * max_leaf;
  for (int i = threadIdx.x; i < max_leaf; i += blockDim.x) row[i] = up[i];
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int32_t v = vb[q];
  int li = v / fanout;                    // C truncates: make it floor
  if (li * fanout > v) --li;
  const int e = v - li * fanout;          // v mod F, in [0, F)
  if (li < 0) li += max_leaf;
  li = min(max(li, 0), max_leaf - 1);
  int32_t leaf = row[li];
  int32_t t = -1, s = -1;
  if (leaf >= 0) {
    leaf = min(leaf, n_leaf - 1);
    t = leaf_tier[leaf];
    s = leaf_entries[(int64_t)leaf * entry_stride + (int64_t)e * entry_step];
  }
  const int64_t o = (int64_t)r * n + q;
  tier[o] = t;
  slot[o] = s;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  leaf_entries[l, j]
// lies at element l * entry_stride + j * entry_step.
extern "C" int pt_walk_launch(const void* upper, int rows, int max_leaf,
                              const void* leaf_tier, const void* leaf_entries,
                              int n_leaf, int fanout, long long entry_stride,
                              long long entry_step, const void* vb, int n,
                              void* tier, void* slot, void* stream) {
  if (rows == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  const size_t smem = (size_t)max_leaf * sizeof(int32_t);
  pt_walk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)upper, max_leaf, (const int32_t*)leaf_tier,
      (const int32_t*)leaf_entries, n_leaf, fanout, (int64_t)entry_stride,
      (int64_t)entry_step, (const int32_t*)vb, n, (int32_t*)tier,
      (int32_t*)slot);
  return (int)cudaGetLastError();
}
